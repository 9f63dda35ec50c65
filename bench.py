"""1D κ-inversion benchmark: ``fit_kappa``'s two 1D routes on the GPU.

Workload: the ``cli invert --dim 1`` problem (random per-element κ_true,
one shared forcing, exact observations) at two shapes — 30 elements ×
B = 2,097,152 scenarios (the headline), and 128 elements × B = 1024
(BASELINE.json config 2).  Each shape runs ``fit_kappa``'s 1D loop end
to end (packing, the SGD loop, the converged eval solve) for
``STEPS`` SGD steps on both routes:

* ``cf_chain_triton`` — the Pallas-Triton chain kernel, 32 steps per
  launch (ops/pallas/fused_grad_cf_kernel.py); the route ``fit_kappa``
  takes on a GPU;
* ``cf_xla`` — the same closed form as one XLA step per scan iteration.

Each route is compiled first, then timed in the order chain, xla, xla,
chain with ``block_until_ready`` on the results.  Both routes must agree
on the final κ.  Prints the card on earlier lines and ONE JSON line
last; refuses to run without a GPU.

    python bench.py
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from chip_smoke import card_line

BASELINE_GRAD_SOLVES_PER_S = 95.0  # reference: 1D fwd+bwd κ-grad, 30 elem
SHAPES = ((30, 2_097_152), (128, 1024))
STEPS = 256
ROUTES = ("cf_chain_triton", "cf_xla")


def time_routes(n_elements: int, batch: int, steps: int = STEPS):
    """End-to-end seconds of each 1D route (two runs each, interleaved)
    and the largest relative κ difference between the routes."""
    from difffe_tpu.cli import invert_workload
    from difffe_tpu.inverse import _fit_kappa_1d

    mesh, fB, u_data, _ = invert_workload(1, n_elements, batch)
    jax.block_until_ready(u_data)

    def run(route):
        t0 = time.perf_counter()
        kappa, info = _fit_kappa_1d(mesh, fB, u_data, steps, None, None,
                                    True, route=route)
        jax.block_until_ready((kappa, info["loss_history"]))
        return time.perf_counter() - t0, kappa, info

    out = {r: run(r) for r in ROUTES}           # compile + first run
    times = {r: [] for r in ROUTES}
    for r in ROUTES + ROUTES[::-1]:
        times[r].append(run(r)[0])
    kc, kx = out["cf_chain_triton"][1], out["cf_xla"][1]
    rel = float(jnp.max(jnp.abs(kc - kx)) / jnp.max(jnp.abs(kx)))
    hist = {r: (float(out[r][2]["loss_history"][0]),
                float(out[r][2]["loss_history"][-1])) for r in ROUTES}
    return times, rel, hist


def main() -> int:
    from difffe_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    print(f"device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}; card: {card_line()}")
    rates = {}
    for ne, B in SHAPES:
        times, rel, hist = time_routes(ne, B)
        best = {r: min(t) for r, t in times.items()}
        rates[(ne, B)] = {r: B * STEPS / best[r] for r in ROUTES}
        print(json.dumps({
            "n_elements": ne, "batch": B, "steps": STEPS,
            "seconds": times, "kappa_route_rel_diff": rel,
            "loss_first_last": hist,
            "grad_solves_per_s": rates[(ne, B)]}))
        if not rel < 1e-4:
            print(f"routes disagree: rel {rel:.3e}", file=sys.stderr)
            return 1
    head = rates[SHAPES[0]]["cf_chain_triton"]
    print(json.dumps({
        "metric": "1D fit_kappa grad-solves/s (fwd+adjoint, 30 elements, "
                  "per-element kappa, B=2097152, chain kernel route, "
                  f"{STEPS} SGD steps end to end)",
        "value": head, "unit": "solves/s",
        "vs_baseline": head / BASELINE_GRAD_SOLVES_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
