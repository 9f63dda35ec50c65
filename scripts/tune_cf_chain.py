"""Launch-shape sweep and route crossover for the 1D chain kernel.

Two measurements on a GPU, one JSON line per case on standard output:

* ``--sweep``: the SGD loop alone (no packing, no eval solve), 256
  steps, for a grid of (rows per block, warps) of the Pallas-Triton
  chain kernel, beside the XLA closed-form loop at the same shape — the
  data behind ``fused_grad_cf_kernel._launch_config``;
* ``--routes``: ``fit_kappa``'s two 1D routes end to end
  (``bench.time_routes``) on long chains — the data behind
  ``inverse.CHAIN_MAX_ELEMENTS``.

A case whose kernel does not compile prints its error and the sweep goes
on.  The card's name and power limit come first: compare numbers only
within one run.

    python scripts/tune_cf_chain.py --sweep --routes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

STEPS = 256
#: (n_elements, B) → (rows, warps) grid of the loop-only sweep
SWEEP = {
    (30, 2_097_152): [(r, w) for r in (16, 32, 64, 128) for w in (2, 4, 8)],
    (128, 1024): [(r, w) for r in (1, 2, 4, 8, 16, 32) for w in (1, 2, 4, 8)],
    (4096, 1024): [(1, w) for w in (4, 8, 16, 32)],
    (16384, 1024): [(1, w) for w in (4, 8, 16, 32)],
}
ROUTE_SHAPES = [(ne, B) for ne in (1024, 2048, 4096, 8192, 16384)
                for B in (1, 1024)]


def _best(fn, *args, reps: int = 3) -> float:
    jax.block_until_ready(fn(*args))                  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times)


def sweep(ne: int, B: int, grid) -> None:
    from difffe_tpu.cli import invert_workload
    from difffe_tpu.inverse import _build_loop_1d_chain, _build_loop_1d_xla
    from difffe_tpu.ops.assembly import assemble_load
    from difffe_tpu.ops.cf1d import _element_widths
    from difffe_tpu.ops.pallas.fused_grad_cf_kernel import cf_packed_operands

    mesh, fB, u_data, _ = invert_workload(1, ne, B)
    F = assemble_load(mesh, fB[0])
    ke = jnp.ones((B, ne), jnp.float32)
    lr, scale = 30.0, 2.0 / mesh.n_nodes
    keP, ops = cf_packed_operands(mesh, ke, F, u_data)
    hs = jnp.asarray(_element_widths(mesh), jnp.float32)
    xla = _build_loop_1d_xla(STEPS, lr, scale, 0.0, 0.0)
    base = {"n_elements": ne, "batch": B, "steps": STEPS}
    print(json.dumps({**base, "route": "cf_xla", "loop_s":
                      _best(xla, ke, hs, F, u_data)}), flush=True)
    chain = _build_loop_1d_chain(STEPS // 32, 32, 0, lr, scale, False)
    for rows, warps in grid:
        if keP.shape[0] % rows:
            continue
        case = {**base, "route": "cf_chain_triton", "rows": rows,
                "warps": warps,
                "default": (rows, warps) == (ops.rows, ops.num_warps)}
        try:
            t = _best(chain, keP, dataclasses.replace(
                ops, rows=rows, num_warps=warps))
            print(json.dumps({**case, "loop_s": t}), flush=True)
        except Exception as e:                       # noqa: BLE001
            print(json.dumps({**case, "error": repr(e)[:300]}), flush=True)


def routes(ne: int, B: int) -> None:
    from bench import time_routes

    case = {"n_elements": ne, "batch": B, "steps": STEPS}
    try:
        times, rel, _ = time_routes(ne, B, STEPS)
        print(json.dumps({**case, "seconds": times,
                          "kappa_route_rel_diff": rel}), flush=True)
    except Exception as e:                           # noqa: BLE001
        print(json.dumps({**case, "error": repr(e)[:300]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--routes", action="store_true")
    args = ap.parse_args()
    from chip_smoke import card_line
    from difffe_tpu.utils.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"tune_cf_chain.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    configure_compile_cache()
    print(f"device: {dev.device_kind}; card: {card_line()}", flush=True)
    if args.sweep:
        for (ne, B), grid in SWEEP.items():
            sweep(ne, B, grid)
    if args.routes:
        for ne, B in ROUTE_SHAPES:
            routes(ne, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
