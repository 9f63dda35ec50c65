"""Probe: a SHARP control for the 3D iteration-lever claim.

An earlier warm-start probe measured cold-16 ≡ cold-100 at 4-digit
eval-loss parity, but that workload is heavily underdetermined (one
forcing per scenario, per-tet κ: max-κ error sits at its insensitive-tet
floor), so the parity bar was weak.  This probe builds an IDENTIFIABLE inversion:

* M=4 independent forcings per scenario (distinct sine modes) share ONE
  κ field — the multi-experiment setting where the field is determined;
* κ is parameterized as exp(trilinear upsample of a coarse parameter
  grid) — smooth and low-dimensional (identifiable from M forcings),
  matching how production inversions regularize.

The iteration ladder (100-iter reference vs 32/16/8 fixed trips) is then
gated on the PARAMETER-κ relative error — the quantity the weak gate
could not see — plus the converged eval loss.

Run:  python scripts/probe_3d_control.py [n] [B] [steps] [lr] [nc]
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from difffe_tpu.ops.stencil3d import (
        StructuredGrid3, kappa_mse_grad_step_3d,
        solve_poisson_structured_3d_batched)

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 150
    lr = float(sys.argv[4]) if len(sys.argv) > 4 else 30.0
    nc = int(sys.argv[5]) if len(sys.argv) > 5 else 4   # param grid
    M = 4
    grid = StructuredGrid3.unit(n, n, n)
    ne = grid.n_elements
    print(f"box({n}^3) B={B} M={M} forcings nc={nc}^3 params "
          f"steps={steps} lr={lr}", flush=True)

    zs = jnp.linspace(0, 1, n + 1, dtype=jnp.float32)
    zz, yy, xx = jnp.meshgrid(zs, zs, zs, indexing="ij")
    pi = jnp.pi
    modes = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2)]
    fs = jnp.stack([
        ((a ** 2 + b ** 2 + c ** 2) * pi ** 2
         * jnp.sin(a * pi * xx) * jnp.sin(b * pi * yy)
         * jnp.sin(c * pi * zz)).astype(jnp.float32)
        for a, b, c in modes])                       # (M,) + node_shape
    fBM = jnp.tile(fs, (B, 1, 1, 1))                 # (B*M,) + node_shape
    g0 = jnp.zeros(grid.node_shape, jnp.float32)

    def upsample(theta):
        """(B, nc, nc, nc) params → (B, n, n, n) per-cube log-κ, trilinear."""
        zoom = n // nc
        t = jnp.repeat(jnp.repeat(jnp.repeat(theta, zoom, -1), zoom, -2),
                       zoom, -3)
        return t

    def kappa_of(theta):
        """θ → per-tet κ (B*M, ne): exp(upsample), 6 tets share a cube,
        every forcing replica shares the scenario's field."""
        kc = jnp.exp(upsample(theta))                # (B, n, n, n)
        kt = jnp.repeat(kc[..., None], 6, axis=-1).reshape(
            theta.shape[0], ne)
        return jnp.repeat(kt, M, axis=0)             # (B*M, ne)

    key = jax.random.PRNGKey(5)
    theta_true = 0.5 * jax.random.normal(key, (B, nc, nc, nc), jnp.float32)
    k_true_bm = kappa_of(theta_true)
    u_data = jax.jit(lambda kt: solve_poisson_structured_3d_batched(
        grid, kt, fBM, g0, 0.0, 300))(k_true_bm)
    jax.block_until_ready(u_data)

    @jax.jit
    def eval_loss(theta):
        u = solve_poisson_structured_3d_batched(
            grid, kappa_of(theta), fBM, g0, 0.0, 300)
        return jnp.mean((u - u_data) ** 2)

    kc_true = np.asarray(jnp.exp(upsample(theta_true)))

    import optax
    opt = optax.adam(lr)

    def run(iters, warm=False, mg=False):
        from difffe_tpu.ops.multigrid3 import kappa_mse_grad_step_3d_mg
        step_fn = kappa_mse_grad_step_3d_mg if mg \
            else kappa_mse_grad_step_3d
        theta0 = jnp.zeros((B, nc, nc, nc), jnp.float32)

        def body(carry, _):
            theta, st, ws = carry
            k, vjp = jax.vjp(kappa_of, theta)
            loss, gk, ws = step_fn(
                grid, k, fBM, g0, u_data, iters,
                warm_state=ws if warm else None, return_state=True)
            (gt,) = vjp(gk)
            upd, st = opt.update(gt, st)
            return (optax.apply_updates(theta, upd), st, ws), loss

        # run the scan in chunks of ≤100 steps, so each device execution
        # stays short and progress is visible between chunks
        chunk = min(steps, 100)
        n_chunks = (steps + chunk - 1) // chunk

        @jax.jit
        def init(theta):
            k0 = kappa_of(theta)
            _, _, ws0 = step_fn(grid, k0, fBM, g0, u_data, iters,
                                return_state=True)
            return (theta, opt.init(theta), ws0)

        @jax.jit
        def loop(carry):
            carry, losses = jax.lax.scan(body, carry, None, length=chunk)
            return carry, losses

        def run_all(theta):
            carry = init(theta)
            losses = None
            for _ in range(n_chunks):
                carry, losses = loop(carry)
                jax.block_until_ready(losses)
            return carry[0], losses

        theta, losses = run_all(theta0)
        t0 = time.perf_counter()
        theta, losses = run_all(theta0)
        jax.block_until_ready(losses)
        dt = (time.perf_counter() - t0) / (chunk * n_chunks)
        tru = float(eval_loss(theta))
        kc = np.asarray(jnp.exp(upsample(theta)))
        kerr = float(np.max(np.abs(kc - kc_true)) / np.max(kc_true))
        print(f"  iters={iters:4d} warm={int(warm)}  "
              f"{B*M/dt:10,.0f} grad-solves/s  "
              f"loop_loss={float(losses[-1]):.4e}  eval_loss={tru:.4e}  "
              f"kappa_rel_err={kerr:.3e}", flush=True)

    ladder = [(100, False, False), (32, False, False), (16, False, False),
              (16, True, False), (8, True, False)]
    if len(sys.argv) > 6:        # e.g. "100:0,32:0,16:1,mg2:0"
        def parse(pair):
            a, b = pair.split(":")
            mg = a.startswith("mg")
            return (int(a[2:] if mg else a), bool(int(b)), mg)
        ladder = [parse(p) for p in sys.argv[6].split(",")]
    for iters, warm, mg in ladder:
        run(iters, warm, mg)


if __name__ == "__main__":
    main()
