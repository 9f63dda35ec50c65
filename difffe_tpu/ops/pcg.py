"""The one preconditioned-CG body every XLA solve path shares.

Replaces five hand-rolled copies of the same loop (ops/cg.py, ops/stencil.py,
ops/multigrid.py, parallel/halo.py) so the converged-safe-division fix — a
regression-tested NaN class (tests/test_review_regressions.py) — lives in
exactly one place.

Parameterized over:

* ``A``     — the SPD operator, ``v ↦ A·v`` (matrix-free);
* ``Minv``  — preconditioner apply, ``r ↦ z`` (Jacobi multiply, MG V-cycle,
  anything symmetric positive);
* ``dot``   — inner product.  The default is a global ``vdot`` (couples a
  scenario batch into one block-diagonal CG, the historical behavior of the
  structured path); pass :func:`batched_dot` for independent per-scenario
  α/β, which the batched fixed-trip solves and grad steps use.

Why CG at all, and why this shape: under ``jit`` the loop is a single
``lax.while_loop`` with static shapes — no data-dependent Python control
flow — and with ``tol=0`` it degenerates to a fixed trip count, the
mode for scenario batches where per-scenario early exit would
serialize the batch.  The reference has no iterative solver at all (dense
LU via torch.linalg.solve, /root/reference/diffhe/solver.py:174).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp


def batched_dot(ndim: int = 2):
    """Per-scenario inner product over the trailing ``ndim`` axes, keepdims —
    so α/β broadcast back against (..., H, W)-shaped CG state."""
    axes = tuple(range(-ndim, 0))

    def dot(u, v):
        return jnp.sum(u * v, axis=axes, keepdims=True)

    return dot


def _global_dot(u, v):
    return jnp.vdot(u, v)


def _safe_div(num, den):
    """num/den with 0/0 → 0: past convergence (tol=0 fixed-trip mode) both
    rz and pAp hit exact zero and a plain division would poison the batch
    with NaNs (regression-tested)."""
    return jnp.where(den != 0, num / jnp.where(den != 0, den, 1.0), 0.0)


def pcg(A: Callable, b: jax.Array, Minv: Callable, x0: jax.Array,
        tol: float, maxiter: int,
        dot: Optional[Callable] = None,
        with_diagnostics: bool = False,
        stagnation_floor: Optional[float] = None):
    """Preconditioned conjugate gradients for SPD ``A``.

    ``tol`` is relative to ‖b‖ (per dot-scope); ``tol=0`` runs exactly
    ``maxiter`` iterations.  Returns ``x``, or ``(x, iters, r)`` when
    ``with_diagnostics`` (feeds the PCG-iteration observability metric,
    SURVEY.md §5).  Never differentiate through this loop — every caller
    wraps it in an IFT ``custom_vjp``.
    """
    dot = dot or _global_dot
    r = b - A(x0)
    z = Minv(r)
    p = z
    rz = dot(r, z)
    bnorm2 = dot(b, b)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(bnorm2, 1e-30)
    # Noise-floor freeze: in fixed-trip mode (tol=0) a scenario that has
    # converged keeps iterating on rounding noise, and CG past its
    # stagnation point can DIVERGE (β of noise compounds into p; measured:
    # a 300-iteration f32 batch solve at 8³ reached |u| ~ 9e4 — and jit
    # fusion changes which side of the cliff a run lands on).  Once rz
    # falls below (4ε)²·rz₀ the scenario is frozen: α = 0 (x, r stop
    # moving) and β = 0 (p resets to z, staying bounded).  Per dot-scope,
    # so one batch member freezing never stalls the others.
    # Regression: tests/test_review_regressions.py.
    # ``stagnation_floor`` overrides the relative freeze threshold
    # ((4ε)² default — ≈4.8e-7 relative M-residual in f32, below the
    # 1e-6 tol-gated target but above the rounding-noise regime where
    # the divergence lives).  Short-trip reduced-precision inner solves
    # (ops/precision.py) pass 0.0 to opt out: their bf16 ε would freeze
    # at ~3e-2 relative, inside the working range their f32 outer
    # refinement relies on.
    if stagnation_floor is None:
        eps = jnp.finfo(jnp.asarray(b).dtype).eps
        stagnation_floor = (4.0 * eps) ** 2
    floor = stagnation_floor * jnp.maximum(rz, 1e-30)

    if tol > 0.0:
        # tol-gated mode: also exit when every scenario is frozen at its
        # stagnation floor — otherwise an unreachable tol spins the loop
        # to maxiter doing nothing (caught by the pcg_iters bench row).
        def cond(state):
            _, r, _, rz_, k = state
            return (k < maxiter) & jnp.any(dot(r, r) > tol2) \
                & jnp.any(rz_ > floor)
    else:
        # fixed-trip mode runs EXACTLY maxiter iterations — the batched
        # workload definition; frozen scenarios are numeric no-ops.
        def cond(state):
            _, r, _, _, k = state
            return k < maxiter

    def body(state):
        x, r, p, rz, k = state
        live = rz > floor
        Ap = A(p)
        alpha = jnp.where(live, _safe_div(rz, dot(p, Ap)), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = dot(r, z)
        beta = jnp.where(live & (rz_new > floor),
                         _safe_div(rz_new, rz), 0.0)
        p = z + beta * p
        return x, r, p, rz_new, k + 1

    x, r, _, _, iters = jax.lax.while_loop(cond, body, (x0, r, p, rz, 0))
    if with_diagnostics:
        return x, iters, r
    return x
