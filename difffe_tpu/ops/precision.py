"""Mixed-precision solve policies: bf16 inner solves + f32 iterative refinement.

SURVEY §7 "Hard parts" mandates an explicit precision policy for the
accelerator production path (the reference runs everything float64 on CPU,
/root/reference/diffhe/solver.py — no policy needed there).  Ours:

  f64  — golden path: accuracy gates, κ-recovery polish (utils/debug.py).
  f32  — production default.
  bf16 — storage/compute for bandwidth-bound inner solves, wrapped in
         f32 iterative refinement (this module).

Iterative refinement (Wilkinson): solve in low precision, compute the
residual in high precision, solve the *correction* in low precision again,
accumulate in high precision.  Each pass multiplies the error by
O(cond(A)·ε_lo), so with bf16 (ε≈2⁻⁸) and a well-conditioned BC-eliminated
P1 system, 2–3 passes recover full f32 accuracy while the inner solver
reads/writes half the bytes — the trade for a memory-bound inner solve.

Gradients: the refined solve converges to the same u = A⁻¹b as the f32
path, so the IFT adjoint is unchanged — we reuse the band contraction from
ops/tridiag.py with a *refined* adjoint solve.  No autodiff through the
refinement loop (project convention: every linear solve is a custom_vjp).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .tridiag import _tridiag_solve_impl, tridiag_matvec


def _dot_f32acc(u, v):
    """Inner product with f32 accumulation, result cast back to the CG state
    dtype.  bf16 CG stalls if α/β come from bf16-accumulated reductions
    (~2⁻⁸ relative error over thousands of terms); accumulating in f32 and
    casting the scalar back keeps the state bf16 without the stall."""
    acc = jnp.vdot(u.astype(jnp.float32), v.astype(jnp.float32))
    return acc.astype(u.dtype)


def refine(solve_lo, matvec_hi, b: jax.Array, iters: int = 2) -> jax.Array:
    """Generic iterative refinement.

    ``solve_lo(r)`` approximately solves A x = r (any precision — its output
    is cast up to ``b.dtype``); ``matvec_hi(x)`` applies A in the precision
    of ``b``.  Returns x with ``iters`` correction passes.  Fixed trip count
    (static unroll) — no data-dependent control flow under jit.
    """
    x = solve_lo(b).astype(b.dtype)
    for _ in range(iters):
        r = b - matvec_hi(x)
        x = x + solve_lo(r).astype(b.dtype)
    return x


def _band_solve_bf16(d, e, F, iters):
    """Refined tridiagonal solve: bf16 PCR inner, residual/accumulate f32+.

    The band is symmetrically Jacobi-scaled (D^-1/2 T D^-1/2, unit diagonal)
    in f32 BEFORE casting down: raw-magnitude PCR in bf16 cancels reduced
    diagonals to exact zero by sweep ~4 (measured: NaNs at n=64), while the
    unit-diagonal system keeps every reduced diagonal in [~0.5, 1] —
    bounded away from the bf16 rounding cliff."""
    s = 1.0 / jnp.sqrt(jnp.abs(d))
    d_lo = (d * s * s).astype(jnp.bfloat16)
    e_lo = (e * s[..., :-1] * s[..., 1:]).astype(jnp.bfloat16)

    def solve_lo(r):
        u_hat = _tridiag_solve_impl(d_lo, e_lo, (r * s).astype(jnp.bfloat16))
        return u_hat.astype(r.dtype) * s

    return refine(solve_lo, lambda x: tridiag_matvec(d, e, x), F, iters)


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def tridiag_solve_refined(d: jax.Array, e: jax.Array, F: jax.Array,
                          refine_iters: int = 3) -> jax.Array:
    """Solve T u = F with a bf16 PCR inner solver + f32 iterative refinement.

    Same contract as ops/tridiag.py:tridiag_solve (symmetric T, leading
    batch axes broadcast); the band and RHS stay in ``F.dtype`` (f32) for
    the residual/correction accumulation, the log₂n PCR sweeps run in bf16.

    Validity bound (Carson–Higham): IR contracts iff cond(T)·ε_bf16 < 1
    (cond ≈ (n/π)² for the P1 Laplacian; ε_bf16 = 2⁻⁸).  Measured against
    the f64 oracle (CPU, κ=1.37 — chosen NOT bf16-representable; exactly
    representable bands flatter the contraction ~10×): n=30 reaches 1.3e-6
    rel in 3 passes, n=128 reaches 1.8e-5 in 4, n=1024 DIVERGES.  Use the
    f32 path beyond n≈128 — this is the measured precision-policy
    boundary, not a tunable.
    """
    return _band_solve_bf16(d, e, F, refine_iters)


def _refined_fwd(d, e, F, refine_iters):
    u = _band_solve_bf16(d, e, F, refine_iters)
    return u, (d, e, u)


def _refined_bwd(refine_iters, res, g):
    d, e, u = res
    lam = _band_solve_bf16(d, e, g, refine_iters)   # T symmetric ⇒ Tλ = ḡ
    grad_d = -lam * u
    grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1])
    return grad_d, grad_e, lam


tridiag_solve_refined.defvjp(_refined_fwd, _refined_bwd)


# ---------------------------------------------------------------------------
# 2D: bf16-storage stencil CG + f32 refinement
# ---------------------------------------------------------------------------

def _stencil_solve_bf16(grid, kappa_lu, f, g, inner_iters, refine_iters):
    """Refined structured-grid solve: bf16 CG inner passes, f32 outer."""
    from .pcg import pcg
    from .stencil import (boundary_mask_grid, load_grid, stencil_apply,
                          stencil_coefficients)

    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, f.dtype)
    p = 1.0 - m
    F = load_grid(grid, f)
    b = m * g + p * (F - stencil_apply(C, m * g))
    diagA = m + p * C[..., 0, :, :]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)

    C_lo = C.astype(jnp.bfloat16)
    m_lo = m.astype(jnp.bfloat16)
    p_lo = p.astype(jnp.bfloat16)
    Minv_lo = Minv.astype(jnp.bfloat16)

    def solve_lo(r):
        r_lo = r.astype(jnp.bfloat16)
        A = lambda v: m_lo * v + p_lo * stencil_apply(C_lo, p_lo * v)
        # stagnation_floor=0: the default (16ε_bf16)² freeze would stop
        # the inner CG at ~1.6e-2 relative — inside the working range the
        # f32 outer refinement depends on (regression caught by
        # TestStencilBf16)
        return pcg(A, r_lo, lambda s: Minv_lo * s,
                   jnp.zeros_like(r_lo), 0.0, inner_iters,
                   dot=_dot_f32acc, stagnation_floor=0.0)

    x0 = jnp.broadcast_to(m * g, b.shape)
    r0 = b - (m * x0 + p * stencil_apply(C, p * x0))
    x = x0 + solve_lo(r0).astype(b.dtype)
    for _ in range(refine_iters):
        r = b - (m * x + p * stencil_apply(C, p * x))
        x = x + solve_lo(r).astype(b.dtype)
    return x


@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5))
def solve_poisson_structured_bf16(grid, kappa_lu, f: jax.Array,
                                  g: jax.Array, inner_iters: int = 48,
                                  refine_iters: int = 2) -> jax.Array:
    """Structured 2D Poisson solve with bf16 CG inner passes (f32 refined).

    Same contract as ops/stencil.py:solve_poisson_structured.  The stencil
    planes, preconditioner, and CG state are held in bf16 — halving the
    HBM traffic of the bandwidth-bound matvec sweep — while the outer
    residual/correction loop runs in ``f.dtype``.  ``inner_iters`` CG
    iterations per pass, ``refine_iters`` correction passes.

    Measured contraction ~0.09–0.15 per pass at 32×32 and 64×64 (CPU, f64
    oracle; Jacobi-preconditioned inner CG with f32-accumulated dots): at
    64×64, 48-inner × (1+3) passes reaches 5.1e-4 relative — the bf16 path
    targets ~1e-3–1e-4 gradient-step accuracy at roughly half the HBM
    traffic per iteration, not f32 roundoff (use the f32 path for that).

    Adjoint: IFT with a refined adjoint solve (same SPD operator), band
    cotangents via the closed-form residual VJP (ops/stencil.py:241).
    """
    return _stencil_solve_bf16(grid, kappa_lu, f, g, inner_iters,
                               refine_iters)


def _stencil_fwd(grid, kappa_lu, f, g, inner_iters, refine_iters):
    u = _stencil_solve_bf16(grid, kappa_lu, f, g, inner_iters, refine_iters)
    return u, (kappa_lu, f, g, u)


def _stencil_bwd(grid, inner_iters, refine_iters, res, gbar):
    from .pcg import pcg
    from .stencil import (boundary_mask_grid, residual_vjp_manual,
                          stencil_apply, stencil_coefficients)

    kappa_lu, f, g, u = res
    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, f.dtype)
    p = 1.0 - m

    C_lo = C.astype(jnp.bfloat16)
    m_lo = m.astype(jnp.bfloat16)
    p_lo = p.astype(jnp.bfloat16)
    diagA = m + p * C[..., 0, :, :]
    Minv_lo = (1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
               ).astype(jnp.bfloat16)

    def solve_lo(r):
        r_lo = r.astype(jnp.bfloat16)
        A = lambda v: m_lo * v + p_lo * stencil_apply(C_lo, p_lo * v)
        # stagnation_floor=0: the default (16ε_bf16)² freeze would stop
        # the inner CG at ~1.6e-2 relative — inside the working range the
        # f32 outer refinement depends on (regression caught by
        # TestStencilBf16)
        return pcg(A, r_lo, lambda s: Minv_lo * s,
                   jnp.zeros_like(r_lo), 0.0, inner_iters,
                   dot=_dot_f32acc, stagnation_floor=0.0)

    lam = solve_lo(gbar).astype(gbar.dtype)
    for _ in range(refine_iters):
        r = gbar - (m * lam + p * stencil_apply(C, p * lam))
        lam = lam + solve_lo(r).astype(gbar.dtype)
    return residual_vjp_manual(grid, kappa_lu, f, g, u, lam, C=C)


solve_poisson_structured_bf16.defvjp(_stencil_fwd, _stencil_bwd)
