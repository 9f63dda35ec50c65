"""Batched symmetric tridiagonal solver via parallel cyclic reduction (PCR).

The 1D P1 stiffness matrix on a chain mesh is symmetric tridiagonal, so the
reference's dense LU (`torch.linalg.solve`, /root/reference/diffhe/solver.py:174,
O(n³)) is replaced by PCR: log₂n fully-vectorized elementwise sweeps —
depth O(log n) with every sweep an elementwise map over (batch, n).  A
sequential Thomas scan would serialize over n; PCR keeps the whole scenario
batch × DOF plane busy.

Gradients: ``tridiag_solve`` carries a ``jax.custom_vjp``.  The matrix is
symmetric, so the adjoint is one more PCR solve λ = T⁻¹ḡ and the band
gradients are the elementwise contractions

    ∂F = λ,   ∂d = −λ⊙u,   ∂e_i = −(λ_i u_{i+1} + λ_{i+1} u_i)

— replacing the reference's per-scatter-add autograd tape (SURVEY.md §3.2).

All functions operate on the last axis and broadcast over arbitrary leading
batch axes.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..mesh import FEMesh


def tridiag_matvec(d: jax.Array, e: jax.Array, x: jax.Array) -> jax.Array:
    """y = T x for symmetric tridiagonal T (diag d: (...,n), off-diag e: (...,n-1))."""
    y = d * x
    y = y.at[..., :-1].add(e * x[..., 1:])
    y = y.at[..., 1:].add(e * x[..., :-1])
    return y


def _shift_down(x, s, fill):
    """y_i = x_{i+s} (pad tail with fill)."""
    pad = jnp.full(x.shape[:-1] + (s,), fill, dtype=x.dtype)
    return jnp.concatenate([x[..., s:], pad], axis=-1)


def _shift_up(x, s, fill):
    """y_i = x_{i-s} (pad head with fill)."""
    pad = jnp.full(x.shape[:-1] + (s,), fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-s]], axis=-1)


def _pcr(a, b, c, r):
    """Parallel cyclic reduction for a_i x_{i-1} + b_i x_i + c_i x_{i+1} = r_i.

    a, b, c, r: (..., n) with a[...,0] = c[...,-1] = 0.  Unrolled over
    ⌈log₂n⌉ static strides (compile-time constant — no dynamic shapes).
    """
    n = b.shape[-1]
    steps = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    s = 1
    for _ in range(steps):
        b_up, b_dn = _shift_up(b, s, 1.0), _shift_down(b, s, 1.0)
        a_up, c_dn = _shift_up(a, s, 0.0), _shift_down(c, s, 0.0)
        c_up, a_dn = _shift_up(c, s, 0.0), _shift_down(a, s, 0.0)
        r_up, r_dn = _shift_up(r, s, 0.0), _shift_down(r, s, 0.0)
        alpha = -a / b_up
        gamma = -c / b_dn
        a = alpha * a_up
        c = gamma * c_dn
        b = b + alpha * c_up + gamma * a_dn
        r = r + alpha * r_up + gamma * r_dn
        s *= 2
    return r / b


@jax.custom_vjp
def tridiag_solve(d: jax.Array, e: jax.Array, F: jax.Array) -> jax.Array:
    """Solve T u = F for symmetric tridiagonal T = tridiag(e, d, e)."""
    return _tridiag_solve_impl(d, e, F)


def _tridiag_solve_impl(d, e, F):
    zero_head = jnp.zeros(e.shape[:-1] + (1,), dtype=e.dtype)
    a = jnp.concatenate([zero_head, e], axis=-1)   # sub-diagonal
    c = jnp.concatenate([e, zero_head], axis=-1)   # super-diagonal
    return _pcr(a, d, c, F)


def _tridiag_solve_fwd(d, e, F):
    u = _tridiag_solve_impl(d, e, F)
    return u, (d, e, u)


def _tridiag_solve_bwd(res, g):
    d, e, u = res
    lam = _tridiag_solve_impl(d, e, g)             # T symmetric ⇒ Tλ = ḡ
    grad_F = lam
    grad_d = -lam * u
    grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1])
    return grad_d, grad_e, grad_F


tridiag_solve.defvjp(_tridiag_solve_fwd, _tridiag_solve_bwd)


def solve_poisson_tridiag(mesh: FEMesh, d: jax.Array, e: jax.Array,
                          F: jax.Array, backend: str = "xla",
                          bc_values=None, chunk: int = 64) -> jax.Array:
    """BC-eliminate banded (d, e, F) on a 1D chain mesh and PCR-solve.

    Mask elimination in band form (see ops/solve.py for the dense analogue):
      d̃ = p⊙d + m,  ẽ_i = p_i p_{i+1} e_i,  F̃ = m⊙g + p(F − T(m⊙g)).
    Supports leading batch axes on d, e, F.

    backend: 'xla' (fused PCR sweeps) or 'spike' (chunked Thomas +
    reduced system, ops/spike.py).
    ``bc_values`` optionally overrides the mesh's Dirichlet values and may
    carry leading batch axes (per-scenario BC perturbations — a north-star
    batch dimension, BASELINE.json).
    """
    m = mesh.bc_mask
    g = mesh.bc_values if bc_values is None else \
        jnp.asarray(bc_values, dtype=mesh.dtype)
    p = 1.0 - m
    d_mod = p * d + m
    e_mod = p[..., :-1] * p[..., 1:] * e
    mg = jnp.broadcast_to(m * g, F.shape)
    F_mod = jnp.broadcast_to(m * g + p * (F - tridiag_matvec(d, e, mg)),
                             F.shape)
    if backend == "spike":
        # the spike solver takes explicitly batched bands
        bshape = F_mod.shape[:-1]
        d_mod = jnp.broadcast_to(d_mod, bshape + d_mod.shape[-1:])
        e_mod = jnp.broadcast_to(e_mod, bshape + e_mod.shape[-1:])
        from .spike import tridiag_solve_spike
        return tridiag_solve_spike(d_mod, e_mod, F_mod, chunk)
    if backend != "xla":
        raise ValueError(f"unknown tridiagonal backend {backend!r} "
                         "(expected 'xla' or 'spike')")
    return tridiag_solve(d_mod, e_mod, F_mod)
