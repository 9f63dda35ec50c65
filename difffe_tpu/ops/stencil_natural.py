"""Natural (Neumann/Robin) BCs on the structured-grid fast path.

The structured stencil solvers (ops/stencil.py) hard-code the factory
full-boundary Dirichlet mask, so adding a flux BC used to forfeit the
whole kernel class and drop to generic gather CG.  But mask-based
elimination works for ANY Dirichlet node set m — A = m + p·K·p is the
correct eliminated operator whatever m is — and natural BCs only touch:

* the LOAD: Neumann adds ∮ g_N v ds (an assembled (n_nodes,) vector,
  ops/neumann.py) and Robin adds ∮ r v ds — both just add to F on free
  rows;
* the boundary-row COEFFICIENTS: Robin's ∮ α u v ds boundary mass
  connects grid-adjacent nodes only, so it FOLDS into the existing
  7-plane stencil (``fold_robin_planes`` maps each COO entry to its
  OFFSETS plane — a static, host-side check).

So the whole natural-BC family rides the same stencil machinery: the
XLA stencil apply and PCG, per scenario under ``vmap`` for batches.

Generalizes the reference's Dirichlet-only BC elimination
(/root/reference/diffhe/solver.py:153-183).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .stencil import (
    OFFSETS,
    StructuredGrid,
    _reduce_to,
    _shift2d,
    load_grid,
    stencil_apply,
    stencil_coefficients,
    stencil_kappa_grad,
)


def fold_robin_planes(grid: StructuredGrid, rows, cols, vals,
                      load) -> Tuple[jax.Array, jax.Array]:
    """Fold a RobinBC's COO boundary stiffness into 7 stencil planes.

    rows/cols: (K,) static int arrays (host-checked); vals: (..., K)
    differentiable entries; load: (..., n_nodes).  Returns
    (C_r (..., 7, ny+1, nx+1), load grid (..., ny+1, nx+1)).  Raises
    ValueError when any entry connects non-grid-adjacent nodes (then the
    facade falls back to the generic path) — the check runs on host
    indices, outside jit.
    """
    ny1, nx1 = grid.node_shape
    r = np.asarray(rows)
    c = np.asarray(cols)
    ri, ci = np.divmod(r, nx1)
    rj, cj = np.divmod(c, nx1)
    dr, dc = rj - ri, cj - ci
    plane_of = {off: k for k, off in enumerate(OFFSETS)}
    planes_idx = []
    for k in range(len(r)):
        off = (int(dr[k]), int(dc[k]))
        if off not in plane_of:
            raise ValueError(
                f"Robin entry ({int(r[k])},{int(c[k])}) connects "
                f"non-adjacent grid nodes (offset {off}) — not foldable "
                f"into the stencil; use the generic path")
        planes_idx.append(plane_of[off])
    planes_idx = jnp.asarray(planes_idx, jnp.int32)
    flat_pos = jnp.asarray(planes_idx * (ny1 * nx1) + ri * nx1 + ci,
                           jnp.int32)
    vals = jnp.asarray(vals)
    lead = vals.shape[:-1]
    C_r = jnp.zeros(lead + (7 * ny1 * nx1,), vals.dtype)
    C_r = C_r.at[..., flat_pos].add(vals)
    C_r = C_r.reshape(lead + (7, ny1, nx1))
    load = jnp.asarray(load)
    return C_r, load.reshape(load.shape[:-1] + (ny1, nx1))


def _apply_tot(C, C_r, v):
    out = stencil_apply(C, v)
    if C_r is not None:
        out = out + stencil_apply(C_r, v)
    return out


def _solve_nat_impl(grid, kappa_lu, f, g, m, qn, C_r, rload, tol,
                    maxiter):
    from .pcg import batched_dot, pcg

    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    p = 1.0 - m
    F = load_grid(grid, f)
    extra = 0.0
    if qn is not None:
        extra = extra + qn
    if rload is not None:
        extra = extra + rload
    mg = m * g
    b = mg + p * (F + extra - _apply_tot(C, C_r, mg))
    diagA = m + p * (C[..., 0, :, :]
                     + (C_r[..., 0, :, :] if C_r is not None else 0.0))
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    x0 = jnp.broadcast_to(mg, b.shape)
    batched = b.ndim > 2
    maxit = maxiter if maxiter is not None else (grid.nx + 1) * (grid.ny + 1)
    u = pcg(lambda v: m * v + p * _apply_tot(C, C_r, p * v), b,
            lambda r_: Minv * r_, x0, tol, maxit,
            dot=batched_dot(2) if batched else None)
    return u, C


@partial(jax.custom_vjp, nondiff_argnums=(0, 8, 9))
def solve_poisson_structured_natural(grid: StructuredGrid, kappa_lu,
                                     f: jax.Array, g: jax.Array,
                                     m: jax.Array,
                                     qn: Optional[jax.Array] = None,
                                     C_r: Optional[jax.Array] = None,
                                     rload: Optional[jax.Array] = None,
                                     tol: float = 0.0,
                                     maxiter: Optional[int] = None):
    """Structured solve with a GENERAL Dirichlet mask + natural BCs.

    kappa_lu: (κ_lower, κ_upper) per-triangle (…, ny, nx); f, g: node
    grids (optionally batched f); m: (ny+1, nx+1) Dirichlet mask — any
    node set, not just the factory boundary; qn: optional Neumann load
    grid (already edge-assembled, ops/neumann.py semantics); C_r/rload:
    optional folded Robin planes + load grid (``fold_robin_planes``).
    Returns u on the node grid.  Differentiable wrt κ, f, g, qn, C_r,
    rload via one adjoint solve (IFT); the mask gets a zero cotangent
    (it is 0/1 set data, not a continuous parameter).
    """
    u, _ = _solve_nat_impl(grid, kappa_lu, f, g, m, qn, C_r, rload, tol,
                           maxiter)
    return u


def _nat_fwd(grid, kappa_lu, f, g, m, qn, C_r, rload, tol, maxiter):
    u, C = _solve_nat_impl(grid, kappa_lu, f, g, m, qn, C_r, rload, tol,
                           maxiter)
    return u, (kappa_lu, f, g, m, qn, C_r, rload, u, C)


def _nat_bwd(grid, tol, maxiter, res, gbar):
    from .pcg import batched_dot, pcg

    kappa_lu, f, g, m, qn, C_r, rload, u, C = res
    kl, ku = kappa_lu
    p = 1.0 - m
    diagA = m + p * (C[..., 0, :, :]
                     + (C_r[..., 0, :, :] if C_r is not None else 0.0))
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    batched = gbar.ndim > 2
    maxit = maxiter if maxiter is not None else (grid.nx + 1) * (grid.ny + 1)
    lam = pcg(lambda v: m * v + p * _apply_tot(C, C_r, p * v), gbar,
              lambda r_: Minv * r_, jnp.zeros_like(gbar), tol, maxit,
              dot=batched_dot(2) if batched else None)

    pl_ = p * lam
    w = m * g + p * u
    # κ cotangent: closed-form per-triangle contraction (K part only —
    # the Robin planes carry no κ)
    g_low, g_up = stencil_kappa_grad(grid, pl_, w)
    grad_f = load_grid(grid, pl_)
    grad_g = m * (lam - _apply_tot(C, C_r, pl_))
    # natural loads enter b as +p·(…): cotangent is p·λ
    grad_qn = None if qn is None else _reduce_to(pl_, jnp.shape(qn))
    grad_rload = None if rload is None else _reduce_to(pl_,
                                                       jnp.shape(rload))
    # Robin planes enter as −(pλ)ᵀ R(w): ∂/∂C_r[k] = −(pλ) ⊙ shift(w, off_k)
    if C_r is None:
        grad_Cr = None
    else:
        planes = [-pl_ * _shift2d(w, dr, dc) for dr, dc in OFFSETS]
        grad_Cr = _reduce_to(jnp.stack(planes, axis=-3), jnp.shape(C_r))
    return ((_reduce_to(-g_low, jnp.shape(kl)),
             _reduce_to(-g_up, jnp.shape(ku))),
            _reduce_to(grad_f, jnp.shape(f)),
            _reduce_to(grad_g, jnp.shape(g)),
            jnp.zeros_like(m), grad_qn, grad_Cr, grad_rload)


solve_poisson_structured_natural.defvjp(_nat_fwd, _nat_bwd)
