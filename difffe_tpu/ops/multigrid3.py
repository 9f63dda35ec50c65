"""Geometric multigrid for structured 3D box grids (VERDICT-r4 item 1).

Fixed-trip Jacobi-PCG iteration counts grow like O(n) with the grid side,
and 3D is where that binds: N = n³ makes every iteration expensive AND the
ladder needs more of them.  A geometric V-cycle makes the
iteration count **mesh-independent** (~10-20 to 1e-10), the direct 3D
analogue of ops/multigrid.py:

* smoother     — weighted Jacobi (ω=2/3), symmetric pre/post sweeps
                 (symmetric ⇒ valid CG preconditioner);
* restriction  — full weighting, SEPARABLE: the 27-point [1,2,1]³/64
                 stencil factors into three axis passes of [1,2,1]/4 +
                 stride-2 subsample — pad/slice only, no conv, no scatter;
* prolongation — trilinear interpolation (transpose of restriction up to
                 the level scaling), axis-separable the same way;
* coarse ops   — re-discretized: per-tet κ averaged to a per-cube scalar,
                 2×2×2 cube-averaged per level, re-assembled through
                 ops/stencil3d.stencil3d_coefficients (symmetric, SPD —
                 approximate Galerkin is fine for preconditioning);
* coarsest     — extra smoothing sweeps.

Layout: every transfer operates on spatial axes (0, 1, 2), so the SAME
code runs the unbatched (nz+1, ny+1, nx+1) node grid and the batch-minor
(nz+1, ny+1, nx+1, B) layout of ops/stencil3d — the scenario batch stays
the trailing axis untouched at EVERY level, so coarse grids still move
whole contiguous rows of scenarios as the spatial grid shrinks.

Replaces torch.linalg.solve at 3D scale — the reference raises for dim>2
(/root/reference/diffhe/solver.py:62-67,174).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from .stencil3d import (
    StructuredGrid3,
    boundary_mask_box,
    kappa_to_cube,
    load_box,
    residual_vjp_manual_3d,
    stencil3d_apply,
    stencil3d_coefficients,
)


# --------------------------------------------------------------------------
# Separable transfer operators on spatial axes (0, 1, 2)
# --------------------------------------------------------------------------

def _restrict_axis(r: jax.Array, axis: int) -> jax.Array:
    """[1,2,1]/4 smoothing + stride-2 subsample along ``axis``:
    out[i] = ¼·r[2i−1] + ½·r[2i] + ¼·r[2i+1] (zero outside — transfers
    only ever see masked residuals, zero on Dirichlet rows)."""
    n = r.shape[axis]
    center = jax.lax.slice_in_dim(r, 0, n, stride=2, axis=axis)
    odd = jax.lax.slice_in_dim(r, 1, n - 1, stride=2, axis=axis)
    pad_lo = [(0, 0)] * r.ndim
    pad_lo[axis] = (1, 0)
    pad_hi = [(0, 0)] * r.ndim
    pad_hi[axis] = (0, 1)
    return 0.5 * center + 0.25 * (jnp.pad(odd, pad_lo)
                                  + jnp.pad(odd, pad_hi))


def restrict_full_weighting_3d(r: jax.Array) -> jax.Array:
    """(2a+1, 2b+1, 2c+1, ...) fine node grid → (a+1, b+1, c+1, ...)
    coarse, 27-point full weighting via three separable passes."""
    return _restrict_axis(_restrict_axis(_restrict_axis(r, 0), 1), 2)


def _prolong_axis(c: jax.Array, axis: int) -> jax.Array:
    """Linear interpolation along ``axis``: m+1 coarse → 2m+1 fine
    (fine[2i] = c[i], fine[2i+1] = ½(c[i]+c[i+1])).  Interleave by
    stack+reshape — static shapes, no scatter."""
    c = jnp.moveaxis(c, axis, -1)
    m1 = c.shape[-1]
    odd = 0.5 * (c[..., :-1] + c[..., 1:])                  # (… , m)
    pairs = jnp.stack([c[..., :-1], odd], axis=-1)          # (… , m, 2)
    body = pairs.reshape(c.shape[:-1] + (2 * (m1 - 1),))    # (… , 2m)
    fine = jnp.concatenate([body, c[..., -1:]], axis=-1)    # (… , 2m+1)
    return jnp.moveaxis(fine, -1, axis)


def prolong_trilinear(c: jax.Array) -> jax.Array:
    """(a+1, b+1, c+1, ...) coarse → (2a+1, 2b+1, 2c+1, ...) fine."""
    return _prolong_axis(_prolong_axis(_prolong_axis(c, 0), 1), 2)


def coarsen_kappa_3d(k6: jax.Array) -> jax.Array:
    """Per-tet κ (nz, ny, nx, 6, ...) → coarse (nz/2, ny/2, nx/2, 6, ...):
    tets averaged to a per-cube scalar, 2×2×2 cube-averaged, broadcast
    back over the 6 coarse tets.  Trailing (batch) axes pass
    through."""
    k = k6.mean(axis=3)                                     # (nz, ny, nx, …)
    nz, ny, nx = k.shape[:3]
    kc = k.reshape((nz // 2, 2, ny // 2, 2, nx // 2, 2) + k.shape[3:])
    kc = kc.mean(axis=(1, 3, 5))
    kc6 = jnp.broadcast_to(kc[:, :, :, None],
                           kc.shape[:3] + (6,) + kc.shape[3:])
    return kc6


# --------------------------------------------------------------------------
# Hierarchy + V-cycle (unbatched / batch-leading-via-vmap form)
# --------------------------------------------------------------------------

def _n_levels(grid: StructuredGrid3, max_levels: int) -> int:
    lv = 1
    n = min(grid.nx, grid.ny, grid.nz)
    while lv < max_levels and n % 2 == 0 and n > 2:
        n //= 2
        lv += 1
    return lv


def build_hierarchy_3d(grid: StructuredGrid3, kappa, max_levels: int = 6):
    """List of per-level (C planes, Dirichlet mask m, ω·D⁻¹), fine→coarse.

    kappa: flat (n_elements,) in FEMesh.box order or (nz, ny, nx, 6)."""
    k6 = kappa_to_cube(grid, kappa)
    dtype = jnp.result_type(k6)
    levels = []
    g = grid
    for _ in range(_n_levels(grid, max_levels)):
        C = stencil3d_coefficients(g, k6)
        m = boundary_mask_box(g, dtype)
        p = 1.0 - m
        diagA = m + p * C[..., 0, :, :, :]
        wdinv = (2.0 / 3.0) / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
        levels.append((C, m, wdinv))
        if (g.nx % 2 or g.ny % 2 or g.nz % 2
                or min(g.nx, g.ny, g.nz) <= 2):
            break
        k6 = coarsen_kappa_3d(k6)
        g = StructuredGrid3(nx=g.nx // 2, ny=g.ny // 2, nz=g.nz // 2,
                            hx=g.hx * 2, hy=g.hy * 2, hz=g.hz * 2)
    return levels


def _A3(C, m, v):
    p = 1.0 - m
    return m * v + p * stencil3d_apply(C, p * v)


def _smooth3(C, m, wdinv, x, b, sweeps: int):
    for _ in range(sweeps):
        x = x + wdinv * (b - _A3(C, m, x))
    return x


def v_cycle_3d(levels, b: jax.Array, level: int = 0,
               pre: int = 2, post: int = 2, coarse_sweeps: int = 12,
               gamma: int = 1):
    """One multigrid cycle for A e = b, zero initial guess.

    ``gamma``: 1 = V-cycle (default — the 2D lesson: W-cycle's traced
    graph grows exponentially with depth and blows XLA compile times
    under vmap; see ops/multigrid.py:solve_poisson_structured_mg)."""
    C, m, wdinv = levels[level]
    if level == len(levels) - 1:
        return _smooth3(C, m, wdinv, jnp.zeros_like(b), b, coarse_sweeps)
    x = _smooth3(C, m, wdinv, jnp.zeros_like(b), b, pre)
    mc = levels[level + 1][1]
    for _ in range(gamma):
        r = b - _A3(C, m, x)
        # Dirichlet rows carry no error; zero them around the transfer so
        # the coarse problem stays consistent with its own boundary mask
        rc = (1.0 - mc) * restrict_full_weighting_3d((1.0 - m) * r)
        ec = v_cycle_3d(levels, rc, level + 1, pre, post, coarse_sweeps,
                        gamma)
        x = x + (1.0 - m) * prolong_trilinear(ec)
        x = _smooth3(C, m, wdinv, x, b, post)
    return x


# --------------------------------------------------------------------------
# MG-preconditioned CG solve (IFT custom VJP)
# --------------------------------------------------------------------------

def _pcg_mg3(levels, b, x0, tol, maxiter, gamma: int = 1):
    from .pcg import pcg
    C, m, _ = levels[0]
    return pcg(lambda v: _A3(C, m, v), b,
               lambda r: v_cycle_3d(levels, (1.0 - m) * r,
                                    gamma=gamma) + m * r,
               x0, tol, maxiter, with_diagnostics=True)


def _mg3_setup(grid, kappa, f, g, max_levels):
    levels = build_hierarchy_3d(grid, kappa, max_levels)
    C, m, _ = levels[0]
    p = 1.0 - m
    F = load_box(grid, f)
    b = m * g + p * (F - stencil3d_apply(C, m * g))
    x0 = jnp.broadcast_to(m * g, b.shape)
    return levels, b, x0


def _mg3_impl(grid, kappa, f, g, tol, maxiter, max_levels, gamma):
    levels, b, x0 = _mg3_setup(grid, kappa, f, g, max_levels)
    maxiter = maxiter if maxiter is not None else 100
    x, _, _ = _pcg_mg3(levels, b, x0, tol, maxiter, gamma)
    return x


@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5, 6, 7))
def solve_poisson_structured_3d_mg(grid: StructuredGrid3, kappa,
                                   f: jax.Array, g: jax.Array,
                                   tol: float = 1e-10,
                                   maxiter: Optional[int] = None,
                                   max_levels: int = 6,
                                   gamma: int = 1) -> jax.Array:
    """MG-preconditioned CG Poisson solve on the box grid.

    Same contract as ``solve_poisson_structured_3d``; iteration counts
    are mesh-independent, so large boxes cost O(N) instead of O(N·n).
    Adjoint runs the same MG-CG (IFT custom VJP)."""
    return _mg3_impl(grid, kappa, f, g, tol, maxiter, max_levels, gamma)


def _mg3_fwd(grid, kappa, f, g, tol, maxiter, max_levels, gamma):
    u = _mg3_impl(grid, kappa, f, g, tol, maxiter, max_levels, gamma)
    return u, (kappa, f, g, u)


def _mg3_bwd(grid, tol, maxiter, max_levels, gamma, res, gbar):
    kappa, f, g, u = res
    levels = build_hierarchy_3d(grid, kappa, max_levels)
    maxit = maxiter if maxiter is not None else 100
    lam, _, _ = _pcg_mg3(levels, gbar, jnp.zeros_like(gbar), tol, maxit,
                         gamma)
    return residual_vjp_manual_3d(grid, kappa, f, g, u, lam,
                                  C=levels[0][0])


solve_poisson_structured_3d_mg.defvjp(_mg3_fwd, _mg3_bwd)


def mg3_diagnostics(grid: StructuredGrid3, kappa, f, g,
                    tol: float = 1e-10, maxiter: int = 100,
                    max_levels: int = 6, gamma: int = 1):
    """(u, iterations, final residual norm) — observability companion."""
    levels, b, x0 = _mg3_setup(grid, kappa, f, g, max_levels)
    x, iters, r = _pcg_mg3(levels, b, x0, tol, maxiter, gamma)
    return x, iters, jnp.sqrt(jnp.sum(r * r))


# --------------------------------------------------------------------------
# Batch-minor MG: the scenario batch stays the trailing axis at every level
# --------------------------------------------------------------------------

def build_hierarchy_bm(grid: StructuredGrid3, k6bm: jax.Array,
                       max_levels: int = 6):
    """Batch-minor hierarchy: k6bm (nz, ny, nx, 6, B) → per-level
    (C (7, nz'+1, ny'+1, nx'+1, B), m (…, 1), ω·D⁻¹)."""
    from .stencil3d import _bm_coefficients

    dtype = jnp.result_type(k6bm)
    levels = []
    g, k6 = grid, k6bm
    for _ in range(_n_levels(grid, max_levels)):
        C = _bm_coefficients(g, k6)
        m = boundary_mask_box(g, dtype)[..., None]
        p = 1.0 - m
        diagA = m + p * C[0]
        wdinv = (2.0 / 3.0) / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
        levels.append((C, m, wdinv))
        if (g.nx % 2 or g.ny % 2 or g.nz % 2
                or min(g.nx, g.ny, g.nz) <= 2):
            break
        k6 = coarsen_kappa_3d(k6)
        g = StructuredGrid3(nx=g.nx // 2, ny=g.ny // 2, nz=g.nz // 2,
                            hx=g.hx * 2, hy=g.hy * 2, hz=g.hz * 2)
    return levels


def _A3_bm(C, m, v):
    from .stencil3d import _bm_apply
    p = 1.0 - m
    return m * v + p * _bm_apply(C, p * v)


def _smooth3_bm(C, m, wdinv, x, b, sweeps: int):
    for _ in range(sweeps):
        x = x + wdinv * (b - _A3_bm(C, m, x))
    return x


def v_cycle_bm(levels, b: jax.Array, level: int = 0,
               pre: int = 2, post: int = 2, coarse_sweeps: int = 12):
    """Batch-minor V-cycle: state (nz'+1, ny'+1, nx'+1, B) — transfers
    act on axes (0, 1, 2), B stays trailing at every level."""
    C, m, wdinv = levels[level]
    if level == len(levels) - 1:
        return _smooth3_bm(C, m, wdinv, jnp.zeros_like(b), b,
                           coarse_sweeps)
    x = _smooth3_bm(C, m, wdinv, jnp.zeros_like(b), b, pre)
    mc = levels[level + 1][1]
    r = b - _A3_bm(C, m, x)
    rc = (1.0 - mc) * restrict_full_weighting_3d((1.0 - m) * r)
    ec = v_cycle_bm(levels, rc, level + 1, pre, post, coarse_sweeps)
    x = x + (1.0 - m) * prolong_trilinear(ec)
    return _smooth3_bm(C, m, wdinv, x, b, post)


def pcg_mg_bm(levels, b, x0, tol, maxiter,
              pre: int = 2, post: int = 2, coarse_sweeps: int = 12):
    """Batch-minor MG-PCG: per-scenario α/β (trailing-axis dot), V-cycle
    preconditioner.  Returns x."""
    from .pcg import pcg
    from .stencil3d import _bm_dot
    C, m, _ = levels[0]
    return pcg(lambda v: _A3_bm(C, m, v), b,
               lambda r: v_cycle_bm(levels, (1.0 - m) * r, pre=pre,
                                    post=post,
                                    coarse_sweeps=coarse_sweeps) + m * r,
               x0, tol, maxiter, dot=_bm_dot)


def kappa_mse_grad_step_3d_mg(grid: StructuredGrid3, kappa, f, g, u_data,
                              iters: int, warm_state=None,
                              return_state: bool = False,
                              pre: int = 1, post: int = 1,
                              coarse_sweeps: int = 8):
    """MG-preconditioned κ-inversion gradient step, batch-minor layout.

    Drop-in for ``kappa_mse_grad_step_3d`` with the Jacobi preconditioner
    replaced by a V-cycle: ``iters`` MG-PCG iterations replace O(n)
    Jacobi-PCG ones — the mesh-independent-iteration route for ≥48³
    grids where the fixed-trip ladder collapses (VERDICT-r4 item 1).
    Same warm-start contract (opaque batch-minor (u, λ) state)."""
    from .pcg import pcg
    from .stencil3d import (_bm_apply, _bm_dot, _bm_kappa_grad, _bm_load,
                            _bm_prep)

    _, m, fbm, gbm, k6bm = _bm_prep(grid, kappa, f, g, f.dtype)
    levels = build_hierarchy_bm(grid, k6bm)
    C = levels[0][0]
    p = 1.0 - m
    F = _bm_load(grid, fbm)
    mg_ = m * gbm
    b = mg_ + p * (F - _bm_apply(C, mg_))      # BC-eliminated RHS
    if warm_state is None:
        x0 = jnp.broadcast_to(mg_, b.shape)
        l0 = jnp.zeros_like(b)
    else:
        x0, l0 = warm_state

    Mi = lambda r: v_cycle_bm(levels, (1.0 - m) * r, pre=pre, post=post,
                              coarse_sweeps=coarse_sweeps) + m * r
    A = lambda v: _A3_bm(C, m, v)
    ubm = pcg(A, b, Mi, x0, 0.0, iters, dot=_bm_dot)
    udbm = jnp.moveaxis(u_data, 0, -1)
    diff = ubm - udbm
    numel = diff.size
    loss = jnp.sum(diff * diff) / numel
    rbar = (2.0 / numel) * diff
    lam = pcg(A, rbar, Mi, l0, 0.0, iters, dot=_bm_dot)
    w = m * gbm + p * ubm
    gk6 = -_bm_kappa_grad(grid, p * lam, w)
    gk = jnp.moveaxis(gk6, -1, 0)
    ka = jnp.asarray(kappa)
    if not (ka.ndim >= 5 and ka.shape[-1] == 6):
        gk = gk.reshape((gk.shape[0], grid.n_elements))
    if return_state:
        return loss, gk, (ubm, lam)
    return loss, gk
