"""Geometric multigrid-preconditioned CG for structured 2D grids.

Jacobi-PCG iteration counts grow like O(n) with mesh refinement; a
geometric V-cycle preconditioner makes them **mesh-independent** (~10-20),
turning large structured solves O(N) total work.  Everything is built from
the 7-point stencil machinery (ops/stencil.py) and stays pure XLA:

* smoother — weighted Jacobi (ω=2/3), symmetric pre/post sweeps;
* restriction — full-weighting 3×3 stencil, stride-2 convolution;
* prolongation — bilinear interpolation (slice-assembled, its transpose);
* coarse operators — re-discretized: per-quad κ averaged 2×2 per level
  (symmetric, SPD; approximate Galerkin is fine for preconditioning);
* coarsest level — extra smoothing sweeps.

Grid sizes must be divisible by 2 per coarsening; ``max_levels`` adapts to
the factorization of n.  Wrapped in the same IFT ``custom_vjp`` as the
other solvers — the adjoint runs the same MG-CG.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from .stencil import (
    StructuredGrid,
    boundary_mask_grid,
    load_grid,
    stencil_apply,
    stencil_coefficients,
)


# --------------------------------------------------------------------------
# Transfer operators
# --------------------------------------------------------------------------

_FW_KERNEL = jnp.array([[1.0, 2.0, 1.0],
                        [2.0, 4.0, 2.0],
                        [1.0, 2.0, 1.0]]) / 16.0


def restrict_full_weighting(r: jax.Array) -> jax.Array:
    """(2m+1, 2k+1) fine node grid → (m+1, k+1) coarse, full weighting."""
    x = r[None, None]
    k = _FW_KERNEL[None, None].astype(r.dtype)
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(2, 2), padding=[(1, 1), (1, 1)])
    return out[0, 0]


def prolong_bilinear(c: jax.Array, fine_shape: Tuple[int, int]) -> jax.Array:
    """(m+1, k+1) coarse → (2m+1, 2k+1) fine, bilinear interpolation."""
    H, W = fine_shape
    out = jnp.zeros((H, W), dtype=c.dtype)
    out = out.at[::2, ::2].set(c)
    out = out.at[1::2, ::2].set(0.5 * (c[:-1, :] + c[1:, :]))
    out = out.at[::2, 1::2].set(0.5 * (c[:, :-1] + c[:, 1:]))
    out = out.at[1::2, 1::2].set(
        0.25 * (c[:-1, :-1] + c[:-1, 1:] + c[1:, :-1] + c[1:, 1:]))
    return out


def coarsen_kappa(kl: jax.Array, ku: jax.Array):
    """(..., n, n) per-quad κ pair → (..., n/2, n/2) coarse pair (2×2 cell
    average); lead axes (scenario batches) pass through."""
    k = 0.5 * (kl + ku)
    ny, nx = k.shape[-2:]
    kc = k.reshape(k.shape[:-2] + (ny // 2, 2, nx // 2, 2)).mean(
        axis=(-3, -1))
    return kc, kc


# --------------------------------------------------------------------------
# Hierarchy + V-cycle
# --------------------------------------------------------------------------

def _n_levels(grid: StructuredGrid, max_levels: int) -> int:
    lv = 1
    n = min(grid.nx, grid.ny)
    while lv < max_levels and n % 2 == 0 and n > 4:
        n //= 2
        lv += 1
    return lv


def build_hierarchy(grid: StructuredGrid, kl, ku, max_levels: int = 6):
    """List of per-level (C planes, Dirichlet mask m, ω·D⁻¹) fine→coarse."""
    levels = []
    g, a, b = grid, kl, ku
    dtype = jnp.result_type(kl)
    for _ in range(_n_levels(grid, max_levels)):
        C = stencil_coefficients(g, a, b)
        m = boundary_mask_grid(g, dtype)
        p = 1.0 - m
        diagA = m + p * C[..., 0, :, :]
        wdinv = (2.0 / 3.0) / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
        levels.append((C, m, wdinv))
        if g.nx % 2 or g.ny % 2 or min(g.nx, g.ny) <= 4:
            break
        a, b = coarsen_kappa(a, b)
        g = StructuredGrid(nx=g.nx // 2, ny=g.ny // 2,
                           hx=g.hx * 2, hy=g.hy * 2)
    return levels


def _A(C, m, v):
    p = 1.0 - m
    return m * v + p * stencil_apply(C, p * v)


def _smooth(C, m, wdinv, x, b, sweeps: int):
    for _ in range(sweeps):
        x = x + wdinv * (b - _A(C, m, x))
    return x


def v_cycle(levels, b: jax.Array, level: int = 0,
            pre: int = 2, post: int = 2, coarse_sweeps: int = 12,
            gamma: int = 2):
    """One multigrid cycle for A e = b, zero initial guess.

    ``gamma`` is the cycle index: 1 = V-cycle, 2 = W-cycle (default — with
    rediscretized coarse operators the V-cycle degrades slowly with depth,
    measured 12→30 CG iterations from n=16→64, while the W-cycle stays at
    9→18)."""
    C, m, wdinv = levels[level]
    if level == len(levels) - 1:
        return _smooth(C, m, wdinv, jnp.zeros_like(b), b, coarse_sweeps)
    x = _smooth(C, m, wdinv, jnp.zeros_like(b), b, pre)
    mc = levels[level + 1][1]
    for _ in range(gamma):
        r = b - _A(C, m, x)
        # Dirichlet rows carry no error; zero them before transfer so the
        # coarse problem stays consistent with its own boundary mask
        rc = (1.0 - mc) * restrict_full_weighting((1.0 - m) * r)
        ec = v_cycle(levels, rc, level + 1, pre, post, coarse_sweeps, gamma)
        x = x + (1.0 - m) * prolong_bilinear(ec, b.shape)
        x = _smooth(C, m, wdinv, x, b, post)
    return x


# --------------------------------------------------------------------------
# MG-preconditioned CG solve (IFT custom VJP)
# --------------------------------------------------------------------------

def _pcg_mg(levels, b, x0, tol, maxiter, gamma: int = 2):
    from .pcg import pcg
    C, m, _ = levels[0]
    return pcg(lambda v: _A(C, m, v), b,
               lambda r: v_cycle(levels, (1.0 - m) * r, gamma=gamma) + m * r,
               x0, tol, maxiter, with_diagnostics=True)


def _mg_setup(grid, kappa_lu, f, g, max_levels):
    """Shared setup for solve and diagnostics: (levels, eliminated b, x0)."""
    kl, ku = kappa_lu
    levels = build_hierarchy(grid, kl, ku, max_levels)
    m = levels[0][1]
    p = 1.0 - m
    F = load_grid(grid, f)
    C = levels[0][0]
    b = m * g + p * (F - stencil_apply(C, m * g))
    x0 = jnp.broadcast_to(m * g, b.shape)
    return levels, b, x0


def _mg_impl(grid, kappa_lu, f, g, tol, maxiter, max_levels, gamma):
    levels, b, x0 = _mg_setup(grid, kappa_lu, f, g, max_levels)
    maxiter = maxiter if maxiter is not None else 100
    x, _, _ = _pcg_mg(levels, b, x0, tol, maxiter, gamma)
    return x


@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5, 6, 7))
def solve_poisson_structured_mg(grid: StructuredGrid, kappa_lu, f: jax.Array,
                                g: jax.Array, tol: float = 1e-10,
                                maxiter: Optional[int] = None,
                                max_levels: int = 6,
                                gamma: int = 1) -> jax.Array:
    """MG-preconditioned CG Poisson solve on the structured grid.

    Same contract as ``solve_poisson_structured``; iteration counts are
    mesh-independent (~10-30 to 1e-10), so large grids cost O(N).

    ``gamma`` is the cycle index (1 = V-cycle DEFAULT, 2 = W-cycle) and
    ``max_levels`` caps hierarchy depth.  The W-cycle visits level L
    2^L times, so its traced graph grows exponentially with depth —
    measured >10-min XLA compile at 128×128 / 6 levels under vmap.  The
    V-cycle default compiles in seconds at every size tried (trades ~1.5×
    more iterations); opt into gamma=2 only for small hierarchies where
    per-iteration convergence matters more than compile latency."""
    return _mg_impl(grid, kappa_lu, f, g, tol, maxiter, max_levels, gamma)


def _mg_fwd(grid, kappa_lu, f, g, tol, maxiter, max_levels, gamma):
    u = _mg_impl(grid, kappa_lu, f, g, tol, maxiter, max_levels, gamma)
    return u, (kappa_lu, f, g, u)


def _mg_bwd(grid, tol, maxiter, max_levels, gamma, res, gbar):
    kappa_lu, f, g, u = res
    kl, ku = kappa_lu
    levels = build_hierarchy(grid, kl, ku, max_levels)
    maxit = maxiter if maxiter is not None else 100
    lam, _, _ = _pcg_mg(levels, gbar, jnp.zeros_like(gbar), tol, maxit, gamma)
    from .stencil import residual_vjp_manual
    return residual_vjp_manual(grid, kappa_lu, f, g, u, lam, C=levels[0][0])


solve_poisson_structured_mg.defvjp(_mg_fwd, _mg_bwd)


def mg_diagnostics(grid: StructuredGrid, kappa_lu, f, g,
                   tol: float = 1e-10, maxiter: int = 100,
                   max_levels: int = 6, gamma: int = 2):
    """(u, iterations, final residual norm) — observability companion."""
    levels, b, x0 = _mg_setup(grid, kappa_lu, f, g, max_levels)
    x, iters, r = _pcg_mg(levels, b, x0, tol, maxiter, gamma)
    return x, iters, jnp.sqrt(jnp.sum(r * r))
