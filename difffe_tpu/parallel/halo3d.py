"""Explicit halo-exchange domain decomposition in 3D: differentiable
distributed box solves over the device interconnect.

The 3D analogue of parallel/halo.py: shard the (nz+1, ny+1, nx+1) node
grid by z-PLANES across the ``dof`` mesh axis.  The box operator is a
7-point stencil (ops/stencil3d.py), so only the (±1,0,0) offsets cross
shard boundaries — each CG matvec exchanges exactly one (ny+1, nx+1)
plane with each z-neighbor via ``jax.lax.ppermute`` (nearest-neighbor
traffic only), then applies the stencil locally.  Surface/
volume ratio beats the 2D row split: halo bytes per shard are O(N²/P)
against O(N³/P) local work.

:func:`make_halo_solver_3d` is the production surface: a differentiable,
scenario-batched Poisson solve with the same IFT ``custom_vjp`` as the
single-device ``solve_poisson_structured_3d`` — forward AND adjoint CG
run through the halo matvec; gradients to κ (per-tet fields), f, and
Dirichlet g.  Numerically identical to the single-device solve (value
and gradients, tested on the virtual 8-device mesh).  3D is beyond the
reference (/root/reference/diffhe/solver.py:62-67).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.pcg import batched_dot, pcg
from ..ops.stencil import _shift2d
from ..ops.stencil3d import (
    OFFSETS3,
    StructuredGrid3,
    boundary_mask_box,
    load_box,
    residual_vjp_manual_3d,
    stencil3d_apply,
    stencil3d_coefficients,
)


def _exchange_planes(u_loc: jax.Array, axis: str) -> Tuple[jax.Array, jax.Array]:
    """(plane_above, plane_below) for this shard's block of z-planes.

    plane_above = last plane of the previous shard (zeros on shard 0);
    plane_below = first plane of the next shard (zeros on the last).
    ``u_loc``: (..., d_local, H, W); halos are (..., 1, H, W).
    """
    n = jax.lax.axis_size(axis)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    idx = jax.lax.axis_index(axis)
    plane_above = jax.lax.ppermute(u_loc[..., -1:, :, :], axis, fwd)
    plane_below = jax.lax.ppermute(u_loc[..., :1, :, :], axis, bwd)
    plane_above = jnp.where(idx == 0, 0.0, plane_above)
    plane_below = jnp.where(idx == n - 1, 0.0, plane_below)
    return plane_above, plane_below


def _local_stencil3d_apply(C_loc: jax.Array, u_loc: jax.Array,
                           axis: str) -> jax.Array:
    """7-point stencil on this shard's z-planes with halo exchange.

    C_loc: (..., 7, d_local, H, W); u_loc: (..., d_local, H, W).
    """
    above, below = _exchange_planes(u_loc, axis)
    u_ext = jnp.concatenate([above, u_loc, below], axis=-3)
    d = u_loc.shape[-3]
    out = jnp.zeros_like(u_loc)
    for k, (dz, dy, dx) in enumerate(OFFSETS3):
        # u_ext plane 1+z is local plane z; dz ∈ {-1, 0, 1}; the in-plane
        # (dy, dx) shift is local (zero fill = physical boundary).
        shifted = _shift2d(u_ext[..., 1 + dz:1 + dz + d, :, :], dy, dx)
        out = out + C_loc[..., k, :, :, :] * shifted
    return out


def make_halo_apply_3d(device_mesh: Mesh, axis: str = "dof",
                       batch_axis: Optional[str] = None,
                       batched: bool = False):
    """Sharded K·u over a z-plane-decomposed node grid.

    Unbatched: C (7, D, H, W), u (D, H, W); ``batched=True``: C
    (B, 7, D, H, W), u (B, D, H, W).  D = nz+1 must divide the ``axis``
    mesh size (and B the ``batch_axis`` size when sharded).
    """
    if batched:
        in_specs = (P(batch_axis, None, axis, None, None),
                    P(batch_axis, axis, None, None))
        out_specs = P(batch_axis, axis, None, None)
    else:
        in_specs = (P(None, axis, None, None), P(axis, None, None))
        out_specs = P(axis, None, None)
    return jax.shard_map(
        partial(_local_stencil3d_apply, axis=axis),
        mesh=device_mesh, in_specs=in_specs, out_specs=out_specs)


def make_halo_solver_3d(device_mesh: Mesh, grid: StructuredGrid3, *,
                        tol: float = 0.0, maxiter: Optional[int] = None,
                        axis: str = "dof",
                        batch_axis: Optional[str] = None):
    """Differentiable z-sharded structured 3D Poisson solve.

    Returns ``solve(kappa, f, g) → u`` with the contract of
    ``solve_poisson_structured_3d`` — κ a per-tet field (ne,) or (B, ne)
    (or cube-shaped), f/g node grids (optionally batched) — except every
    CG matvec (forward and adjoint) runs through the ppermute plane
    exchange, z-planes sharded over ``axis``, scenarios over
    ``batch_axis`` (replicated if None).  nz+1 must divide the ``axis``
    size.  IFT adjoint + closed-form residual cotangents
    (ops/stencil3d.py:residual_vjp_manual_3d); per-scenario α/β via
    batched dots (psum).
    """
    D, H, W = grid.node_shape
    maxit = maxiter if maxiter is not None else D * H * W
    apply_K = make_halo_apply_3d(device_mesh, axis, batch_axis, batched=True)
    dot = batched_dot(3)

    def _halo_pcg(C_b, b, x0):
        m = boundary_mask_box(grid, b.dtype)
        p = 1.0 - m

        def A(v):
            return m * v + p * apply_K(C_b, p * v)

        diagA = m + p * C_b[:, 0]
        Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
        return pcg(A, b, lambda r: Minv * r, x0, tol, maxit, dot=dot)

    def _with_batch(C, f, g):
        C_b = C if C.ndim == 5 else C[None]
        f_b = f if f.ndim == 4 else f[None]
        g_b = g if g.ndim == 4 else g[None]
        B = max(C_b.shape[0], f_b.shape[0], g_b.shape[0])
        return (jnp.broadcast_to(C_b, (B,) + C_b.shape[1:]),
                jnp.broadcast_to(f_b, (B, D, H, W)),
                jnp.broadcast_to(g_b, (B, D, H, W)), B)

    def _impl(kappa, f, g):
        C = stencil3d_coefficients(grid, kappa)
        C_b, f_b, g_b, B = _with_batch(C, f, g)
        m = boundary_mask_box(grid, f_b.dtype)
        p = 1.0 - m
        F = load_box(grid, f_b)
        mg = m * g_b
        b = mg + p * (F - stencil3d_apply(C_b, mg))
        u = _halo_pcg(C_b, b, mg)
        squeeze = f.ndim == 3 and C.ndim == 4 and g.ndim == 3
        return u[0] if squeeze else u

    @jax.custom_vjp
    def solve(kappa, f, g):
        return _impl(kappa, f, g)

    def _fwd(kappa, f, g):
        u = _impl(kappa, f, g)
        return u, (kappa, f, g, u)

    def _bwd(res, gbar):
        kappa, f, g, u = res
        C = stencil3d_coefficients(grid, kappa)
        gb = gbar if gbar.ndim == 4 else gbar[None]
        C_b = C if C.ndim == 5 else C[None]
        B = max(C_b.shape[0], gb.shape[0])
        C_b = jnp.broadcast_to(C_b, (B,) + C_b.shape[1:])
        gb = jnp.broadcast_to(gb, (B, D, H, W))
        lam = _halo_pcg(C_b, gb, jnp.zeros_like(gb))
        if gbar.ndim == 3:
            lam = lam[0]
        return residual_vjp_manual_3d(grid, kappa, f, g, u, lam, C=C)

    solve.defvjp(_fwd, _bwd)
    return solve
