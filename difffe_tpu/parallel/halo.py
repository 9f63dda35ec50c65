"""Explicit halo-exchange domain decomposition: differentiable distributed
2D solves over the device interconnect.

GSPMD shards DOF axes automatically (parallel/sharding.py), but the survey's
layer-6 mandate (SURVEY.md §7, §2b 'halo exchange of element-boundary
contributions') calls for the explicit SPMD form — the domain-decomposition
analogue of ring attention's neighbor pass: shard the 2D node grid by rows
across the ``dof`` mesh axis, exchange one boundary row with each neighbor
via ``jax.lax.ppermute``, and apply the 7-point stencil locally.

:func:`make_halo_solver` is the production surface (BASELINE config 4:
batched κ-field inversion with PCG solves sharded across a host): a
**differentiable, scenario-batched** Poisson solve whose forward and adjoint
CG both run through the halo matvec, with the same implicit-function-theorem
``custom_vjp`` as ops/cg.py — gradients to κ (per-triangle fields), f, and
Dirichlet g, no tape through the iteration.  Replaces torch autograd through
/root/reference/diffhe/solver.py:174 at distributed scale.  Numerically
identical to the single-device ``solve_poisson_structured`` (value and
gradients, tested on the virtual 8-device mesh).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.pcg import batched_dot, pcg
from ..ops.stencil import (
    OFFSETS,
    StructuredGrid,
    _shift2d,
    boundary_mask_grid,
    load_grid,
    residual_vjp_manual,
    stencil_apply,
    stencil_coefficients,
)


def _exchange_halos(u_loc: jax.Array, axis: str) -> Tuple[jax.Array, jax.Array]:
    """Return (row_above, row_below) for this shard's block of rows.

    row_above = last row of the previous shard (zeros on shard 0);
    row_below = first row of the next shard (zeros on the last shard).
    One ppermute each way — nearest-neighbor traffic only.
    ``u_loc``: (..., h_local, W); halos are (..., 1, W).
    """
    n = jax.lax.axis_size(axis)
    fwd = [(i, (i + 1) % n) for i in range(n)]      # send downward
    bwd = [(i, (i - 1) % n) for i in range(n)]      # send upward
    idx = jax.lax.axis_index(axis)

    row_above = jax.lax.ppermute(u_loc[..., -1:, :], axis, fwd)
    row_below = jax.lax.ppermute(u_loc[..., :1, :], axis, bwd)
    # zero the wrapped-around halos at the physical boundaries
    row_above = jnp.where(idx == 0, 0.0, row_above)
    row_below = jnp.where(idx == n - 1, 0.0, row_below)
    return row_above, row_below


def _local_stencil_apply(C_loc: jax.Array, u_loc: jax.Array,
                         axis: str) -> jax.Array:
    """Apply the 7-point stencil to this shard's rows with halo exchange.

    C_loc: (..., 7, h_local, W); u_loc: (..., h_local, W) — leading axes are
    scenario batch.
    """
    row_above, row_below = _exchange_halos(u_loc, axis)
    u_ext = jnp.concatenate([row_above, u_loc, row_below], axis=-2)
    h = u_loc.shape[-2]
    out = jnp.zeros_like(u_loc)
    for k, (dr, dc) in enumerate(OFFSETS):
        # u_ext row 1+r corresponds to local row r; dr ∈ {-1, 0, 1}
        shifted = _shift2d(u_ext[..., 1 + dr:1 + dr + h, :], 0, dc)
        out = out + C_loc[..., k, :, :] * shifted
    return out


def make_halo_apply(device_mesh: Mesh, axis: str = "dof",
                    batch_axis: Optional[str] = None, batched: bool = False):
    """Build a sharded K·u over a row-decomposed node grid.

    Returns ``apply(C, u) → K·u``.  Unbatched: C (7, H, W), u (H, W);
    with ``batched=True``: C (B, 7, H, W), u (B, H, W), the scenario axis
    optionally sharded over ``batch_axis``.  Row count H must divide the
    ``axis`` mesh size (and B the ``batch_axis`` size when sharded).
    """
    if batched:
        in_specs = (P(batch_axis, None, axis, None), P(batch_axis, axis, None))
        out_specs = P(batch_axis, axis, None)
    else:
        in_specs = (P(None, axis, None), P(axis, None))
        out_specs = P(axis, None)
    return jax.shard_map(
        partial(_local_stencil_apply, axis=axis),
        mesh=device_mesh,
        in_specs=in_specs,
        out_specs=out_specs,
    )


def halo_cg_solve(device_mesh: Mesh, C: jax.Array, m: jax.Array,
                  b: jax.Array, maxiter: int, axis: str = "dof"):
    """Distributed Jacobi-PCG with the halo-exchange matvec (forward only;
    use :func:`make_halo_solver` for the differentiable form).

    C: (7, H, W) stencil planes (BC-free), m: (H, W) Dirichlet mask,
    b: (H, W) eliminated RHS.  All row-sharded over ``axis``; reductions
    are global sums XLA lowers to psums.
    """
    apply_K = make_halo_apply(device_mesh, axis)
    p_mask = 1.0 - m

    def A(v):
        return m * v + p_mask * apply_K(C, p_mask * v)

    diagA = m + p_mask * C[0]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    return pcg(A, b, lambda r: Minv * r, jnp.zeros_like(b), 0.0, maxiter)


# --------------------------------------------------------------------------
# Differentiable, batched DOF-sharded solve (BASELINE config 4)
# --------------------------------------------------------------------------

def make_halo_solver(device_mesh: Mesh, grid: StructuredGrid, *,
                     tol: float = 0.0, maxiter: Optional[int] = None,
                     axis: str = "dof", batch_axis: Optional[str] = None):
    """Build a differentiable DOF-sharded structured Poisson solve.

    Returns ``solve(kappa_lu, f, g) → u`` with the contract of
    ``ops.stencil.solve_poisson_structured`` — kappa_lu a (κ_lower, κ_upper)
    pair of (ny, nx) or (B, ny, nx) per-triangle fields, f the forcing on
    the (H, W) = (ny+1, nx+1) node grid (optionally batched), g the
    Dirichlet boundary values — except every CG matvec (forward *and*
    adjoint) runs through the explicit ppermute halo exchange, node rows
    sharded over the ``axis`` mesh axis and the scenario batch over
    ``batch_axis`` (replicated if None).  H must divide the ``axis`` size.

    Differentiation is the implicit function theorem (one adjoint halo-CG
    solve with ḡ as RHS + the closed-form residual-map cotangents,
    ops/stencil.py:residual_vjp_manual), so the sharded path produces the
    same gradients as the single-device solver — never autodiff through the
    while_loop.  Per-scenario α/β via batched dots (psum).
    """
    H, W = grid.node_shape
    maxit = maxiter if maxiter is not None else H * W
    apply_K = make_halo_apply(device_mesh, axis, batch_axis, batched=True)
    dot = batched_dot(2)

    def _halo_pcg(C_b, b, x0):
        """C_b: (B, 7, H, W); b, x0: (B, H, W).  m is replicated (H, W)."""
        m = boundary_mask_grid(grid, b.dtype)
        p = 1.0 - m

        def A(v):
            return m * v + p * apply_K(C_b, p * v)

        diagA = m + p * C_b[:, 0]
        Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
        return pcg(A, b, lambda r: Minv * r, x0, tol, maxit, dot=dot)

    def _with_batch(C, f, g):
        """Broadcast C/f/g to a shared leading scenario axis."""
        C_b = C if C.ndim == 4 else C[None]
        f_b = f if f.ndim == 3 else f[None]
        g_b = g if g.ndim == 3 else g[None]
        B = max(C_b.shape[0], f_b.shape[0], g_b.shape[0])
        return (jnp.broadcast_to(C_b, (B,) + C_b.shape[1:]),
                jnp.broadcast_to(f_b, (B, H, W)),
                jnp.broadcast_to(g_b, (B, H, W)), B)

    def _impl(kappa_lu, f, g):
        kl, ku = kappa_lu
        C = stencil_coefficients(grid, kl, ku)
        C_b, f_b, g_b, B = _with_batch(C, f, g)
        m = boundary_mask_grid(grid, f_b.dtype)
        p = 1.0 - m
        F = load_grid(grid, f_b)
        mg = m * g_b
        b = mg + p * (F - stencil_apply(C_b, mg))
        u = _halo_pcg(C_b, b, mg)
        squeeze = f.ndim == 2 and C.ndim == 3 and g.ndim == 2
        return u[0] if squeeze else u

    @jax.custom_vjp
    def solve(kappa_lu, f, g):
        return _impl(kappa_lu, f, g)

    def _fwd(kappa_lu, f, g):
        u = _impl(kappa_lu, f, g)
        return u, (kappa_lu, f, g, u)

    def _bwd(res, gbar):
        kappa_lu, f, g, u = res
        kl, ku = kappa_lu
        C = stencil_coefficients(grid, kl, ku)
        gb = gbar if gbar.ndim == 3 else gbar[None]
        C_b = C if C.ndim == 4 else C[None]
        B = max(C_b.shape[0], gb.shape[0])
        C_b = jnp.broadcast_to(C_b, (B,) + C_b.shape[1:])
        gb = jnp.broadcast_to(gb, (B, H, W))
        lam = _halo_pcg(C_b, gb, jnp.zeros_like(gb))
        if gbar.ndim == 2:
            lam = lam[0]
        return residual_vjp_manual(grid, kappa_lu, f, g, u, lam, C=C)

    solve.defvjp(_fwd, _bwd)
    return solve
