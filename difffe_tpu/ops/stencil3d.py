"""Structured-grid 3D operators: 7-point stencil form for box meshes.

For meshes from ``FEMesh.box`` (uniform grid, 6-tet Kuhn split per cube)
the P1 stiffness matrix is EXACTLY a **7-point stencil** on the node grid
— neighbors (0,0,±1), (0,±1,0), (±1,0,0) — for ANY per-tet isotropic κ.
This is the 3D analogue of the 2D 5-point reduction (ops/stencil.py) and
it is stronger than the 2D case needs to be: every Kuhn tet's local
stiffness has *identically zero* coupling on its face-diagonal and
main-diagonal vertex pairs (the 3D version of the right triangle's zero
hypotenuse coupling), so no cross-element cancellation is required.
Verified per-element and against random-κ global assembly in
tests/test_stencil3d.py.

Moreover each tet couples exactly one edge per axis, all with the same
weight ``w_a = h_b·h_c / (6·h_a)`` — so the three coefficient volumes are
fixed sums of zero-padded shifts of the per-cube (6,) κ array: ~12 pad/add
ops, no scatter at all.  K·u is then 7 shifted multiply-adds — pure
elementwise work XLA fuses into one pass, vmaps over scenario batches, and
shards over a DOF grid.  The unstructured gather/scatter and edge-ELL paths
(ops/assembly.py, ops/unstructured.py) remain for general tetrahedral
meshes; equality is tested.

3D is BEYOND the reference: its solver raises NotImplementedError for
dim>2 (/root/reference/diffhe/solver.py:62-67).

Layout: node grids are (..., nz+1, ny+1, nx+1) (z outer, x innermost —
matches ``FEMesh.box`` node numbering); per-tet κ is (..., n_elements)
flat in mesh order (cube-major, 6 tets interleaved) or already shaped
(..., nz, ny, nx, 6).  Offsets are indexed as::

    0: (0,0,0)  1: (0,0,+1)  2: (0,0,−1)  3: (0,+1,0)
    4: (0,−1,0) 5: (+1,0,0)  6: (−1,0,0)        (dz, dy, dx)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

OFFSETS3 = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
            (1, 0, 0), (-1, 0, 0))

# Which tets of the Kuhn split (FEMesh.box path order, mesh.py:246-255)
# contribute to the axis edge whose base vertex sits at cube-local offset
# (da, db) in the two transverse axes.  Derived from the per-tet local
# stiffness: each tet has exactly one x-, one y- and one z-edge coupling.
#   x-edges, key (dy, dz);  y-edges, key (dx, dz);  z-edges, key (dx, dy).
_X_TERMS = {(0, 0): (0, 1), (1, 0): (2,), (0, 1): (4,), (1, 1): (3, 5)}
_Y_TERMS = {(0, 0): (2, 3), (1, 0): (0,), (0, 1): (5,), (1, 1): (1, 4)}
_Z_TERMS = {(0, 0): (4, 5), (1, 0): (1,), (0, 1): (3,), (1, 1): (0, 2)}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredGrid3:
    """Static geometry of a uniform box mesh (nx × ny × nz cubes)."""

    nx: int = dataclasses.field(metadata=dict(static=True))
    ny: int = dataclasses.field(metadata=dict(static=True))
    nz: int = dataclasses.field(metadata=dict(static=True))
    hx: float = dataclasses.field(metadata=dict(static=True))
    hy: float = dataclasses.field(metadata=dict(static=True))
    hz: float = dataclasses.field(metadata=dict(static=True))

    @property
    def node_shape(self) -> Tuple[int, int, int]:
        return (self.nz + 1, self.ny + 1, self.nx + 1)

    @property
    def n_elements(self) -> int:
        return 6 * self.nx * self.ny * self.nz

    @classmethod
    def unit(cls, nx: int, ny: int, nz: int,
             x_range=(0.0, 1.0), y_range=(0.0, 1.0),
             z_range=(0.0, 1.0)) -> "StructuredGrid3":
        return cls(nx=nx, ny=ny, nz=nz,
                   hx=(x_range[1] - x_range[0]) / nx,
                   hy=(y_range[1] - y_range[0]) / ny,
                   hz=(z_range[1] - z_range[0]) / nz)


def kappa_to_cube(grid: StructuredGrid3, kappa: jax.Array) -> jax.Array:
    """(..., n_elements) flat mesh-order κ → (..., nz, ny, nx, 6)."""
    k = jnp.asarray(kappa)
    if k.shape[-1] == 6 and k.ndim >= 4:
        return k
    return k.reshape(k.shape[:-1] + (grid.nz, grid.ny, grid.nx, 6))


def _embed3(q: jax.Array, dz: int, dy: int, dx: int) -> jax.Array:
    """Place a (..., nz, ny, nx) per-cube field on the node grid at vertex
    offset (dz, dy, dx) ∈ {0,1}³, zero elsewhere (3D ops/stencil.py:_embed)."""
    pad = ([(0, 0)] * (q.ndim - 3)
           + [(dz, 1 - dz), (dy, 1 - dy), (dx, 1 - dx)])
    return jnp.pad(q, pad)


def _pad_axis(q: jax.Array, axis: int, lo: int, hi: int) -> jax.Array:
    pad = [(0, 0)] * q.ndim
    pad[axis] = (lo, hi)
    return jnp.pad(q, pad)


def edge_coefficients(grid: StructuredGrid3, kappa6: jax.Array):
    """The three edge-coefficient volumes (negative couplings).

    Returns (Cx, Cy, Cz) with
      Cx: (..., nz+1, ny+1, nx) — Cx[k,j,i] couples node (k,j,i)↔(k,j,i+1)
      Cy: (..., nz+1, ny, nx+1), Cz: (..., nz, ny+1, nx+1)
    Each is −w_a · Σ_{tets sharing the edge} κ_t with w_a = h_b·h_c/(6 h_a)
    (uniform across tets — verified numerically for anisotropic spacing).
    """
    k6 = kappa6
    wx = grid.hy * grid.hz / (6.0 * grid.hx)
    wy = grid.hx * grid.hz / (6.0 * grid.hy)
    wz = grid.hx * grid.hy / (6.0 * grid.hz)

    def accumulate(terms, w, trans_axes):
        # trans_axes: the two transverse (node-grid) axes to embed along,
        # as (axis_for_first_key_component, axis_for_second_key_component)
        # counted from the end of the cube array (..., nz, ny, nx).
        out = None
        for (da, db), tets in terms.items():
            s = k6[..., tets[0]]
            for t in tets[1:]:
                s = s + k6[..., t]
            s = _pad_axis(s, s.ndim + trans_axes[0], da, 1 - da)
            s = _pad_axis(s, s.ndim + trans_axes[1], db, 1 - db)
            out = s if out is None else out + s
        return -w * out

    # x-edges: keys (dy, dz) → embed along y (axis -2) and z (axis -3)
    Cx = accumulate(_X_TERMS, wx, (-2, -3))
    # y-edges: keys (dx, dz) → embed along x (axis -1) and z (axis -3)
    Cy = accumulate(_Y_TERMS, wy, (-1, -3))
    # z-edges: keys (dx, dy) → embed along x (axis -1) and y (axis -2)
    Cz = accumulate(_Z_TERMS, wz, (-1, -2))
    return Cx, Cy, Cz


def stencil3d_coefficients(grid: StructuredGrid3, kappa) -> jax.Array:
    """Assemble the 7 coefficient volumes C (..., 7, nz+1, ny+1, nx+1).

    Plane k holds the coupling from each node to its OFFSETS3[k] neighbor;
    the diagonal plane is −Σ (neighbor planes) — exact because every P1
    element matrix has zero row sums (constant nullspace), so the
    assembled rows do too.  Equality with dense assembly from
    local_stiffness_3d is regression-tested.
    """
    k6 = kappa_to_cube(grid, kappa)
    Cx, Cy, Cz = edge_coefficients(grid, k6)
    C1 = _pad_axis(Cx, Cx.ndim - 1, 0, 1)   # (0,0,+1)
    C2 = _pad_axis(Cx, Cx.ndim - 1, 1, 0)   # (0,0,−1)
    C3 = _pad_axis(Cy, Cy.ndim - 2, 0, 1)   # (0,+1,0)
    C4 = _pad_axis(Cy, Cy.ndim - 2, 1, 0)   # (0,−1,0)
    C5 = _pad_axis(Cz, Cz.ndim - 3, 0, 1)   # (+1,0,0)
    C6 = _pad_axis(Cz, Cz.ndim - 3, 1, 0)   # (−1,0,0)
    C0 = -(C1 + C2 + C3 + C4 + C5 + C6)
    return jnp.stack([C0, C1, C2, C3, C4, C5, C6], axis=-4)


def _shift3d(u: jax.Array, dz: int, dy: int, dx: int) -> jax.Array:
    """v[z,y,x] = u[z+dz, y+dy, x+dx] with zero fill (last three axes)."""
    for axis, d in ((-3, dz), (-2, dy), (-1, dx)):
        if d == 0:
            continue
        ax = u.ndim + axis
        sl = [slice(None)] * u.ndim
        if d > 0:
            sl[ax] = slice(d, None)
            u = _pad_axis(u[tuple(sl)], ax, 0, d)
        else:
            sl[ax] = slice(None, d)
            u = _pad_axis(u[tuple(sl)], ax, -d, 0)
    return u


def stencil3d_apply(C: jax.Array, u: jax.Array) -> jax.Array:
    """(K·u) on the node grid: Σ_k C[k] ⊙ shift(u, offset_k).

    C: (..., 7, nz+1, ny+1, nx+1); u: (..., nz+1, ny+1, nx+1).
    """
    out = C[..., 0, :, :, :] * u
    for k, (dz, dy, dx) in enumerate(OFFSETS3[1:], start=1):
        out = out + C[..., k, :, :, :] * _shift3d(u, dz, dy, dx)
    return out


# --------------------------------------------------------------------------
# BC-eliminated CG solve on the grid (Dirichlet on all six faces, as in
# FEMesh.box); custom VJP via the implicit function theorem.
# --------------------------------------------------------------------------

def boundary_mask_box(grid: StructuredGrid3, dtype=jnp.float32) -> jax.Array:
    """1 on boundary nodes, 0 inside — matches FEMesh.box's BC set."""
    nz1, ny1, nx1 = grid.node_shape
    m = jnp.zeros((nz1, ny1, nx1), dtype)
    m = m.at[0].set(1.0).at[-1].set(1.0)
    m = m.at[:, 0].set(1.0).at[:, -1].set(1.0)
    m = m.at[:, :, 0].set(1.0).at[:, :, -1].set(1.0)
    return m


# Kuhn tet local vertex offsets (dz, dy, dx), FEMesh.box path order.
_TET_VERTS = (
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),  # x then y
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),  # x then z
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),  # y then x
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),  # y then z
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),  # z then x
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),  # z then y
)


def _cube_slice(u: jax.Array, dz: int, dy: int, dx: int) -> jax.Array:
    """Per-cube view of a node-grid field at vertex offset (dz,dy,dx)."""
    nz1, ny1, nx1 = u.shape[-3:]
    return u[..., dz:dz + nz1 - 1, dy:dy + ny1 - 1, dx:dx + nx1 - 1]


def load_box(grid: StructuredGrid3, f: jax.Array) -> jax.Array:
    """Centroid-rule load on the node grid (matches assemble_load's
    p1_tet branch: F_p += V/4 · mean(f over the tet), V = h³/6)."""
    v4 = (grid.hx * grid.hy * grid.hz / 6.0) / 4.0
    F = jnp.zeros_like(f)
    for verts in _TET_VERTS:
        fm = sum(_cube_slice(f, *v) for v in verts) / 4.0
        contrib = v4 * fm
        for (dz, dy, dx) in verts:
            F = F.at[..., dz:dz + grid.nz, dy:dy + grid.ny,
                     dx:dx + grid.nx].add(contrib)
    return F


def stencil3d_kappa_grad(grid: StructuredGrid3, lam: jax.Array,
                         w: jax.Array) -> jax.Array:
    """∂(λᵀ K(κ) w)/∂κ per tet, closed form — no autodiff tape.

    Each tet's unit stiffness is the sum of its three axis-edge matrices
    (single coupling −w_a, zero row sums), so its κ-gradient is
    Σ_axes w_a (λ_a−λ_b)(w_a−w_b) over its one edge per axis.  Returns
    (..., nz, ny, nx, 6); reshape to (..., ne) for flat mesh order.
    """
    wx = grid.hy * grid.hz / (6.0 * grid.hx)
    wy = grid.hx * grid.hz / (6.0 * grid.hy)
    wz = grid.hx * grid.hy / (6.0 * grid.hz)
    # edge-difference fields
    dLx = lam[..., :, :, 1:] - lam[..., :, :, :-1]
    dWx = w[..., :, :, 1:] - w[..., :, :, :-1]
    dLy = lam[..., :, 1:, :] - lam[..., :, :-1, :]
    dWy = w[..., :, 1:, :] - w[..., :, :-1, :]
    dLz = lam[..., 1:, :, :] - lam[..., :-1, :, :]
    dWz = w[..., 1:, :, :] - w[..., :-1, :, :]
    Ex, Ey, Ez = dLx * dWx, dLy * dWy, dLz * dWz

    # invert the edge→tet tables: per tet, its (dy,dz)/(dx,dz)/(dx,dy) base
    def base_of(terms, t):
        for key, tets in terms.items():
            if t in tets:
                return key
        raise AssertionError(t)

    nz, ny, nx = grid.nz, grid.ny, grid.nx
    gs = []
    for t in range(6):
        (xy, xz) = base_of(_X_TERMS, t)
        (ydx, ydz) = base_of(_Y_TERMS, t)
        (zdx, zdy) = base_of(_Z_TERMS, t)
        g = (wx * Ex[..., xz:xz + nz, xy:xy + ny, :]
             + wy * Ey[..., ydz:ydz + nz, :, ydx:ydx + nx]
             + wz * Ez[..., :, zdy:zdy + ny, zdx:zdx + nx])
        gs.append(g)
    return jnp.stack(gs, axis=-1)


def _reduce_to(x: jax.Array, shape) -> jax.Array:
    extra = x.ndim - len(shape)
    if extra > 0:
        x = x.sum(axis=tuple(range(extra)))
    return x


def residual_vjp_manual_3d(grid: StructuredGrid3, kappa, f, g, u, lam,
                           C: Optional[jax.Array] = None):
    """Cotangents of the IFT residual map, closed form (2D:
    ops/stencil.py:residual_vjp_manual, same derivation with the 3D
    κ-gradient above)."""
    m = boundary_mask_box(grid, lam.dtype)
    p = 1.0 - m
    pl_ = p * lam
    w = m * g + p * u
    gk6 = stencil3d_kappa_grad(grid, pl_, w)
    if C is None:
        C = stencil3d_coefficients(grid, kappa)
    grad_f = load_box(grid, pl_)
    grad_g = m * (lam - stencil3d_apply(C, pl_))
    gk = -gk6
    if jnp.asarray(kappa).shape[-1] != 6 or jnp.asarray(kappa).ndim < 4:
        gk = gk.reshape(gk.shape[:-4] + (grid.n_elements,))
    return (_reduce_to(gk, jnp.asarray(kappa).shape),
            _reduce_to(grad_f, f.shape), _reduce_to(grad_g, g.shape))


def _operator(C, m, v):
    p = 1.0 - m
    return m * v + p * stencil3d_apply(C, p * v)


def _pcg_box(C, m, b, Minv, x0, tol, maxiter):
    from .pcg import pcg
    return pcg(lambda v: _operator(C, m, v), b, lambda r: Minv * r, x0,
               tol, maxiter)


def _solve_impl_3d(grid, kappa, f, g, tol, maxiter):
    """Shifted form u = m·g + A⁻¹[p·(F − K(m·g))] through the recursive
    ``apply_inv_3d`` primitive (identical Krylov iterates; see the 2D
    note, ops/stencil.py:_solve_impl) — makes the custom-vjp residuals
    reverse-differentiable for second-order autodiff."""
    C = stencil3d_coefficients(grid, kappa)
    m = boundary_mask_box(grid, f.dtype)
    p = 1.0 - m
    F = load_box(grid, f)
    mg = m * g
    rhs = p * (F - stencil3d_apply(C, mg))
    return mg + apply_inv_3d(grid, kappa, rhs, tol, maxiter)


@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5))
def solve_poisson_structured_3d(grid: StructuredGrid3, kappa, f: jax.Array,
                                g: jax.Array, tol: float = 0.0,
                                maxiter: Optional[int] = None) -> jax.Array:
    """Solve −∇·(κ∇u)=f on the box grid, Dirichlet boundary = g.

    kappa: per-tet field, flat (..., 6·nx·ny·nz) in FEMesh.box element
    order or shaped (..., nz, ny, nx, 6); f, g: node grids
    (..., nz+1, ny+1, nx+1).  Returns u on the node grid.  Differentiable
    wrt κ, f, g via one adjoint CG solve (IFT), like ops/stencil.py.
    """
    return _solve_impl_3d(grid, kappa, f, g, tol, maxiter)


# --------------------------------------------------------------------------
# Batch-minor (structure-of-arrays) batched solve.
#
# The scenario batch is the TRAILING axis of every CG state array, so each
# stencil shift moves whole contiguous rows of scenarios and the per-
# scenario dots reduce over the leading grid axes.  The public API still
# takes batch-leading (B, …) arrays — layout is an implementation detail:
# inputs are moved once per solve, state stays batch-minor through the
# whole CG while_loop.  Which layout is faster at which B is for the
# benchmark to decide (ROADMAP).
# --------------------------------------------------------------------------

def _bm_embed(q, dz, dy, dx):
    """(nz, ny, nx, B) per-cube → (nz+1, ny+1, nx+1, B) node grid."""
    return jnp.pad(q, ((dz, 1 - dz), (dy, 1 - dy), (dx, 1 - dx), (0, 0)))


def _bm_coefficients(grid: StructuredGrid3, k6bm: jax.Array) -> jax.Array:
    """k6bm: (nz, ny, nx, 6, B) → C (7, nz+1, ny+1, nx+1, B)."""
    wx = grid.hy * grid.hz / (6.0 * grid.hx)
    wy = grid.hx * grid.hz / (6.0 * grid.hy)
    wz = grid.hx * grid.hy / (6.0 * grid.hz)

    def accumulate(terms, w, ax_a, ax_b):
        out = None
        for (da, db), tets in terms.items():
            s = k6bm[..., tets[0], :]
            for t in tets[1:]:
                s = s + k6bm[..., t, :]
            pad = [(0, 0)] * 4
            pad[ax_a] = (da, 1 - da)
            pad[ax_b] = (db, 1 - db)
            s = jnp.pad(s, pad)
            out = s if out is None else out + s
        return -w * out

    # x-edges key (dy, dz): embed along y (axis 1) and z (axis 0); etc.
    Cx = accumulate(_X_TERMS, wx, 1, 0)   # (nz+1, ny+1, nx, B)
    Cy = accumulate(_Y_TERMS, wy, 2, 0)   # (nz+1, ny, nx+1, B)
    Cz = accumulate(_Z_TERMS, wz, 2, 1)   # (nz, ny+1, nx+1, B)
    z4 = ((0, 0),) * 4

    def pad_at(q, axis, lo, hi):
        pad = list(z4)
        pad[axis] = (lo, hi)
        return jnp.pad(q, pad)

    C1 = pad_at(Cx, 2, 0, 1)
    C2 = pad_at(Cx, 2, 1, 0)
    C3 = pad_at(Cy, 1, 0, 1)
    C4 = pad_at(Cy, 1, 1, 0)
    C5 = pad_at(Cz, 0, 0, 1)
    C6 = pad_at(Cz, 0, 1, 0)
    C0 = -(C1 + C2 + C3 + C4 + C5 + C6)
    return jnp.stack([C0, C1, C2, C3, C4, C5, C6], axis=0)


def _bm_shift(u, dz, dy, dx):
    """(nz1, ny1, nx1, B): v[z,y,x] = u[z+dz, y+dy, x+dx], zero fill."""
    for axis, d in ((0, dz), (1, dy), (2, dx)):
        if d == 0:
            continue
        sl = [slice(None)] * 4
        pad = [(0, 0)] * 4
        if d > 0:
            sl[axis] = slice(d, None)
            pad[axis] = (0, d)
        else:
            sl[axis] = slice(None, d)
            pad[axis] = (-d, 0)
        u = jnp.pad(u[tuple(sl)], pad)
    return u


def _bm_apply(C, u):
    out = C[0] * u
    for k, (dz, dy, dx) in enumerate(OFFSETS3[1:], start=1):
        out = out + C[k] * _bm_shift(u, dz, dy, dx)
    return out


def _bm_load(grid: StructuredGrid3, f: jax.Array) -> jax.Array:
    v4 = (grid.hx * grid.hy * grid.hz / 6.0) / 4.0
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    F = jnp.zeros_like(f)

    def cube(u, dz, dy, dx):
        return u[dz:dz + nz, dy:dy + ny, dx:dx + nx, :]

    for verts in _TET_VERTS:
        fm = sum(cube(f, *v) for v in verts) / 4.0
        contrib = v4 * fm
        for (dz, dy, dx) in verts:
            F = F.at[dz:dz + nz, dy:dy + ny, dx:dx + nx, :].add(contrib)
    return F


def _bm_kappa_grad(grid: StructuredGrid3, lam, w):
    """(nz1,ny1,nx1,B) λ, w → per-tet gradient (nz, ny, nx, 6, B)."""
    wx = grid.hy * grid.hz / (6.0 * grid.hx)
    wy = grid.hx * grid.hz / (6.0 * grid.hy)
    wz = grid.hx * grid.hy / (6.0 * grid.hz)
    Ex = (lam[:, :, 1:] - lam[:, :, :-1]) * (w[:, :, 1:] - w[:, :, :-1])
    Ey = (lam[:, 1:] - lam[:, :-1]) * (w[:, 1:] - w[:, :-1])
    Ez = (lam[1:] - lam[:-1]) * (w[1:] - w[:-1])

    def base_of(terms, t):
        for key, tets in terms.items():
            if t in tets:
                return key
        raise AssertionError(t)

    nz, ny, nx = grid.nz, grid.ny, grid.nx
    gs = []
    for t in range(6):
        (xy, xz) = base_of(_X_TERMS, t)
        (ydx, ydz) = base_of(_Y_TERMS, t)
        (zdx, zdy) = base_of(_Z_TERMS, t)
        g = (wx * Ex[xz:xz + nz, xy:xy + ny, :, :]
             + wy * Ey[ydz:ydz + nz, :, ydx:ydx + nx, :]
             + wz * Ez[:, zdy:zdy + ny, zdx:zdx + nx, :])
        gs.append(g)
    return jnp.stack(gs, axis=3)


def _bm_dot(u, v):
    """Per-scenario inner product for batch-minor state: reduce the grid
    axes, keep the trailing batch lane — so the batched solve's CG iterates
    match the vmapped batch-leading solve exactly (per-scenario α/β)."""
    return jnp.sum(u * v, axis=(0, 1, 2), keepdims=True)


def _bm_solve(grid, C, m, f, g, tol, maxiter, x0=None):
    p = 1.0 - m
    F = _bm_load(grid, f)
    b = m * g + p * (F - _bm_apply(C, m * g))
    diagA = m + p * C[0]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    if x0 is None:
        x0 = jnp.broadcast_to(m * g, b.shape)
    from .pcg import pcg
    return pcg(lambda v: m * v + p * _bm_apply(C, p * v), b,
               lambda r: Minv * r, x0, tol, maxiter, dot=_bm_dot)


def _bm_prep(grid, kappa, f, g, dtype):
    """Batch-leading user arrays → batch-minor internals (one transpose)."""
    kappa = jnp.asarray(kappa)
    f = jnp.asarray(f)
    # Cheap API-boundary shape checks: batched entry points take
    # batch-LEADING arrays — κ (B, n_elements) flat or (B, nz, ny, nx, 6),
    # f (B,) + node grid.  Unbatched or mis-shaped inputs would otherwise
    # fail deep inside pad/reshape with confusing errors (advisor r3).
    if not (kappa.ndim == 2 or (kappa.ndim == 5 and kappa.shape[-1] == 6)):
        raise ValueError(
            f"batched 3D solve expects kappa (B, {grid.n_elements}) flat or "
            f"(B, nz, ny, nx, 6); got shape {kappa.shape}")
    if f.ndim != 4:
        raise ValueError(
            f"batched 3D solve expects f (B,) + node grid "
            f"{grid.node_shape}; got shape {f.shape}")
    k6 = kappa_to_cube(grid, kappa)                 # (B, nz, ny, nx, 6)
    k6bm = jnp.moveaxis(k6, 0, -1)                  # (nz, ny, nx, 6, B)
    fbm = jnp.moveaxis(f, 0, -1)
    gbm = jnp.moveaxis(jnp.broadcast_to(g, f.shape), 0, -1)
    C = _bm_coefficients(grid, k6bm)
    m = boundary_mask_box(grid, dtype)[..., None]
    return C, m, fbm, gbm, k6bm


@partial(jax.custom_vjp, nondiff_argnums=(0, 3, 4))
def _apply_inv_bm(grid: StructuredGrid3, k6bm, b, tol: float,
                  maxiter: Optional[int]):
    """Batch-minor x = A⁻¹b primitive (state (nz+1, ny+1, nx+1, B),
    κ (nz, ny, nx, 6, B)); recursive VJP like :func:`apply_inv_3d`."""
    C = _bm_coefficients(grid, k6bm)
    m = boundary_mask_box(grid, b.dtype)[..., None]
    p = 1.0 - m
    diagA = m + p * C[0]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    maxit = maxiter
    if maxit is None:
        maxit = (grid.nx + 1) * (grid.ny + 1) * (grid.nz + 1)
    from .pcg import pcg
    return pcg(lambda v: m * v + p * _bm_apply(C, p * v), b,
               lambda r: Minv * r, jnp.zeros_like(b), tol, maxit,
               dot=_bm_dot)


def _aib_fwd(grid, k6bm, b, tol, maxiter):
    x = _apply_inv_bm(grid, k6bm, b, tol, maxiter)
    return x, (k6bm, x)


def _aib_bwd(grid, tol, maxiter, res, xbar):
    k6bm, x = res
    lam = _apply_inv_bm(grid, k6bm, xbar, tol, maxiter)
    m = boundary_mask_box(grid, x.dtype)[..., None]
    p = 1.0 - m
    gk6 = -_bm_kappa_grad(grid, p * lam, p * x)     # (nz, ny, nx, 6, B)
    return (gk6, lam)


_apply_inv_bm.defvjp(_aib_fwd, _aib_bwd)


def _solve_impl_3d_batched(grid, kappa, f, g, tol, maxiter):
    C, m, fbm, gbm, k6bm = _bm_prep(grid, kappa, f, g, f.dtype)
    p = 1.0 - m
    F = _bm_load(grid, fbm)
    mg = m * gbm
    rhs = p * (F - _bm_apply(C, mg))
    u = mg + _apply_inv_bm(grid, k6bm, rhs, tol, maxiter)
    return jnp.moveaxis(u, -1, 0)


@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5))
def solve_poisson_structured_3d_batched(grid: StructuredGrid3, kappa,
                                        f: jax.Array, g: jax.Array,
                                        tol: float = 0.0,
                                        maxiter: Optional[int] = None):
    """Batched box solve with batch-minor device layout (see module note).

    kappa: (B, 6·nx·ny·nz) flat or (B, nz, ny, nx, 6); f: (B,) + node
    grid; g: node grid or (B,) + node grid.  Returns u (B,) + node grid.
    Semantically identical to vmapping :func:`solve_poisson_structured_3d`
    (tested).
    """
    return _solve_impl_3d_batched(grid, kappa, f, g, tol, maxiter)


def _fwd_b(grid, kappa, f, g, tol, maxiter):
    u = _solve_impl_3d_batched(grid, kappa, f, g, tol, maxiter)
    return u, (kappa, f, g, u)


def _bwd_b(grid, tol, maxiter, res, gbar):
    kappa, f, g, u = res
    C, m, fbm, gbm, k6bm = _bm_prep(grid, kappa, f, g, f.dtype)
    p = 1.0 - m
    gbm_bar = jnp.moveaxis(gbar, 0, -1)
    # adjoint through the recursive batch-minor inverse primitive —
    # reverse-differentiable for second-order autodiff
    lam = _apply_inv_bm(grid, k6bm, gbm_bar, tol, maxiter)
    pl_ = p * lam
    ubm = jnp.moveaxis(u, 0, -1)
    w = m * gbm + p * ubm
    gk6 = -_bm_kappa_grad(grid, pl_, w)             # (nz, ny, nx, 6, B)
    gk = jnp.moveaxis(gk6, -1, 0)
    ka = jnp.asarray(kappa)
    if not (ka.ndim >= 5 and ka.shape[-1] == 6):
        gk = gk.reshape((gk.shape[0], grid.n_elements))
    grad_f = jnp.moveaxis(_bm_load(grid, pl_), -1, 0)
    grad_g = jnp.moveaxis(m * (lam - _bm_apply(C, pl_)), -1, 0)
    return (_reduce_to(gk, ka.shape), _reduce_to(grad_f, f.shape),
            _reduce_to(grad_g, jnp.asarray(g).shape))


solve_poisson_structured_3d_batched.defvjp(_fwd_b, _bwd_b)


def kappa_mse_grad_step_3d(grid: StructuredGrid3, kappa, f, g, u_data,
                           iters: int, warm_state=None,
                           return_state: bool = False):
    """One κ-inversion gradient step: loss = mean((u(κ) − u_data)²),
    returns (loss, ∂loss/∂κ) — with optional CG **warm starts**.

    The 3D analogue of the 2D warm-start lever
    (ops/stencil.kappa_mse_grad_step_2d): in an SGD loop κ moves O(lr) per step, so threading
    the previous step's (u, λ) through the scan as the next step's CG
    initial guesses buys the same converged loss at a fraction of the
    per-step iterations.  Pass
    ``warm_state=<previous step's returned state>`` and
    ``return_state=True`` to receive the new state (an opaque
    batch-minor pair — thread it, don't consume it).

    Gradients are computed by the same IFT adjoint as the custom_vjp
    solve (one adjoint CG on the self-adjoint operator + the closed-form
    κ contraction) — this is a step FUNCTION (loss, grad), not a
    differentiable primitive, exactly like the 1D/2D grad steps.
    Batched: kappa (B, ne) flat or (B, nz, ny, nx, 6); f, u_data
    (B,) + node grid; g a node grid.  Batch-minor internally.
    """
    C, m, fbm, gbm, _ = _bm_prep(grid, kappa, f, g, f.dtype)
    p = 1.0 - m
    if warm_state is None:
        x0 = l0 = None
    else:
        x0, l0 = warm_state  # opaque batch-minor state — thread, don't touch
    ubm = _bm_solve(grid, C, m, fbm, gbm, 0.0, iters, x0=x0)
    udbm = jnp.moveaxis(u_data, 0, -1)
    diff = ubm - udbm
    numel = diff.size
    loss = jnp.sum(diff * diff) / numel
    rbar = (2.0 / numel) * diff
    diagA = m + p * C[0]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    from .pcg import pcg
    lam = pcg(lambda v: m * v + p * _bm_apply(C, p * v), rbar,
              lambda r: Minv * r,
              l0 if l0 is not None else jnp.zeros_like(rbar),
              0.0, iters, dot=_bm_dot)
    w = m * gbm + p * ubm
    gk6 = -_bm_kappa_grad(grid, p * lam, w)
    gk = jnp.moveaxis(gk6, -1, 0)
    ka = jnp.asarray(kappa)
    if not (ka.ndim >= 5 and ka.shape[-1] == 6):
        gk = gk.reshape((gk.shape[0], grid.n_elements))
    if return_state:
        # state stays batch-minor: it is an OPAQUE carry for the next
        # step's warm start (no per-step re-transpose) — don't consume it
        # as node grids.
        return loss, gk, (ubm, lam)
    return loss, gk


def choose_3d_path(grid: StructuredGrid3, batch: int):
    """Pick the batched 3D solve layout: batch-minor at B ≥ 128, the
    per-scenario vmap below.  Both give the same iterates (tested); the
    threshold is a layout rule for the benchmark to re-decide (ROADMAP).
    Returns a callable ``(kappaB, fB, g, tol, maxiter) -> uB`` with
    batch-leading arrays.
    """
    if batch >= 128:
        return partial(solve_poisson_structured_3d_batched, grid)

    def vmapped(kappa, f, g, tol=0.0, maxiter=None):
        return jax.vmap(lambda k, ff: solve_poisson_structured_3d(
            grid, k, ff, g, tol, maxiter))(kappa, f)

    return vmapped


@partial(jax.custom_vjp, nondiff_argnums=(0, 3, 4))
def apply_inv_3d(grid: StructuredGrid3, kappa, b: jax.Array,
                 tol: float = 0.0,
                 maxiter: Optional[int] = None) -> jax.Array:
    """x = A(κ)⁻¹ b for the BC-eliminated box operator A = m + p·K(κ)·p.

    Differentiable linear-solve primitive (2D analogue:
    ops/stencil.py:apply_inv): its VJP solves A λ = x̄ with this same
    primitive, so reverse-mode composes to any order — second-order
    autodiff (Newton/Hessian) through ``solve_poisson`` works on the
    structured 3D route."""
    C = stencil3d_coefficients(grid, kappa)
    m = boundary_mask_box(grid, b.dtype)
    p = 1.0 - m
    diagA = m + p * C[..., 0, :, :, :]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    maxit = maxiter
    if maxit is None:
        maxit = (grid.nx + 1) * (grid.ny + 1) * (grid.nz + 1)
    return _pcg_box(C, m, b, Minv, jnp.zeros_like(b), tol, maxit)


def _ai3_fwd(grid, kappa, b, tol, maxiter):
    x = apply_inv_3d(grid, kappa, b, tol, maxiter)
    return x, (kappa, x)


def _ai3_bwd(grid, tol, maxiter, res, xbar):
    kappa, x = res
    lam = apply_inv_3d(grid, kappa, xbar, tol, maxiter)
    m = boundary_mask_box(grid, x.dtype)
    p = 1.0 - m
    gk6 = -stencil3d_kappa_grad(grid, p * lam, p * x)
    ka = jnp.asarray(kappa)
    if ka.shape[-1] != 6 or ka.ndim < 4:
        gk6 = gk6.reshape(gk6.shape[:-4] + (grid.n_elements,))
    return (_reduce_to(gk6, ka.shape), _reduce_to(lam, jnp.shape(x)))


apply_inv_3d.defvjp(_ai3_fwd, _ai3_bwd)


def _fwd(grid, kappa, f, g, tol, maxiter):
    u = _solve_impl_3d(grid, kappa, f, g, tol, maxiter)
    return u, (kappa, f, g, u)


def _bwd(grid, tol, maxiter, res, gbar):
    kappa, f, g, u = res
    # adjoint via the differentiable-inverse primitive + closed-form
    # residual VJP — reverse-differentiable to any order (2D: _bwd above)
    lam = apply_inv_3d(grid, kappa, gbar, tol, maxiter)
    return residual_vjp_manual_3d(grid, kappa, f, g, u, lam)


solve_poisson_structured_3d.defvjp(_fwd, _bwd)
