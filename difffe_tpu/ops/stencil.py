"""Structured-grid 2D operators: stencil-form stiffness for rectangle meshes.

For meshes from ``FEMesh.rectangle`` (uniform grid, lower-left triangle
split) the P1 stiffness matrix is a **7-point stencil** on the node grid —
neighbors (0,±1), (±1,0), (+1,−1), (−1,+1) — with coefficients that are
sums of adjacent-triangle local entries.  This module assembles those
coefficient planes with shifted slice-adds (no scatter at all) and applies
K·u as seven shifted multiply-adds: pure elementwise work that XLA fuses
into a single pass, vmaps over scenario batches, and shards over a DOF
grid.

This is the 2D production path (BASELINE configs 4-5): the unstructured
gather/scatter path (ops/assembly.py:element_apply_2d) remains for general
meshes; equality between the two is tested.

Offsets are indexed as::

    0: ( 0,  0)   1: ( 0, +1)   2: ( 0, −1)   3: (+1, 0)
    4: (−1,  0)   5: (+1, −1)   6: (−1, +1)      (row=y, col=x)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

OFFSETS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, -1), (-1, 1))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredGrid:
    """Static geometry of a uniform rectangle mesh (nx × ny quads)."""

    nx: int = dataclasses.field(metadata=dict(static=True))
    ny: int = dataclasses.field(metadata=dict(static=True))
    hx: float = dataclasses.field(metadata=dict(static=True))
    hy: float = dataclasses.field(metadata=dict(static=True))

    @property
    def node_shape(self) -> Tuple[int, int]:
        return (self.ny + 1, self.nx + 1)

    @classmethod
    def unit(cls, nx: int, ny: int,
             x_range=(0.0, 1.0), y_range=(0.0, 1.0)) -> "StructuredGrid":
        return cls(nx=nx, ny=ny,
                   hx=(x_range[1] - x_range[0]) / nx,
                   hy=(y_range[1] - y_range[0]) / ny)


def kappa_lu_from_elements(grid: StructuredGrid, ke: jax.Array):
    """Flat per-element κ (..., n_elements) in ``FEMesh.rectangle`` order
    (quads raveled row-major, [lower, upper] interleaved per quad —
    mesh.py:rectangle) → per-triangle plane fields
    ``(κ_lower (..., ny, nx), κ_upper (..., ny, nx))``.

    Differentiable (pure strided reshape), so facade routes composing this
    with :func:`solve_poisson_structured` propagate κ cotangents back to
    the flat element layout untouched."""
    ke = jnp.asarray(ke)
    k2 = ke.reshape(ke.shape[:-1] + (grid.ny, grid.nx, 2))
    return k2[..., 0], k2[..., 1]


def local_blocks(grid: StructuredGrid, kappa_lower, kappa_upper):
    """Local 3×3 stiffness blocks for all lower/upper triangles.

    kappa_lower/upper: (..., ny, nx) per-triangle κ.  Closed-form P1 blocks
    on right triangles (same algebra as ops/assembly.py:local_stiffness_2d,
    specialized to the uniform grid — verified equal in tests):

      K_low = κ/(2 hx hy)·[[hx²+hy², −hy², −hx²], [−hy², hy², 0], [−hx², 0, hx²]]
      K_up  = κ/(2 hx hy)·[[hx², −hx², 0], [−hx², hx²+hy², −hy²], [0, −hy², hy²]]

    with vertex order lower=(a,b,d), upper=(b,c,d); a=(i,j), b=(i,j+1),
    c=(i+1,j+1), d=(i+1,j).
    """
    hx2, hy2 = grid.hx ** 2, grid.hy ** 2
    s = 1.0 / (2.0 * grid.hx * grid.hy)
    kl = jnp.asarray(kappa_lower)
    ku = jnp.asarray(kappa_upper)
    Ml = jnp.array([[hx2 + hy2, -hy2, -hx2],
                    [-hy2, hy2, 0.0],
                    [-hx2, 0.0, hx2]], dtype=kl.dtype) * s
    Mu = jnp.array([[hx2, -hx2, 0.0],
                    [-hx2, hx2 + hy2, -hy2],
                    [0.0, -hy2, hy2]], dtype=ku.dtype) * s
    return kl[..., None, None] * Ml, ku[..., None, None] * Mu


def _stencil_coefficients_reference(grid: StructuredGrid,
                                    kappa_lower, kappa_upper):
    """Generic plane assembly from the full local blocks — 18 slice-adds.

    Kept as the oracle for :func:`stencil_coefficients` (tested equal); the
    production closed form below is ~6× fewer XLA ops, which matters because
    coefficient assembly sits on the hot gradient path (re-run per solve).
    """
    Kl, Ku = local_blocks(grid, kappa_lower, kappa_upper)
    lead = Kl.shape[:-4]
    ny, nx = grid.ny, grid.nx
    shape = lead + (7, ny + 1, nx + 1)
    C = jnp.zeros(shape, dtype=Kl.dtype)

    # vertex grid positions (row, col) relative to quad (i, j):
    # lower tri (a,b,d): a=(i,j)   b=(i,j+1)  d=(i+1,j)
    # upper tri (b,c,d): b=(i,j+1) c=(i+1,j+1) d=(i+1,j)
    LOWER = ((0, 0), (0, 1), (1, 0))
    UPPER = ((0, 1), (1, 1), (1, 0))
    OFF_IDX = {off: k for k, off in enumerate(OFFSETS)}

    def add(C, K, verts):
        for p, (pr, pc) in enumerate(verts):
            for q, (qr, qc) in enumerate(verts):
                off = (qr - pr, qc - pc)
                k = OFF_IDX[off]
                # contribution K[..., i, j, p, q] lands at node (i+pr, j+pc)
                C = C.at[..., k, pr:pr + ny, pc:pc + nx].add(K[..., p, q])
        return C

    C = add(C, Kl, LOWER)
    C = add(C, Ku, UPPER)
    return C


def _embed(q: jax.Array, pr: int, pc: int) -> jax.Array:
    """Place a (..., ny, nx) per-quad field on the (..., ny+1, nx+1) node
    grid at vertex offset (pr, pc) ∈ {0,1}², zero elsewhere."""
    pad = [(0, 0)] * (q.ndim - 2) + [(pr, 1 - pr), (pc, 1 - pc)]
    return jnp.pad(q, pad)


def stencil_coefficients(grid: StructuredGrid, kappa_lower, kappa_upper):
    """Assemble the 7 coefficient planes C (..., 7, ny+1, nx+1).

    Closed form: because the local blocks are κ·(constant matrix)
    (:func:`local_blocks`), each plane is a fixed linear combination of the
    two per-triangle κ fields padded to the node grid — ~10 pad/add/scale
    ops instead of 18 slice-adds into a scatter target.  Planes 5/6 (the
    (±1, ∓1) cross-diagonal neighbors along the triangulation diagonal) are
    **identically zero** for isotropic κ on this lower-left split — the
    classic 5-point equivalence — kept as explicit zero planes so every
    consumer shares one layout.  Equality with the generic 18-term assembly
    is regression-tested (tests/test_stencil.py).
    """
    kl = jnp.asarray(kappa_lower)
    ku = jnp.asarray(kappa_upper)
    kl, ku = jnp.broadcast_arrays(kl, ku)
    hx2, hy2 = grid.hx ** 2, grid.hy ** 2
    s = 1.0 / (2.0 * grid.hx * grid.hy)
    l00, l01, l10 = _embed(kl, 0, 0), _embed(kl, 0, 1), _embed(kl, 1, 0)
    u01, u10, u11 = _embed(ku, 0, 1), _embed(ku, 1, 0), _embed(ku, 1, 1)
    C0 = s * ((hx2 + hy2) * (l00 + u11) + hy2 * (l01 + u10)
              + hx2 * (l10 + u01))
    C1 = (-s * hy2) * (l00 + u10)      # ( 0, +1)
    C2 = (-s * hy2) * (l01 + u11)      # ( 0, −1)
    C3 = (-s * hx2) * (l00 + u01)      # (+1,  0)
    C4 = (-s * hx2) * (l10 + u11)      # (−1,  0)
    Z = jnp.zeros_like(C0)             # (+1, −1), (−1, +1)
    return jnp.stack([C0, C1, C2, C3, C4, Z, Z], axis=-3)


def _shift2d(u, dr, dc):
    """v[r, c] = u[r+dr, c+dc] with zero fill (last two axes)."""
    if dr > 0:
        u = jnp.pad(u[..., dr:, :], [(0, 0)] * (u.ndim - 2) + [(0, dr), (0, 0)])
    elif dr < 0:
        u = jnp.pad(u[..., :dr, :], [(0, 0)] * (u.ndim - 2) + [(-dr, 0), (0, 0)])
    if dc > 0:
        u = jnp.pad(u[..., :, dc:], [(0, 0)] * (u.ndim - 2) + [(0, 0), (0, dc)])
    elif dc < 0:
        u = jnp.pad(u[..., :, :dc], [(0, 0)] * (u.ndim - 2) + [(0, 0), (-dc, 0)])
    return u


def stencil_apply(C: jax.Array, u: jax.Array) -> jax.Array:
    """(K·u) on the node grid: Σ_k C[k] ⊙ shift(u, offset_k).

    C: (..., 7, ny+1, nx+1); u: (..., ny+1, nx+1).
    """
    out = C[..., 0, :, :] * u
    for k, (dr, dc) in enumerate(OFFSETS[1:], start=1):
        out = out + C[..., k, :, :] * _shift2d(u, dr, dc)
    return out


# --------------------------------------------------------------------------
# BC-eliminated CG solve on the grid (boundary = Dirichlet, as in
# FEMesh.rectangle); custom VJP via the implicit function theorem.
# --------------------------------------------------------------------------

def boundary_mask_grid(grid: StructuredGrid, dtype=jnp.float32) -> jax.Array:
    """1 on boundary nodes, 0 inside — matches FEMesh.rectangle's BC set."""
    ny1, nx1 = grid.node_shape
    m = jnp.zeros((ny1, nx1), dtype)
    m = m.at[0, :].set(1.0).at[-1, :].set(1.0)
    m = m.at[:, 0].set(1.0).at[:, -1].set(1.0)
    return m


def load_grid(grid: StructuredGrid, f: jax.Array) -> jax.Array:
    """Centroid-rule load on the node grid (matches assemble_load for the
    rectangle mesh — each node collects area/3·centroid-mean from its
    adjacent triangles)."""
    area3 = (0.5 * grid.hx * grid.hy) / 3.0
    fl = (f[..., :-1, :-1] + f[..., :-1, 1:] + f[..., 1:, :-1]) / 3.0  # lower
    fu = (f[..., :-1, 1:] + f[..., 1:, 1:] + f[..., 1:, :-1]) / 3.0   # upper
    F = jnp.zeros_like(f)
    # lower (a,b,d) = (i,j),(i,j+1),(i+1,j)
    F = F.at[..., :-1, :-1].add(area3 * fl)
    F = F.at[..., :-1, 1:].add(area3 * fl)
    F = F.at[..., 1:, :-1].add(area3 * fl)
    # upper (b,c,d) = (i,j+1),(i+1,j+1),(i+1,j)
    F = F.at[..., :-1, 1:].add(area3 * fu)
    F = F.at[..., 1:, 1:].add(area3 * fu)
    F = F.at[..., 1:, :-1].add(area3 * fu)
    return F


def stencil_kappa_grad(grid: StructuredGrid, lam: jax.Array, w: jax.Array):
    """∂(λᵀ K(κ) w)/∂κ per triangle, closed form — no autodiff tape.

    K = Σ_quads κ_low·K_low + κ_up·K_up (local_blocks), so the gradient for
    each triangle is λ|_tri ᵀ · K_unit · w|_tri: nine fused multiply-adds of
    shifted node-grid slices.  Returns (g_lower, g_upper), (..., ny, nx).
    """
    hx2, hy2 = grid.hx ** 2, grid.hy ** 2
    s = 1.0 / (2.0 * grid.hx * grid.hy)
    la, lb = lam[..., :-1, :-1], lam[..., :-1, 1:]
    lc, ld = lam[..., 1:, 1:], lam[..., 1:, :-1]
    wa, wb = w[..., :-1, :-1], w[..., :-1, 1:]
    wc, wd = w[..., 1:, 1:], w[..., 1:, :-1]
    # vertex order lower=(a,b,d), upper=(b,c,d); unit blocks in local_blocks
    g_low = s * (la * ((hx2 + hy2) * wa - hy2 * wb - hx2 * wd)
                 + lb * (hy2 * (wb - wa))
                 + ld * (hx2 * (wd - wa)))
    g_up = s * (lb * (hx2 * (wb - wc))
                + lc * (-hx2 * wb + (hx2 + hy2) * wc - hy2 * wd)
                + ld * (hy2 * (wd - wc)))
    return g_low, g_up


def _reduce_to(x: jax.Array, shape) -> jax.Array:
    """Sum away broadcasted lead axes so a cotangent matches its primal."""
    extra = x.ndim - len(shape)
    if extra > 0:
        x = x.sum(axis=tuple(range(extra)))
    return x


def residual_vjp_manual(grid: StructuredGrid, kappa_lu, f, g, u, lam,
                        C: Optional[jax.Array] = None):
    """Cotangents of the IFT residual map, in closed form.

    For R(κ, f, g) = b(f, g, κ) − A(κ)u at fixed u, returns
    (λᵀ∂R/∂κ, λᵀ∂R/∂f, λᵀ∂R/∂g) with shapes reduced to the primals.
    Replaces ``jax.vjp(residual, ...)``: the tape transpose materialized
    7-plane ∂C cotangents and re-ran the coefficient assembly; this is a
    handful of fused slice expressions.  Grads agree with the tape to
    1e-7 (f32).

    Derivation: λᵀR = λᵀ(m⊙g) + (pλ)ᵀF(f) − (pλ)ᵀK(w) − λᵀ(m⊙u), with
    w = m⊙g + p⊙u, so ∂f = F*(pλ) (F is symmetric), ∂g = m⊙(λ − K(pλ))
    (K symmetric), ∂κ = −(λ|_tri)ᵀ K_unit (w|_tri) per triangle.
    """
    kl, ku = kappa_lu
    m = boundary_mask_grid(grid, lam.dtype)
    p = 1.0 - m
    pl_ = p * lam
    w = m * g + p * u
    g_low, g_up = stencil_kappa_grad(grid, pl_, w)
    if C is None:
        C = stencil_coefficients(grid, kl, ku)
    grad_f = load_grid(grid, pl_)
    grad_g = m * (lam - stencil_apply(C, pl_))
    return ((_reduce_to(-g_low, kl.shape), _reduce_to(-g_up, ku.shape)),
            _reduce_to(grad_f, f.shape), _reduce_to(grad_g, g.shape))


def _operator(C, m, v):
    p = 1.0 - m
    return m * v + p * stencil_apply(C, p * v)


def _pcg_grid(C, m, b, Minv, x0, tol, maxiter):
    from .pcg import pcg
    return pcg(lambda v: _operator(C, m, v), b, lambda r: Minv * r, x0,
               tol, maxiter)


def _solve_impl(grid, kappa_lu, f, g, tol, maxiter):
    """Shifted form u = m·g + A⁻¹[p·(F − K(m·g))] through the recursive
    ``apply_inv`` primitive.  Identical Krylov iterates to solving
    A u = m·g + p·(F − K(m·g)) from x₀ = m·g (the pre-round-4 form): the
    shift moves the initial guess to zero without changing the residual
    sequence.  Routing the primal through ``apply_inv`` makes the saved
    custom-vjp residuals reverse-differentiable, so second-order autodiff
    (Newton/Hessian through solve_poisson) composes."""
    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, f.dtype)
    p = 1.0 - m
    F = load_grid(grid, f)
    mg = m * g
    rhs = p * (F - stencil_apply(C, mg))
    return mg + apply_inv(grid, kappa_lu, rhs, tol, maxiter)


@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5))
def solve_poisson_structured(grid: StructuredGrid, kappa_lu, f: jax.Array,
                             g: jax.Array, tol: float = 0.0,
                             maxiter: Optional[int] = None) -> jax.Array:
    """Solve −∇·(κ∇u)=f on the structured grid, Dirichlet boundary = g.

    kappa_lu: tuple (κ_lower (ny,nx), κ_upper (ny,nx)) per-triangle fields;
    f, g: (ny+1, nx+1) node grids.  Returns u on the node grid.
    Differentiable wrt κ, f, g via one adjoint CG solve (IFT), like
    ops/cg.py.
    """
    return _solve_impl(grid, kappa_lu, f, g, tol, maxiter)


@partial(jax.custom_vjp, nondiff_argnums=(0, 3, 4))
def apply_inv(grid: StructuredGrid, kappa_lu, b: jax.Array,
              tol: float = 0.0, maxiter: Optional[int] = None) -> jax.Array:
    """x = A(κ)⁻¹ b for the BC-eliminated operator A = m + p·K(κ)·p.

    A differentiable linear-solve primitive: its VJP solves A λ = x̄ with
    THIS SAME primitive (A symmetric), so reverse-mode composes to any
    order — this is what makes second-order autodiff (Newton/Hessian
    polish through ``solve_poisson``) work on the structured route: the
    IFT ``_bwd`` below calls it instead of the raw ``pcg`` while_loop,
    which JAX cannot reverse-differentiate."""
    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, b.dtype)
    p = 1.0 - m
    diagA = m + p * C[..., 0, :, :]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    maxit = maxiter if maxiter is not None else (grid.nx + 1) * (grid.ny + 1)
    return _pcg_grid(C, m, b, Minv, jnp.zeros_like(b), tol, maxit)


def _ai_fwd(grid, kappa_lu, b, tol, maxiter):
    x = apply_inv(grid, kappa_lu, b, tol, maxiter)
    return x, (kappa_lu, x)


def _ai_bwd(grid, tol, maxiter, res, xbar):
    kappa_lu, x = res
    kl, ku = kappa_lu
    lam = apply_inv(grid, kappa_lu, xbar, tol, maxiter)
    m = boundary_mask_grid(grid, x.dtype)
    p = 1.0 - m
    # λᵀAx = λᵀ(m⊙x) + (pλ)ᵀK(px): ∂κ per triangle via the closed form
    g_low, g_up = stencil_kappa_grad(grid, p * lam, p * x)
    return ((_reduce_to(-g_low, jnp.shape(kl)),
             _reduce_to(-g_up, jnp.shape(ku))),
            _reduce_to(lam, jnp.shape(x)))


apply_inv.defvjp(_ai_fwd, _ai_bwd)


def _fwd(grid, kappa_lu, f, g, tol, maxiter):
    u = _solve_impl(grid, kappa_lu, f, g, tol, maxiter)
    return u, (kappa_lu, f, g, u)


def _bwd(grid, tol, maxiter, res, gbar):
    kappa_lu, f, g, u = res
    # adjoint solve through the differentiable-inverse primitive (NOT raw
    # pcg) + the closed-form residual VJP — both reverse-differentiable,
    # so jax.hessian / grad-of-grad compose through this solve.
    lam = apply_inv(grid, kappa_lu, gbar, tol, maxiter)
    return residual_vjp_manual(grid, kappa_lu, f, g, u, lam)


solve_poisson_structured.defvjp(_fwd, _bwd)


def kappa_mse_grad_step_2d(grid: StructuredGrid, kappa_lu, f: jax.Array,
                           g: jax.Array, u_data: jax.Array, iters: int,
                           scale: Optional[float] = None, warm_state=None,
                           return_state: bool = False):
    """One batched κ-inversion gradient step with optional CG warm starts.

    For loss = scale/2 · Σ_{b,ij} (u_b − u_data_b)²_{ij}, with u_b the
    fixed-trip (``iters``) PCG solve of A(κ_b) u = b(f_b, g, κ_b), returns

        (loss_parts (B,), (∂κ_lower, ∂κ_upper))   [+ state]

    ``scale`` defaults to 2/(B·H·W), which makes the loss ``jnp.mean``.
    Forward and IFT-adjoint CG run per scenario (independent α/β), and
    the κ cotangents come from the closed-form contraction
    (:func:`stencil_kappa_grad`).  In an SGD loop κ moves O(lr) per step,
    so passing the previous step's ``state`` (from ``return_state=True``)
    seeds both solves with the previous (u, λ) and buys the converged
    loss at a fraction of the iterations (tests/test_stencil.py).
    Batched: κ planes (B, ny, nx) or shared (ny, nx); f, u_data
    (B, ny+1, nx+1); g the node grid.  A step function (loss, grad), not
    a differentiable primitive.
    """
    from .pcg import batched_dot, pcg

    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, f.dtype)
    p = 1.0 - m
    mg = m * g
    b = mg + p * (load_grid(grid, f) - stencil_apply(C, mg))
    b = jnp.broadcast_to(b, jnp.broadcast_shapes(b.shape, u_data.shape))
    B = b.shape[0]
    if scale is None:
        scale = 2.0 / (B * b.shape[-2] * b.shape[-1])
    diagA = m + p * C[..., 0, :, :]
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    if warm_state is None:
        x0, l0 = jnp.broadcast_to(mg, b.shape), jnp.zeros_like(b)
    else:
        x0, l0 = warm_state

    def solve(rhs, x):
        return pcg(lambda v: _operator(C, m, v), rhs, lambda r: Minv * r,
                   x, 0.0, iters, dot=batched_dot(2))

    u = solve(b, x0)
    diff = u - u_data
    lam = solve(scale * diff, l0)
    g_low, g_up = stencil_kappa_grad(grid, p * lam, mg + p * u)
    grads = (_reduce_to(-g_low, jnp.shape(kl)),
             _reduce_to(-g_up, jnp.shape(ku)))
    loss_parts = jnp.sum(diff * diff, axis=(-2, -1))
    if return_state:
        return loss_parts, grads, (u, lam)
    return loss_parts, grads
