"""Vectorized P1 finite-element assembly (stiffness K, load F, mass M).

Replaces the reference's Python-interpreted element loops
(/root/reference/diffhe/solver.py:73-147) with pure gather → per-element
local matrices → scatter-add, so the whole assembly is one fused XLA
computation that vmaps over scenario batches.

Preserved reference semantics:
  * 1D local stiffness κ/h·[[1,-1],[-1,1]] (solver.py:86-92) and
    trapezoidal/lumped nodal load F_i += h/2·f_i (solver.py:94-96).
  * 2D P1 triangle stiffness κ(b_p b_q + c_p c_q)/(4A) (solver.py:123-140)
    and centroid load F_p += A/3·mean(f_i,f_j,f_k) (solver.py:142-145).
  * Degenerate triangles (area < 1e-15) contribute nothing
    (solver.py:120-121) — here a data-independent ``where`` mask instead of
    a Python ``continue`` so control flow stays trace-compatible.

Fixed reference bug: per-element κ raises RuntimeError in the reference
(solver.py:89, documented-but-broken per SURVEY.md §2a); here κ may be a
scalar, per-element ``(n_elements,)``, per-node ``(n_nodes,)`` (averaged
onto elements), or any of those with leading batch axes via ``jax.vmap``.

Improvement over reference: 2D node coordinates are NOT detached
(reference solver.py:125-134 `.detach()` blocks shape derivatives), so
∂/∂(node positions) flows here — useful for shape optimization.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..mesh import FEMesh

DEGENERATE_AREA_TOL = 1e-15  # matches reference solver.py:120


# --------------------------------------------------------------------------
# κ normalization
# --------------------------------------------------------------------------

def kappa_on_elements(mesh: FEMesh, kappa) -> jax.Array:
    """Normalize κ to a per-element array ``(n_elements,)``.

    Accepts scalar, per-element ``(n_elements,)``, or per-node ``(n_nodes,)``
    (averaged over each element's nodes — P1 midpoint value).
    """
    kappa = jnp.asarray(kappa, dtype=mesh.dtype)
    if is_tensor_kappa(mesh, kappa):
        raise ValueError(
            "tensor-valued kappa reached a scalar-diffusion path; tensor "
            "diffusivity is supported on P1 triangle/tetrahedral meshes "
            "via method='dense'/'lu'/'cg' only (the structured stencil "
            "reductions are isotropic-only — method='auto' already routes "
            "tensor κ to the general paths)")
    ne, nn = mesh.n_elements, mesh.n_nodes
    if kappa.ndim == 0:
        return jnp.broadcast_to(kappa, (ne,))
    if kappa.shape[-1] == ne:
        return kappa
    if kappa.shape[-1] == nn:
        return jnp.mean(kappa[..., mesh.elements], axis=-1)
    raise ValueError(
        f"kappa shape {kappa.shape} matches neither n_elements={ne} "
        f"nor n_nodes={nn}"
    )


def is_tensor_kappa(mesh: FEMesh, kappa) -> bool:
    """True when κ is a dim×dim diffusion tensor (anisotropic −∇·(A∇u) = f):
    any shape with trailing dims (d, d) on a 2D/3D mesh."""
    shape = jnp.shape(kappa)
    d = mesh.dim
    return d in (2, 3) and len(shape) >= 2 and shape[-2:] == (d, d)


def kappa_tensor_on_elements(mesh: FEMesh, A) -> jax.Array:
    """Normalize a diffusion tensor to per-element ``(n_elements, d, d)``.

    Accepts constant (d, d), per-element (n_elements, d, d), or per-node
    (n_nodes, d, d) (averaged over each element's vertices), d = mesh.dim.
    """
    A = jnp.asarray(A, dtype=mesh.dtype)
    ne, nn, d = mesh.n_elements, mesh.n_nodes, mesh.dim
    if A.ndim == 2:
        return jnp.broadcast_to(A, (ne, d, d))
    if A.shape[-3] == ne:
        return A
    if A.shape[-3] == nn:
        return jnp.mean(A[..., mesh.elements, :, :], axis=-3)
    raise ValueError(
        f"tensor kappa shape {A.shape} matches neither "
        f"(n_elements={ne}, {d}, {d}) nor (n_nodes={nn}, {d}, {d})")


# --------------------------------------------------------------------------
# Per-element geometry + local matrices
# --------------------------------------------------------------------------

def element_geometry_1d(mesh: FEMesh):
    """Element lengths h_e (signed as in reference: x_j - x_i, solver.py:77)."""
    x = mesh.nodes[:, 0]
    i, j = mesh.elements[:, 0], mesh.elements[:, 1]
    return x[j] - x[i]


def element_geometry_2d(mesh: FEMesh):
    """P1 triangle geometry: (b, c, area).

    b, c: (n_elements, 3) basis-gradient coefficients
    φ_p = (a_p + b_p x + c_p y)/(2A); area: (n_elements,) unsigned.
    Matches reference solver.py:119-134 but without detaching coordinates.
    """
    p = mesh.nodes[mesh.elements]  # (ne, 3, 2)
    x, y = p[..., 0], p[..., 1]
    xi, xj, xk = x[:, 0], x[:, 1], x[:, 2]
    yi, yj, yk = y[:, 0], y[:, 1], y[:, 2]
    area = 0.5 * jnp.abs((xj - xi) * (yk - yi) - (xk - xi) * (yj - yi))
    b = jnp.stack([yj - yk, yk - yi, yi - yj], axis=1)  # (ne, 3)
    c = jnp.stack([xk - xj, xi - xk, xj - xi], axis=1)  # (ne, 3)
    return b, c, area


def element_geometry_3d(mesh: FEMesh):
    """P1 tetrahedron geometry: (grads, volume).

    grads: (n_elements, 4, 3) — constant basis gradients ∇φ_p on each tet,
    from the edge-vector cross-product closed form (no linalg.inv):
    with e_i = p_i − p_0, det = e_1·(e_2×e_3), V = |det|/6,
    ∇φ_1 = (e_2×e_3)/det, ∇φ_2 = (e_3×e_1)/det, ∇φ_3 = (e_1×e_2)/det,
    ∇φ_0 = −(∇φ_1+∇φ_2+∇φ_3).  Degenerate tets (|det| < tol) are
    ``where``-guarded, matching the 2D degenerate-area semantics
    (reference solver.py:120-121 — the reference itself has NO 3D support:
    its forward() raises for dim>2, /root/reference/diffhe/solver.py:62-67).
    volume: (n_elements,) unsigned.
    """
    p = mesh.nodes[mesh.elements]          # (ne, 4, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    e3 = p[:, 3] - p[:, 0]
    c23 = jnp.cross(e2, e3)
    det = jnp.sum(e1 * c23, axis=-1)       # (ne,)
    vol = jnp.abs(det) / 6.0
    degenerate = jnp.abs(det) < DEGENERATE_AREA_TOL
    safe_det = jnp.where(degenerate, 1.0, det)[:, None]
    g1 = c23 / safe_det
    g2 = jnp.cross(e3, e1) / safe_det
    g3 = jnp.cross(e1, e2) / safe_det
    g0 = -(g1 + g2 + g3)
    grads = jnp.stack([g0, g1, g2, g3], axis=1)   # (ne, 4, 3)
    grads = jnp.where(degenerate[:, None, None], 0.0, grads)
    return grads, vol


def local_stiffness_3d(mesh: FEMesh, kappa) -> jax.Array:
    """Per-element 4×4 tet stiffness blocks ``(n_elements, 4, 4)``.

    Scalar/field κ: K_e[p,q] = κ_e V_e ∇φ_p·∇φ_q.  Tensor κ (trailing
    (3, 3)): K_e[p,q] = V_e ∇φ_p A_e ∇φ_q.  Degenerate tets contribute
    nothing (grads already zeroed in element_geometry_3d).
    """
    grads, vol = element_geometry_3d(mesh)
    if is_tensor_kappa(mesh, kappa):
        A = kappa_tensor_on_elements(mesh, kappa)       # (ne, 3, 3)
        gram = jnp.einsum("epi,eij,eqj->epq", grads, A, grads)
        return vol[:, None, None] * gram
    ke = kappa_on_elements(mesh, kappa)
    gram = jnp.einsum("epi,eqi->epq", grads, grads)
    return (ke * vol)[:, None, None] * gram


def local_stiffness_2d(mesh: FEMesh, kappa) -> jax.Array:
    """Per-element 3×3 stiffness blocks ``(n_elements, 3, 3)``.

    Scalar/field κ: K_e[p,q] = κ_e (b_p b_q + c_p c_q)/(4A_e), zeroed for
    degenerate triangles (reference solver.py:120-121,137-140).

    Tensor κ (anisotropic diffusion, beyond the reference — shape with
    trailing (2, 2)): K_e[p,q] = (b_p, c_p) A_e (b_q, c_q)ᵀ / (4A_e);
    reduces to the scalar formula when A = κI.
    """
    b, c, area = element_geometry_2d(mesh)
    safe_area = jnp.where(area < DEGENERATE_AREA_TOL, 1.0, area)
    if is_tensor_kappa(mesh, kappa):
        A = kappa_tensor_on_elements(mesh, kappa)      # (ne, 2, 2)
        g = jnp.stack([b, c], axis=-1)                 # (ne, 3, 2)
        gram = jnp.einsum("epi,eij,eqj->epq", g, A, g)
        scale = jnp.where(area < DEGENERATE_AREA_TOL, 0.0,
                          1.0 / (4.0 * safe_area))
        return scale[:, None, None] * gram
    ke = kappa_on_elements(mesh, kappa)
    gram = b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]
    scale = jnp.where(area < DEGENERATE_AREA_TOL, 0.0,
                      ke / (4.0 * safe_area))
    return scale[:, None, None] * gram


# --------------------------------------------------------------------------
# Dense assembly (small meshes / golden path)
# --------------------------------------------------------------------------

def element_family(mesh: FEMesh) -> str:
    """'p1_line' | 'p2_line' | 'p1_tri' | 'p2_tri' | 'p1_tet' from
    (dim, nodes/elem)."""
    npe = mesh.elements.shape[1]
    if mesh.dim == 1 and npe == 2:
        return "p1_line"
    if mesh.dim == 1 and npe == 3:
        return "p2_line"
    if mesh.dim == 2 and npe == 3:
        return "p1_tri"
    if mesh.dim == 2 and npe == 6:
        return "p2_tri"
    if mesh.dim == 3 and npe == 4:
        return "p1_tet"
    raise NotImplementedError(
        f"unsupported element family: dim={mesh.dim}, nodes/elem={npe}")


def dense_from_local(mesh: FEMesh, Ke: jax.Array) -> jax.Array:
    """Scatter per-element blocks (ne, k, k) into a dense (n, n) matrix."""
    n = mesh.n_nodes
    k = Ke.shape[-1]
    elems = mesh.elements
    rows = jnp.repeat(elems, k, axis=1).reshape(-1)
    cols = jnp.tile(elems, (1, k)).reshape(-1)
    K = jnp.zeros((n, n), dtype=mesh.dtype)
    return K.at[rows, cols].add(Ke.reshape(-1))


def local_stiffness(mesh: FEMesh, kappa) -> jax.Array:
    """Per-element stiffness blocks for any supported element family."""
    fam = element_family(mesh)
    if fam == "p1_line":
        h = element_geometry_1d(mesh)
        ke = kappa_on_elements(mesh, kappa) / h
        S = jnp.array([[1.0, -1.0], [-1.0, 1.0]], dtype=mesh.dtype)
        return ke[:, None, None] * S
    if fam == "p2_line":
        from .p2 import local_stiffness_p2_1d
        return local_stiffness_p2_1d(mesh, kappa)
    if fam == "p1_tri":
        return local_stiffness_2d(mesh, kappa)
    if fam == "p1_tet":
        return local_stiffness_3d(mesh, kappa)
    from .p2 import local_stiffness_p2_2d
    return local_stiffness_p2_2d(mesh, kappa)


def assemble_stiffness_dense(mesh: FEMesh, kappa) -> jax.Array:
    """Dense stiffness matrix K ∈ (n_nodes, n_nodes), no BCs applied."""
    fam = element_family(mesh)
    if fam == "p1_line":
        # banded fast form of the generic scatter
        n = mesh.n_nodes
        h = element_geometry_1d(mesh)
        ke = kappa_on_elements(mesh, kappa) / h  # κ/h_e, solver.py:88
        i, j = mesh.elements[:, 0], mesh.elements[:, 1]
        K = jnp.zeros((n, n), dtype=mesh.dtype)
        K = K.at[i, i].add(ke).at[j, j].add(ke)
        K = K.at[i, j].add(-ke).at[j, i].add(-ke)
        return K
    return dense_from_local(mesh, local_stiffness(mesh, kappa))


def assemble_load(mesh: FEMesh, f: jax.Array) -> jax.Array:
    """Load vector F from nodal forcing values ``f`` (…, n_nodes).

    1D: trapezoidal nodal rule F_i += h_e/2·f_i (solver.py:94-96).
    2D: centroid rule F_p += A_e/3·mean(f over element) (solver.py:142-145).
    Supports leading batch axes on ``f``.
    """
    f = jnp.asarray(f, dtype=mesh.dtype)
    n = mesh.n_nodes
    fam = element_family(mesh)
    if fam == "p1_line":
        h = element_geometry_1d(mesh)
        i, j = mesh.elements[:, 0], mesh.elements[:, 1]
        F = jnp.zeros(f.shape[:-1] + (n,), dtype=mesh.dtype)
        F = F.at[..., i].add(h / 2.0 * f[..., i])
        F = F.at[..., j].add(h / 2.0 * f[..., j])
        return F
    if fam == "p2_line":
        from .p2 import load_p2_1d
        return load_p2_1d(mesh, f)
    if fam == "p1_tri":
        _, _, area = element_geometry_2d(mesh)
        area = jnp.where(area < DEGENERATE_AREA_TOL, 0.0, area)
        fe = f[..., mesh.elements]                    # (..., ne, 3)
        f_centroid = jnp.mean(fe, axis=-1)            # (..., ne)
        contrib = (area / 3.0) * f_centroid           # (..., ne)
        F = jnp.zeros(f.shape[:-1] + (n,), dtype=mesh.dtype)
        for p in range(3):
            F = F.at[..., mesh.elements[:, p]].add(contrib)
        return F
    if fam == "p1_tet":
        # centroid rule, 3D analogue of the reference's 2D load
        # (solver.py:142-145): F_p += V_e/4 · mean(f over the 4 vertices)
        _, vol = element_geometry_3d(mesh)
        fe = f[..., mesh.elements]                    # (..., ne, 4)
        contrib = (vol / 4.0) * jnp.mean(fe, axis=-1)
        F = jnp.zeros(f.shape[:-1] + (n,), dtype=mesh.dtype)
        for p in range(4):
            F = F.at[..., mesh.elements[:, p]].add(contrib)
        return F
    from .p2 import load_p2_2d
    return load_p2_2d(mesh, f)


def assemble_lumped_mass(mesh: FEMesh) -> jax.Array:
    """Diagonal (lumped) mass matrix entries ``(n_nodes,)``.

    P1 families and P2 lines: row-sum lumping M = assemble_load(mesh, 1)
    (all entries positive).  P2 triangles: row-sum lumping is ZERO at
    vertex nodes (∫N_vertex dA = 0), so HRZ diagonal scaling is used
    instead (ops/p2.py:lumped_mass_p2_2d).  Used by the time-dependent
    heat-equation rollouts (control/heat.py).
    """
    if element_family(mesh) == "p2_tri":
        from .p2 import lumped_mass_p2_2d
        return lumped_mass_p2_2d(mesh)
    ones = jnp.ones(mesh.n_nodes, dtype=mesh.dtype)
    return assemble_load(mesh, ones)


# --------------------------------------------------------------------------
# Matrix-free operator (never materializes K — the 2D production path)
# --------------------------------------------------------------------------

def element_apply(mesh: FEMesh, Ke: jax.Array, u: jax.Array) -> jax.Array:
    """Matrix-free K·u using per-element blocks ``Ke`` (ne, k, k).

    u: (..., n_nodes) → returns (..., n_nodes).  Gather element DOFs,
    apply local blocks, scatter-add — the batched alternative to
    materializing the O(n²) dense K of the reference.  Works for every
    element family (k = nodes per element).
    """
    elems = mesh.elements                      # (ne, k)
    k = elems.shape[1]
    ue = u[..., elems]                         # (..., ne, k)
    kue = jnp.einsum("epq,...eq->...ep", Ke, ue)
    out = jnp.zeros_like(u)
    for p in range(k):
        out = out.at[..., elems[:, p]].add(kue[..., p])
    return out


# backward-compatible alias (original 2D-only name)
element_apply_2d = element_apply


def stiffness_apply(mesh: FEMesh, kappa, u: jax.Array) -> jax.Array:
    """Matrix-free K(κ)·u for any element family, batched over leading axes."""
    if element_family(mesh) == "p1_line":
        h = element_geometry_1d(mesh)
        ke = kappa_on_elements(mesh, kappa) / h
        i, j = mesh.elements[:, 0], mesh.elements[:, 1]
        du = u[..., i] - u[..., j]
        out = jnp.zeros_like(u)
        out = out.at[..., i].add(ke * du)
        out = out.at[..., j].add(-ke * du)
        return out
    return element_apply(mesh, local_stiffness(mesh, kappa), u)


# --------------------------------------------------------------------------
# Tridiagonal (1D) assembly — the fast path for interval meshes
# --------------------------------------------------------------------------

def assemble_tridiag_1d(mesh: FEMesh, kappa):
    """Stiffness of a 1D chain mesh as (diag, lower/upper) bands.

    Valid for meshes whose elements are (i, i+1) for i = 0..n-2 (all meshes
    from ``FEMesh.line``).  Returns ``(d, e)`` with d: (n,), e: (n-1,) — K is
    symmetric tridiagonal: K[i,i]=d[i], K[i,i+1]=K[i+1,i]=e[i].
    """
    if element_family(mesh) != "p1_line":
        raise ValueError("tridiagonal assembly requires P1 line elements "
                         "(P2 line meshes are pentadiagonal — use "
                         "method='dense' or 'cg')")
    h = element_geometry_1d(mesh)
    ke = kappa_on_elements(mesh, kappa) / h        # (n-1,)
    n = mesh.n_nodes
    d = jnp.zeros(ke.shape[:-1] + (n,), dtype=mesh.dtype)
    d = d.at[..., :-1].add(ke).at[..., 1:].add(ke)
    e = -ke
    return d, e
