"""Gather-only (edge-ELL) matrix-free operator for arbitrary P1
triangulations — the batched unstructured path.

The general unstructured apply (ops/assembly.py:element_apply) is
element-centric: gather element DOFs, apply local blocks, SCATTER-ADD
back.  The scatter-add runs inside every CG iteration, and XLA performs
no loop-invariant code motion across ``lax.while_loop`` bodies, so the
κ-dependent block assembly re-runs every iteration too.

This module re-lays the SAME operator node-centrically in pull (row)
form, compiled to fixed-width gather tables:

    (K u)[i] = diag_i(κ) · u_i + Σ_d W[i,d](κ) · u[nbr[i,d]]

where ``nbr[i,:]`` are node i's mesh neighbors (static topology,
max-degree padded) and the κ-folding is precomputed ONCE per solve:

    W[i,d]  = Σ_t κ[edge_elem[i,d,t]] · edge_w[i,d,t]   (t < 2: the ≤2
              triangles sharing edge (i, nbr[i,d]) on a manifold mesh)
    diag_i  = Σ_t κ[inc_elem[i,t]] · wdiag[i,t]

so the CG hot loop is ONE (…, n, Dn) gather + one FMA contraction — no
scatter, no assembly.  Padding slots carry zero weights (index 0), so
they contribute exactly zero.  Dn is the max node degree (≤ 8 for
reasonable triangulations).

The per-element-κ gradient costs one element-wise contraction of nodal
differences of u and the adjoint per GRAD STEP (_kappa_cotangent), not
per-iteration work — that is the whole point.

The matvec is plain XLA (a static-index gather plus a contraction); the
decision record is docs/PERFORMANCE.md 'Unstructured meshes'.

Reference counterpart: the arbitrary-connectivity data model of
/root/reference/diffhe/mesh.py:30-39 with the dense assembly of
solver.py:104-147; here the connectivity is compiled to gather tables
instead of a matrix.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh import FEMesh
from .assembly import kappa_on_elements, local_stiffness
from .pcg import pcg
from .solve import apply_dirichlet_operator, dirichlet_rhs


class ELL(NamedTuple):
    """Static gather tables for one mesh (see module docstring)."""
    nbr: jax.Array            # (n, Dn) int32 — neighbor node ids, 0-padded
    edge_elem: jax.Array      # (n, Dn, T) int32 — elems sharing edge (i,nbr)
    edge_w: jax.Array         # (n, Dn, T) — unit-κ off-diag weights, 0-pad
    inc_elem: jax.Array       # (n, Di) int32 — elements incident to node i
    wdiag: jax.Array          # (n, Di) — unit-κ diagonal weights, 0-padded


def build_ell(mesh: FEMesh) -> ELL:
    """Precompute the gather tables (host-side, once per mesh).

    Weights use unit κ: the κ-dependence is re-attached per solve via
    per-element gathers (ell_weights), so one ELL serves every κ and
    every scenario of a batch."""
    elems = np.asarray(mesh.elements)                     # (ne, k)
    ne, k = elems.shape
    n = mesh.n_nodes
    ones = jnp.ones((ne,), mesh.dtype)
    G = np.asarray(local_stiffness(mesh, ones))           # (ne, k, k), κ=1

    # per-node incident (element, local index) lists → diagonal weights
    nbrs = [dict() for _ in range(n)]    # j -> list of (e, w)
    incs = [[] for _ in range(n)]        # list of (e, w_pp)
    for e in range(ne):
        for p in range(k):
            i = int(elems[e, p])
            incs[i].append((e, G[e, p, p]))
            for q in range(k):
                if q == p:
                    continue
                j = int(elems[e, q])
                nbrs[i].setdefault(j, []).append((e, G[e, p, q]))

    Dn = max(len(d) for d in nbrs)
    T = max((len(lst) for d in nbrs for lst in d.values()), default=1)
    Di = max(len(c) for c in incs)

    nbr = np.zeros((n, Dn), np.int32)
    edge_elem = np.zeros((n, Dn, T), np.int32)
    edge_w = np.zeros((n, Dn, T), G.dtype)
    inc_elem = np.zeros((n, Di), np.int32)
    wdiag = np.zeros((n, Di), G.dtype)
    for i in range(n):
        for d, (j, lst) in enumerate(sorted(nbrs[i].items())):
            nbr[i, d] = j
            for t, (e, w) in enumerate(lst):
                edge_elem[i, d, t] = e
                edge_w[i, d, t] = w
        for t, (e, w) in enumerate(incs[i]):
            inc_elem[i, t] = e
            wdiag[i, t] = w

    return ELL(jnp.asarray(nbr), jnp.asarray(edge_elem),
               jnp.asarray(edge_w, mesh.dtype), jnp.asarray(inc_elem),
               jnp.asarray(wdiag, mesh.dtype))


def ell_weights(mesh: FEMesh, ell: ELL, kappa):
    """Fold κ into the gather tables ONCE per solve → (W, diag).

    Assembling here and closing the CG operator over (W, diag) removes
    the per-iteration κ gathers entirely (XLA does not hoist
    loop-invariant code out of ``lax.while_loop`` bodies)."""
    ke = kappa_on_elements(mesh, kappa)                   # (..., ne)
    W = jnp.sum(ke[..., ell.edge_elem] * ell.edge_w, axis=-1)
    diag = jnp.sum(ke[..., ell.inc_elem] * ell.wdiag, axis=-1)
    return W, diag                                        # (...,n,Dn), (...,n)


def ell_apply_w(ell: ELL, W: jax.Array, diag: jax.Array,
                u: jax.Array) -> jax.Array:
    """K·u from prefolded weights: one (…, n, Dn) gather + one FMA
    contraction — the entire per-iteration cost."""
    ug = u[..., ell.nbr]                                  # (..., n, Dn)
    return diag * u + jnp.sum(W * ug, axis=-1)


def ell_apply(mesh: FEMesh, ell: ELL, kappa, u: jax.Array) -> jax.Array:
    """K·u by gathers only; u: (..., n) → (..., n).  Exactly equal to
    element_apply with the same κ (tests/test_unstructured.py)."""
    W, diag = ell_weights(mesh, ell, kappa)
    return ell_apply_w(ell, W, diag, u)


def ell_diag(mesh: FEMesh, ell: ELL, kappa) -> jax.Array:
    """diag(K) for the Jacobi preconditioner — gathers only."""
    ke = kappa_on_elements(mesh, kappa)
    return jnp.sum(ke[..., ell.inc_elem] * ell.wdiag, axis=-1)


def _jacobi_from_diag(mesh, diag):
    m = mesh.bc_mask
    diagA = m + (1.0 - m) * diag
    return 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)


def _ell_impl(mesh, ell, kappa, F, tol, maxiter):
    maxiter = maxiter if maxiter is not None else mesh.n_nodes
    W, diag = ell_weights(mesh, ell, kappa)   # once — NOT per iteration
    applyK = lambda w: ell_apply_w(ell, W, diag, w)
    op = lambda v: apply_dirichlet_operator(mesh, applyK, v)
    b = dirichlet_rhs(mesh, applyK, F)
    Minv = _jacobi_from_diag(mesh, diag)
    x0 = mesh.bc_mask * mesh.bc_values
    return pcg(op, b, lambda r: Minv * r,
               jnp.broadcast_to(x0, b.shape), tol, maxiter)


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def solve_poisson_cg_ell(mesh: FEMesh, ell: ELL, kappa, F: jax.Array,
                         tol: float = 0.0,
                         maxiter: Optional[int] = None) -> jax.Array:
    """Matrix-free Jacobi-PCG Poisson solve on the gather-only operator.

    Same semantics, IFT adjoint, and fixed-trip ``tol=0`` batched mode as
    ops/cg.py:solve_poisson_cg, with the scatter-free edge-ELL matvec in
    both the forward and adjoint loops.  ``ell = build_ell(mesh)`` once;
    gradients flow to κ and F (geometry is baked into the host-built
    tables — use solve_poisson_cg when you need ∂/∂nodes)."""
    return _ell_impl(mesh, ell, kappa, F, tol, maxiter)


def _ell_fwd(mesh, ell, kappa, F, tol, maxiter):
    u = _ell_impl(mesh, ell, kappa, F, tol, maxiter)
    return u, (mesh, ell, kappa, F, u)


def _ell_bwd(tol, maxiter, res, g):
    mesh, ell, kappa, F, u = res
    maxit = maxiter if maxiter is not None else mesh.n_nodes
    W, diag = ell_weights(mesh, ell, kappa)   # reused across the adjoint
    applyK = lambda w: ell_apply_w(ell, W, diag, w)
    Minv = _jacobi_from_diag(mesh, diag)
    lam = pcg(lambda v: apply_dirichlet_operator(mesh, applyK, v), g,
              lambda r: Minv * r, jnp.zeros_like(g), tol, maxit)

    # Residual map at fixed u for the mesh (Dirichlet values), ELL and F
    # cotangents; κ's cotangent is taken element by element in
    # difference form (_kappa_cotangent).
    def residual(mesh_, ell_, F_):
        u_fixed = jax.lax.stop_gradient(u)
        W_, d_ = ell_weights(mesh_, ell_, kappa)
        applyK_ = lambda w: ell_apply_w(ell_, W_, d_, w)
        return (dirichlet_rhs(mesh_, applyK_, F_)
                - apply_dirichlet_operator(mesh_, applyK_, u_fixed))

    _, vjp = jax.vjp(residual, mesh, ell, F)
    g_mesh, g_ell, g_F = vjp(lam)
    gke = _kappa_cotangent(mesh, ((1.0 - mesh.bc_mask) * lam)[:, None],
                           u[:, None])[:, 0]
    _, vjp_k = jax.vjp(lambda k: kappa_on_elements(mesh, k), kappa)
    return g_mesh, g_ell, vjp_k(gke)[0], g_F


def _kappa_cotangent(mesh, lam, u):
    """λᵀ ∂(F − K(κ)u)/∂κ_e for per-element κ, with (n, B) interior
    adjoint λ and solution u: −λ_eᵀ G_e u_e, G_e the unit-κ element
    stiffness.  Each row of G_e sums to zero (constants span its null
    space), so this equals ½ Σ_pq G_pq (λ_p − λ_q)(u_p − u_q), a sum of
    products of nodal differences.  −λᵀ(G_e u) itself cancels terms of
    size |u| down to the element-to-element variation of u, which costs
    float32 about a factor (diameter / h) of accuracy."""
    el = mesh.elements
    G = local_stiffness(mesh, jnp.ones((mesh.n_elements,), mesh.dtype))
    ue, le = u[el], lam[el]                               # (ne, k, B)
    du = ue[:, :, None] - ue[:, None, :]                  # (ne, k, k, B)
    dl = le[:, :, None] - le[:, None, :]
    return 0.5 * jnp.einsum("epq,epqb,epqb->eb", G, dl, du)


solve_poisson_cg_ell.defvjp(_ell_fwd, _ell_bwd)


# ---------------------------------------------------------------------------
# Batch-minor (structure-of-arrays) batched ELL solve
#
# The batch-leading vmapped form's per-iteration gather produces
# (B, n, Dn) with the short Dn ≈ 8 axis innermost.  Keeping the scenario
# batch as the trailing axis makes the gather result (n, Dn, B) and the
# state (n, B), so the row gather u[nbr] moves whole contiguous rows of
# scenarios.  Same layout as ops/stencil3d.py's batch-minor CG, applied
# to the gather tables.  fit_kappa takes it at B ≥ 128, a threshold for
# the benchmark to re-decide (ROADMAP).
# ---------------------------------------------------------------------------


def _bm_dot_nodes(u, v):
    """Per-scenario inner product for (n, B) batch-minor CG state."""
    return jnp.sum(u * v, axis=0, keepdims=True)


def ell_weights_bm(mesh: FEMesh, ell: ELL, keB: jax.Array):
    """κ (ne, B) batch-minor → prefolded (W (n, Dn, B), diag (n, B))."""
    W = jnp.sum(keB[ell.edge_elem] * ell.edge_w[..., None], axis=-2)
    diag = jnp.sum(keB[ell.inc_elem] * ell.wdiag[..., None], axis=-2)
    return W, diag


def ell_apply_bm(ell: ELL, W: jax.Array, diag: jax.Array,
                 u: jax.Array) -> jax.Array:
    """K·u with batch-minor state: u (n, B) → (n, B).  One row gather
    (n, Dn, B) + one FMA contraction over Dn."""
    ug = u[ell.nbr]                                       # (n, Dn, B)
    return diag * u + jnp.sum(W * ug, axis=1)


def _ell_bm_impl(mesh, ell, keB, Fbm, tol, maxiter):
    maxiter = maxiter if maxiter is not None else mesh.n_nodes
    W, diag = ell_weights_bm(mesh, ell, keB)  # once — NOT per iteration
    m = mesh.bc_mask[:, None]
    p = 1.0 - m
    g = mesh.bc_values[:, None]
    diagA = m + p * diag
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    applyK = lambda w: ell_apply_bm(ell, W, diag, w)
    mg = m * g
    rhs = p * (Fbm - applyK(mg))
    y = pcg(lambda v: m * v + p * applyK(p * v), rhs,
            lambda r: Minv * r, jnp.zeros_like(rhs), tol, maxiter,
            dot=_bm_dot_nodes)
    return mg + y


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def solve_poisson_cg_ell_batched(mesh: FEMesh, ell: ELL, kappa,
                                 F: jax.Array, tol: float = 0.0,
                                 maxiter: Optional[int] = None) -> jax.Array:
    """Batched edge-ELL solve with batch-minor device layout.

    kappa: (B, n_elements) per-scenario fields (or (B,) scalars); F:
    (B, n_nodes) assembled loads.  Returns u (B, n_nodes).  Semantically
    identical to vmapping :func:`solve_poisson_cg_ell` (tested); the
    batch rides the lane axis through the whole CG (module note above).
    Gradients flow to κ and F via the IFT adjoint."""
    keB, Fbm = _ell_bm_prep(mesh, kappa, F)
    u = _ell_bm_impl(mesh, ell, keB, Fbm, tol, maxiter)
    return u.T


def _ell_bm_prep(mesh, kappa, F):
    kappa = jnp.asarray(kappa, mesh.dtype)
    F = jnp.asarray(F, mesh.dtype)
    if F.ndim != 2:
        raise ValueError(f"batched ELL solve expects F (B, n_nodes); "
                         f"got {F.shape}")
    B = F.shape[0]
    if kappa.ndim == 1 and kappa.shape[0] == B:
        if B == mesh.n_elements or B == mesh.n_nodes:
            # same collision rule as solve_poisson_batched: a 1-D κ of
            # length B that also matches a field length is ambiguous —
            # silently reading it as per-scenario scalars would misread a
            # shared per-element field (ADVICE r4)
            raise ValueError(
                f"ambiguous 1-D kappa of length {B}: could be per-scenario "
                f"scalars (B={B}) or a shared field "
                f"(n_elements={mesh.n_elements}, n_nodes={mesh.n_nodes}) — "
                f"pass kappa as (B, n_elements) explicitly")
        keB = jnp.broadcast_to(kappa[None, :], (mesh.n_elements, B))
    else:
        ke = jax.vmap(lambda k: kappa_on_elements(mesh, k))(kappa)
        keB = ke.T                                        # (ne, B)
    return keB, F.T


def _ell_bm_fwd(mesh, ell, kappa, F, tol, maxiter):
    keB, Fbm = _ell_bm_prep(mesh, kappa, F)
    u = _ell_bm_impl(mesh, ell, keB, Fbm, tol, maxiter)
    return u.T, (mesh, ell, kappa, F, u)


def _ell_bm_bwd(tol, maxiter, res, gbar):
    mesh, ell, kappa, F, u = res        # u is batch-minor (n, B)
    keB, _ = _ell_bm_prep(mesh, kappa, F)
    maxit = maxiter if maxiter is not None else mesh.n_nodes
    W, diag = ell_weights_bm(mesh, ell, keB)
    m = mesh.bc_mask[:, None]
    p = 1.0 - m
    diagA = m + p * diag
    Minv = 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)
    applyK = lambda w: ell_apply_bm(ell, W, diag, w)
    gbm = gbar.T
    lam = pcg(lambda v: m * v + p * applyK(p * v), gbm,
              lambda r: Minv * r, jnp.zeros_like(gbm), tol, maxit,
              dot=_bm_dot_nodes)

    # Residual map at fixed u (batch-minor).  Full R = b − A·u so
    # Dirichlet-value cotangents flow too (as in _ell_bwd); κ's cotangent
    # is taken in difference form (_kappa_cotangent).
    def residual(mesh_, ell_, F_):
        keB_, Fbm_ = _ell_bm_prep(mesh_, kappa, F_)
        W_, d_ = ell_weights_bm(mesh_, ell_, keB_)
        m_ = mesh_.bc_mask[:, None]
        p_ = 1.0 - m_
        g_ = mesh_.bc_values[:, None]
        u_fixed = jax.lax.stop_gradient(u)
        aK = lambda w: ell_apply_bm(ell_, W_, d_, w)
        return m_ * (g_ - u_fixed) + p_ * (Fbm_
                                           - aK(m_ * g_ + p_ * u_fixed))

    _, vjp = jax.vjp(residual, mesh, ell, F)
    g_mesh, g_ell, g_F = vjp(lam)
    gkeB = _kappa_cotangent(mesh, p * lam, u)
    _, vjp_k = jax.vjp(lambda k: _ell_bm_prep(mesh, k, F)[0], kappa)
    return g_mesh, g_ell, vjp_k(gkeB)[0], g_F


solve_poisson_cg_ell_batched.defvjp(_ell_bm_fwd, _ell_bm_bwd)
