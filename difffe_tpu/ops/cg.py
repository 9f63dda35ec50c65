"""Matrix-free preconditioned conjugate gradients with a custom adjoint.

Production 2D path: never materializes K (the reference builds a dense O(n²)
matrix, /root/reference/diffhe/solver.py:104-147).  The operator is the
mask-eliminated K̃v = m⊙v + P·K(P·v) applied element-wise
(ops/assembly.py:stiffness_apply), preconditioned with Jacobi.

Differentiation uses the implicit function theorem rather than unrolling the
iteration: for u solving A(θ)u = b(θ),

    dL/dθ = λᵀ(∂b/∂θ − (∂A/∂θ)u),   A λ = ḡ  (A symmetric ⇒ same solve)

implemented as one adjoint CG solve plus a ``jax.vjp`` of the *residual map*
θ ↦ b(θ) − A(θ)u at fixed u — so gradients flow to κ, f, node coordinates,
and BC values with no tape through the solver loop.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..mesh import FEMesh
from .assembly import (
    assemble_tridiag_1d,
    kappa_on_elements,
    local_stiffness_2d,
    stiffness_apply,
)
from .pcg import pcg
from .solve import apply_dirichlet_operator, dirichlet_rhs


def stiffness_diag(mesh: FEMesh, kappa) -> jax.Array:
    """diag(K) — Jacobi preconditioner source (any element family)."""
    from .assembly import element_family, local_stiffness
    if element_family(mesh) == "p1_line":
        d, _ = assemble_tridiag_1d(mesh, kappa)
        return d
    Ke = local_stiffness(mesh, kappa)              # (ne, k, k)
    diag_e = jnp.diagonal(Ke, axis1=-2, axis2=-1)  # (ne, k)
    out = jnp.zeros(mesh.n_nodes, dtype=mesh.dtype)
    for p in range(mesh.elements.shape[1]):
        out = out.at[mesh.elements[:, p]].add(diag_e[:, p])
    return out


def _pcg(A, b, Minv, x0, tol: float, maxiter: int):
    """Jacobi-preconditioned CG; tol=0 → fixed ``maxiter`` sweeps.

    Thin adapter over the shared converged-safe body (ops/pcg.py) with
    ``Minv`` given as a diagonal array."""
    return pcg(A, b, lambda r: Minv * r, x0, tol, maxiter)


def _applyK_fixed(mesh: FEMesh, kappa):
    """Close the matvec over weights assembled ONCE.

    XLA performs no loop-invariant code motion across ``lax.while_loop``
    bodies, so building κ-dependent element blocks inside the CG operator
    re-runs the whole local-stiffness assembly every iteration.  For
    element families with per-element blocks, fold κ into the blocks here
    and close over them; the 1D line family's banded apply is already
    cheap."""
    from .assembly import element_family, element_apply, local_stiffness
    if element_family(mesh) == "p1_line":
        return lambda w: stiffness_apply(mesh, kappa, w)
    Ke = local_stiffness(mesh, kappa)
    return lambda w: element_apply(mesh, Ke, w)


def _operator(mesh: FEMesh, kappa, v: jax.Array) -> jax.Array:
    return apply_dirichlet_operator(
        mesh, lambda w: stiffness_apply(mesh, kappa, w), v)


def _rhs(mesh: FEMesh, kappa, F: jax.Array) -> jax.Array:
    return dirichlet_rhs(mesh, lambda w: stiffness_apply(mesh, kappa, w), F)


def _jacobi(mesh: FEMesh, kappa) -> jax.Array:
    m = mesh.bc_mask
    diagA = m + (1.0 - m) * stiffness_diag(mesh, kappa)
    return 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def solve_poisson_cg(mesh: FEMesh, kappa, F: jax.Array,
                     tol: float = 0.0,
                     maxiter: Optional[int] = None) -> jax.Array:
    """Solve the BC-eliminated system K̃u = F̃ by matrix-free PCG.

    ``F`` is the assembled load (ops/assembly.py:assemble_load).  With
    ``tol=0`` runs exactly ``maxiter`` iterations (default: n_nodes) — the
    fixed-trip-count mode for batched solves.
    """
    return _cg_impl(mesh, kappa, F, tol, maxiter)


def _cg_impl(mesh, kappa, F, tol, maxiter):
    maxiter = maxiter if maxiter is not None else mesh.n_nodes
    applyK = _applyK_fixed(mesh, kappa)
    b = dirichlet_rhs(mesh, applyK, F)
    Minv = _jacobi(mesh, kappa)
    x0 = mesh.bc_mask * mesh.bc_values
    return _pcg(lambda v: apply_dirichlet_operator(mesh, applyK, v), b,
                Minv, jnp.broadcast_to(x0, b.shape), tol, maxiter)


def cg_diagnostics(mesh: FEMesh, kappa, F: jax.Array,
                   tol: float = 0.0, maxiter: Optional[int] = None):
    """Non-differentiable convergence report for the CG solve: returns
    (u, iterations_used, final_relative_residual).  Feeds the north-star
    metric table ('PCG iterations', SURVEY.md §5 observability)."""
    maxiter = maxiter if maxiter is not None else mesh.n_nodes
    b = _rhs(mesh, kappa, F)
    Minv = _jacobi(mesh, kappa)
    x0 = jnp.broadcast_to(mesh.bc_mask * mesh.bc_values, b.shape)
    x, iters, r = pcg(lambda v: _operator(mesh, kappa, v), b,
                      lambda r_: Minv * r_, x0, tol, maxiter,
                      with_diagnostics=True)
    bnorm2 = jnp.maximum(jnp.vdot(b, b), 1e-30)
    rel_res = jnp.sqrt(jnp.vdot(r, r) / bnorm2)
    return x, iters, rel_res


def _cg_fwd(mesh, kappa, F, tol, maxiter):
    u = _cg_impl(mesh, kappa, F, tol, maxiter)
    return u, (mesh, kappa, F, u)


def _cg_bwd(tol, maxiter, res, g):
    mesh, kappa, F, u = res
    maxit = maxiter if maxiter is not None else mesh.n_nodes
    applyK = _applyK_fixed(mesh, kappa)
    Minv = _jacobi(mesh, kappa)
    lam = _pcg(lambda v: apply_dirichlet_operator(mesh, applyK, v), g,
               Minv, jnp.zeros_like(g), tol, maxit)

    # Residual map at fixed u: R(mesh, κ, F) = b(mesh, κ, F) − A(mesh, κ)u.
    def residual(mesh_, kappa_, F_):
        return _rhs(mesh_, kappa_, F_) - _operator(mesh_, kappa_,
                                                   jax.lax.stop_gradient(u))

    _, vjp = jax.vjp(residual, mesh, kappa, F)
    return vjp(lam)


solve_poisson_cg.defvjp(_cg_fwd, _cg_bwd)


# --------------------------------------------------------------------------
# Robin (third-kind) BC variant: A = K + ∮αuv ds, b = F + ∮rv ds, all
# matrix-free.  The boundary mass is symmetric (ops/robin.py builds both
# (i,j) and (j,i) entries) so the adjoint reuses the same operator; the
# residual-map VJP carries gradients to α (robin.vals) and r (robin.load)
# alongside κ, f, geometry and BC values.
# --------------------------------------------------------------------------

def _robin_applyK(mesh, kappa, robin):
    from .robin import robin_apply
    return lambda w: stiffness_apply(mesh, kappa, w) + robin_apply(robin, w)


def _robin_operator(mesh, kappa, robin, v):
    return apply_dirichlet_operator(mesh, _robin_applyK(mesh, kappa, robin),
                                    v)


def _robin_rhs(mesh, kappa, robin, F):
    return dirichlet_rhs(mesh, _robin_applyK(mesh, kappa, robin),
                         F + robin.load)


def _robin_jacobi(mesh, kappa, robin):
    from .robin import robin_diag
    m = mesh.bc_mask
    diagA = m + (1.0 - m) * (stiffness_diag(mesh, kappa)
                             + robin_diag(mesh, robin))
    return 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)


def _cg_robin_impl(mesh, kappa, F, robin, tol, maxiter):
    maxiter = maxiter if maxiter is not None else mesh.n_nodes
    b = _robin_rhs(mesh, kappa, robin, F)
    Minv = _robin_jacobi(mesh, kappa, robin)
    x0 = mesh.bc_mask * mesh.bc_values
    return _pcg(lambda v: _robin_operator(mesh, kappa, robin, v), b, Minv,
                jnp.broadcast_to(x0, b.shape), tol, maxiter)


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def solve_poisson_cg_robin(mesh: FEMesh, kappa, F: jax.Array, robin,
                           tol: float = 0.0,
                           maxiter: Optional[int] = None) -> jax.Array:
    """Matrix-free PCG solve of (K + ∮αuv ds)u = F + ∮rv ds with Dirichlet
    elimination.  ``robin`` is an ops/robin.py RobinBC (unbatched — batched
    scenarios vmap via solver.solve_poisson_batched)."""
    return _cg_robin_impl(mesh, kappa, F, robin, tol, maxiter)


def _cg_robin_fwd(mesh, kappa, F, robin, tol, maxiter):
    u = _cg_robin_impl(mesh, kappa, F, robin, tol, maxiter)
    return u, (mesh, kappa, F, robin, u)


def _cg_robin_bwd(tol, maxiter, res, g):
    mesh, kappa, F, robin, u = res
    maxit = maxiter if maxiter is not None else mesh.n_nodes
    Minv = _robin_jacobi(mesh, kappa, robin)
    lam = _pcg(lambda v: _robin_operator(mesh, kappa, robin, v), g, Minv,
               jnp.zeros_like(g), tol, maxit)

    def residual(mesh_, kappa_, F_, robin_):
        u_fixed = jax.lax.stop_gradient(u)
        return (_robin_rhs(mesh_, kappa_, robin_, F_)
                - _robin_operator(mesh_, kappa_, robin_, u_fixed))

    _, vjp = jax.vjp(residual, mesh, kappa, F, robin)
    return vjp(lam)


solve_poisson_cg_robin.defvjp(_cg_robin_fwd, _cg_robin_bwd)


# --------------------------------------------------------------------------
# Shifted solve (diag(mass) + τ·K)u = F — the implicit-time-step system of
# control/heat.py at 2D scale (matrix-free, never materializes M + τK).
# --------------------------------------------------------------------------

def _shifted_operator(mesh, kappa, mass, tau, v):
    m = mesh.bc_mask
    p = 1.0 - m
    pv = p * v
    return m * v + p * (mass * pv + tau * stiffness_apply(mesh, kappa, pv))


def _shifted_rhs(mesh, kappa, mass, tau, F):
    m = mesh.bc_mask
    g = mesh.bc_values
    p = 1.0 - m
    mg = m * g
    return mg + p * (F - (mass * mg + tau * stiffness_apply(mesh, kappa, mg)))


def _shifted_jacobi(mesh, kappa, mass, tau):
    m = mesh.bc_mask
    diagA = m + (1.0 - m) * (mass + tau * stiffness_diag(mesh, kappa))
    return 1.0 / jnp.where(jnp.abs(diagA) > 1e-30, diagA, 1.0)


def _shifted_impl(mesh, kappa, mass, tau, F, tol, maxiter):
    maxiter = maxiter if maxiter is not None else mesh.n_nodes
    b = _shifted_rhs(mesh, kappa, mass, tau, F)
    Minv = _shifted_jacobi(mesh, kappa, mass, tau)
    x0 = jnp.broadcast_to(mesh.bc_mask * mesh.bc_values, b.shape)
    return _pcg(lambda v: _shifted_operator(mesh, kappa, mass, tau, v),
                b, Minv, x0, tol, maxiter)


@partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def solve_shifted_cg(mesh: FEMesh, kappa, mass: jax.Array, tau,
                     F: jax.Array, tol: float = 0.0,
                     maxiter: Optional[int] = None) -> jax.Array:
    """Solve (diag(mass) + τ·K(κ))u = F with Dirichlet elimination, by
    matrix-free Jacobi-PCG; IFT adjoint (gradients to κ, mass, τ, F,
    mesh geometry and BC values)."""
    return _shifted_impl(mesh, kappa, mass, tau, F, tol, maxiter)


def _shifted_fwd(mesh, kappa, mass, tau, F, tol, maxiter):
    u = _shifted_impl(mesh, kappa, mass, tau, F, tol, maxiter)
    return u, (mesh, kappa, mass, tau, F, u)


def _shifted_bwd(tol, maxiter, res, g):
    mesh, kappa, mass, tau, F, u = res
    maxit = maxiter if maxiter is not None else mesh.n_nodes
    Minv = _shifted_jacobi(mesh, kappa, mass, tau)
    lam = _pcg(lambda v: _shifted_operator(mesh, kappa, mass, tau, v),
               g, Minv, jnp.zeros_like(g), tol, maxit)

    def residual(mesh_, kappa_, mass_, tau_, F_):
        u_fixed = jax.lax.stop_gradient(u)
        return (_shifted_rhs(mesh_, kappa_, mass_, tau_, F_)
                - _shifted_operator(mesh_, kappa_, mass_, tau_, u_fixed))

    _, vjp = jax.vjp(residual, mesh, kappa, mass, tau, F)
    return vjp(lam)


solve_shifted_cg.defvjp(_shifted_fwd, _shifted_bwd)
