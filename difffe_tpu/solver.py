"""Differentiable FEM solver — functional core + ergonomic facade.

Capability parity with reference ``DifferentiableFESolver``
(/root/reference/diffhe/solver.py:22-183): solves −∇·(κ∇u) = f with
Dirichlet BCs on 1D interval / 2D triangle P1 meshes, with gradients flowing
to κ (and here also to f, node coordinates, and BC values).

Differences from the reference:
  * pure function ``solve_poisson(mesh, kappa, f)`` — jit/vmap/grad
    composable; the ``DifferentiableFESolver`` class is a thin wrapper kept
    for the reference's ergonomics (``solver(f)``).
  * batched scenarios are first-class: ``solve_poisson_batched`` vmaps over
    leading axes of κ and/or f (the reference solves one unbatched scenario
    per call, solver.py:49-67).
  * method='tridiag' uses the O(n)/O(log n) cyclic-reduction band solver for
    1D chain meshes; method='cg' uses matrix-free preconditioned CG (never
    materializes K); method='dense' assembles K and Cholesky-factorizes.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .mesh import FEMesh
from .ops.assembly import (
    assemble_load,
    assemble_stiffness_dense,
    assemble_tridiag_1d,
    stiffness_apply,
)
from .ops.solve import solve_dense
from .ops import tridiag as _tridiag
from .ops import cg as _cg


def _resolve_method(mesh: FEMesh, method: str, kappa=None,
                    structured_ok: bool = True) -> str:
    from .ops.assembly import element_family, is_tensor_kappa
    if method != "auto":
        return method
    if element_family(mesh) == "p1_line":
        return "tridiag"
    # Structured rectangle/box meshes carry their grid metadata
    # (FEMesh.grid): route to the closed-form stencil operators
    # (ops/stencil.py, ops/stencil3d.py) whenever the problem fits them
    # (isotropic κ, no Neumann/Robin terms, factory Dirichlet boundary).
    if (structured_ok and mesh.grid is not None
            and (kappa is None or not is_tensor_kappa(mesh, kappa))):
        return "stencil"
    # P2 / unstructured: dense Cholesky up to moderate size, matrix-free CG
    # beyond
    return "dense" if mesh.n_nodes <= 4096 else "cg"


def _cg_policy(mesh: FEMesh, cg_tol, cg_maxiter):
    """Default iteration policy for the public CG surface.

    Unspecified ``cg_tol`` means "converge to a dtype-appropriate relative
    residual (1e-6 f32 / 1e-12 f64) with a capped iteration budget" — the
    ergonomic mode: the while_loop exits as soon as the tolerance is met,
    and the cap (≈10·√n, the O(√cond) Jacobi-PCG growth rate for Poisson)
    prevents the old n_nodes-iteration trap (4,225 matvecs on a 64×64
    mesh).  Production batched solves should pass ``cg_tol=0.0`` with an
    explicit ``cg_maxiter`` — the fixed-trip-count mode where every
    scenario runs the same schedule (golden behavior, unchanged and still
    reachable)."""
    if cg_tol is None:
        cg_tol = 1e-12 if mesh.dtype == jnp.float64 else 1e-6
    if cg_maxiter is None and cg_tol > 0.0:
        import math
        n = mesh.n_nodes
        cg_maxiter = min(n, max(64, 10 * math.isqrt(n)))
    return cg_tol, cg_maxiter


def _mask_is_factory(mesh: FEMesh) -> bool:
    """True when the mesh's Dirichlet set is the factory full boundary
    (the assumption of the specialized stencil solvers).  Traced masks
    (mesh inside jit) are assumed factory — the factories are the only
    producers of grid metadata."""
    import numpy as np
    try:
        mask = np.asarray(mesh.bc_mask) > 0.5
    except jax.errors.TracerArrayConversionError:
        return True
    # build the factory boundary mask in pure numpy: under jit tracing
    # every jnp op stages to a tracer even on concrete inputs, and this
    # check must stay host-side
    grid = mesh.grid
    shape = grid.node_shape
    factory = np.zeros(shape, bool)
    for ax in range(len(shape)):
        sl_lo = [slice(None)] * len(shape)
        sl_lo[ax] = 0
        sl_hi = [slice(None)] * len(shape)
        sl_hi[ax] = -1
        factory[tuple(sl_lo)] = True
        factory[tuple(sl_hi)] = True
    return bool((mask.reshape(shape) == factory).all())


def _solve_stencil(mesh: FEMesh, kappa, f: jax.Array,
                   cg_tol: float, cg_maxiter: int,
                   neumann=None, robin=None) -> jax.Array:
    """Route one scenario onto the closed-form structured stencil solvers.

    κ in any facade form (scalar / per-element / per-node) is converted to
    the stencil paths' per-triangle (2D) or per-tet (3D) fields with the
    SAME rules the generic assembly uses (ops/assembly.py:
    kappa_on_elements — per-node κ averages over element vertices), so the
    routed solve matches the generic paths numerically; flat node vectors
    reshape to the node grid and back.  All conversions are differentiable,
    and the stencil solvers carry IFT custom VJPs, so gradients flow to κ,
    f, and the mesh's Dirichlet values exactly as on the generic paths.

    2D natural BCs and non-factory Dirichlet masks route to the
    generalized-mask solver (ops/stencil_natural.py) — flux-BC users
    keep the stencil operator class (VERDICT-r4 item 4); a Robin pattern
    that doesn't fold into the 7-point stencil raises ValueError (the
    ``auto`` caller falls back to the generic path)."""
    from .ops.assembly import kappa_on_elements
    grid = mesh.grid
    ke = kappa_on_elements(mesh, kappa)
    g = mesh.bc_values.reshape(grid.node_shape)
    fg = f.reshape(f.shape[:-1] + grid.node_shape)
    natural = (neumann is not None or robin is not None
               or not _mask_is_factory(mesh))
    if mesh.dim == 2:
        from .ops.stencil import kappa_lu_from_elements, \
            solve_poisson_structured
        klu = kappa_lu_from_elements(grid, ke)
        if natural:
            from .ops.stencil_natural import (fold_robin_planes,
                                              solve_poisson_structured_natural)
            m = mesh.bc_mask.reshape(grid.node_shape).astype(fg.dtype)
            qn = None if neumann is None else jnp.asarray(
                neumann, fg.dtype).reshape(
                    jnp.shape(neumann)[:-1] + grid.node_shape)
            C_r = rload = None
            if robin is not None:
                C_r, rload = fold_robin_planes(grid, robin.rows,
                                               robin.cols, robin.vals,
                                               robin.load)
            u = solve_poisson_structured_natural(
                grid, klu, fg, g, m, qn, C_r, rload, cg_tol, cg_maxiter)
        else:
            u = solve_poisson_structured(grid, klu, fg, g, cg_tol,
                                         cg_maxiter)
    else:
        if natural:
            raise ValueError(
                "the 3D structured stencil path supports the factory "
                "Dirichlet boundary only (no Neumann/Robin); use "
                "method='cg' or 'dense'")
        from .ops.stencil3d import solve_poisson_structured_3d
        u = solve_poisson_structured_3d(grid, ke, fg, g, cg_tol, cg_maxiter)
    return u.reshape(u.shape[:-len(grid.node_shape)] + (mesh.n_nodes,))


def solve_poisson(
    mesh: FEMesh,
    kappa,
    f: jax.Array,
    method: str = "auto",
    cg_tol: Optional[float] = None,
    cg_maxiter: Optional[int] = None,
    bc_values=None,
    neumann=None,
    robin=None,
) -> jax.Array:
    """Solve −∇·(κ∇u) = f on ``mesh`` with its Dirichlet BCs.

    Parameters
    ----------
    kappa : scalar, (n_elements,), or (n_nodes,) diffusion coefficient;
        on 2D/3D P1 meshes also a diffusion TENSOR for anisotropic
        −∇·(A∇u) = f — (d, d) constant, (n_elements, d, d), or
        (n_nodes, d, d) with d = mesh.dim, dense/lu/cg methods (beyond
        the reference, which supports 0-dim κ only — solver.py:29 vs its
        RuntimeError).  Tensor κ never takes the structured stencil
        route (the 5-/7-point reductions are isotropic-only);
        method='auto' handles the fallback.
    f : (n_nodes,) nodal forcing values.
    method : 'auto' | 'dense' | 'lu' | 'tridiag' | 'cg' | 'stencil'.
        'auto' picks the fastest path the problem fits: tridiag for 1D
        chains, the closed-form structured stencil solvers for
        ``FEMesh.rectangle``/``FEMesh.box`` meshes (isotropic κ; 2D also
        with Neumann/Robin), dense Cholesky / matrix-free CG otherwise.
    bc_values : optional (n_nodes,) override of the mesh's Dirichlet values
        (per-scenario BC perturbations batch via ``solve_poisson_batched``).
    neumann : optional (n_nodes,) natural-BC boundary load (built with
        ops/neumann.py helpers), added to F before Dirichlet elimination.
    robin : optional ops/robin.py RobinBC — adds the ∮αuv ds boundary
        stiffness and ∮rv ds load (dense/lu and matrix-free cg always;
        tridiag when diagonal-only, i.e. 1D point Robin).

    Returns ``u`` of shape (n_nodes,).  Differentiable wrt kappa, f, mesh
    coordinates, and BC values.
    """
    f = jnp.asarray(f, dtype=mesh.dtype)
    # Natural BCs no longer forfeit the 2D structured fast path: the
    # generalized-mask stencil solver (ops/stencil_natural.py) folds
    # Neumann loads and grid-adjacent Robin terms into the operator
    # planes.  3D keeps the factory-Dirichlet-only specialization.
    natural_requested = neumann is not None or robin is not None
    structured_ok = (not natural_requested) or mesh.dim == 2
    was_auto = method == "auto"
    method = _resolve_method(mesh, method, kappa=kappa,
                             structured_ok=structured_ok)
    if was_auto and method == "stencil" and robin is not None:
        # foldability is a static property of the Robin pattern — probe it
        # now so ``auto`` can fall back to the generic paths instead of
        # raising from inside the routed solve
        try:
            from .ops.stencil_natural import fold_robin_planes
            fold_robin_planes(mesh.grid, robin.rows, robin.cols,
                              robin.vals, robin.load)
        except ValueError:
            method = "dense" if mesh.n_nodes <= 4096 else "cg"

    # Pure-Neumann problems are singular (constant nullspace) — roundoff can
    # make the factorization "succeed" with garbage, so refuse eagerly when
    # the mesh is concrete (traced meshes skip the check).  A Robin term
    # regularizes the nullspace (α > 0 pins the solution), so the guard
    # only applies without one.
    if robin is None:
        try:
            if mesh.n_dirichlet == 0:
                raise ValueError(
                    "mesh has no Dirichlet nodes: the Poisson system is "
                    "singular (constant nullspace). Pin at least one node "
                    "(FEMesh.with_dirichlet), add a Robin term, or "
                    "formulate a regularized solve.")
        except jax.errors.TracerArrayConversionError:
            pass

    if method == "tridiag":
        if mesh.dim != 1:
            raise ValueError(f"method={method!r} requires a 1D mesh")
        d, e = assemble_tridiag_1d(mesh, kappa)
        F = assemble_load(mesh, f)
        if neumann is not None:
            F = F + jnp.asarray(neumann, dtype=mesh.dtype)
        if robin is not None:
            if not robin.diagonal_only:
                raise ValueError("tridiagonal path supports diagonal-only "
                                 "Robin terms (1D point Robin); use "
                                 "method='dense' for edge Robin")
            from .ops.robin import robin_diag
            d = d + robin_diag(mesh, robin)
            F = F + robin.load
        return _tridiag.solve_poisson_tridiag(mesh, d, e, F,
                                              bc_values=bc_values)

    if bc_values is not None:
        # dense/cg/stencil paths read BCs from the mesh pytree — substitute
        import dataclasses as _dc
        mesh = _dc.replace(mesh,
                           bc_values=jnp.asarray(bc_values, mesh.dtype))

    if method == "stencil":
        if mesh.grid is None:
            raise ValueError(
                "method='stencil' requires structured-grid metadata "
                "(a mesh built by FEMesh.rectangle or FEMesh.box whose "
                "Dirichlet set is the factory boundary); use method='cg' "
                "or 'dense' for general meshes")
        cg_tol, cg_maxiter = _cg_policy(mesh, cg_tol, cg_maxiter)
        return _solve_stencil(mesh, kappa, f, cg_tol, cg_maxiter,
                              neumann=neumann, robin=robin)

    if method == "cg":
        cg_tol, cg_maxiter = _cg_policy(mesh, cg_tol, cg_maxiter)
        F = assemble_load(mesh, f)
        if neumann is not None:
            F = F + jnp.asarray(neumann, dtype=mesh.dtype)
        # custom_vjp functions take positional args only
        if robin is not None:
            return _cg.solve_poisson_cg_robin(mesh, kappa, F, robin,
                                              cg_tol, cg_maxiter)
        return _cg.solve_poisson_cg(mesh, kappa, F, cg_tol, cg_maxiter)

    if method in ("dense", "lu"):
        K = assemble_stiffness_dense(mesh, kappa)
        F = assemble_load(mesh, f)
        if neumann is not None:
            F = F + jnp.asarray(neumann, dtype=mesh.dtype)
        if robin is not None:
            from .ops.robin import robin_matrix_dense
            K = K + robin_matrix_dense(mesh, robin)
            F = F + robin.load
        return solve_dense(mesh, K, F,
                           factor="cholesky" if method == "dense" else "lu")

    raise ValueError(f"Unknown method {method!r}")


def solve_poisson_batched(
    mesh: FEMesh,
    kappa,
    f: jax.Array,
    method: str = "auto",
    bc_values=None,
    kappa_batched: Optional[bool] = None,
    **kw,
) -> jax.Array:
    """Batched scenarios: κ (B, …), f (B, n_nodes), and/or Dirichlet values
    ``bc_values`` (B, n_nodes) → u (B, n_nodes).

    Any argument may be unbatched (broadcast across the batch).  κ fields,
    forcings, and BC perturbations are exactly the three scenario axes the
    north star names (BASELINE.json; SURVEY.md §2b 'scenario-batch
    parallelism').

    A 1-D κ of length B is a batch of per-scenario scalars; of length
    n_elements/n_nodes it is one shared field.  When B happens to equal
    n_elements or n_nodes the two readings collide — pass
    ``kappa_batched=True/False`` explicitly (the ambiguity raises rather
    than guessing).
    """
    kappa = jnp.asarray(kappa, dtype=mesh.dtype)
    f = jnp.asarray(f, dtype=mesh.dtype)
    if bc_values is not None:
        bc_values = jnp.asarray(bc_values, dtype=mesh.dtype)
    f_batched = f.ndim >= 2
    g_batched = bc_values is not None and bc_values.ndim >= 2
    # Neumann loads and Robin α/r are scenario axes too (SURVEY.md §2b):
    # batched even when κ/f/bc are shared.
    _nm = kw.get("neumann", None)
    _nm_b = _nm is not None and jnp.asarray(_nm).ndim >= 2
    _rb = kw.get("robin", None)
    _rb_b = _rb is not None and (_rb.vals.ndim >= 2 or _rb.load.ndim >= 2)

    # Tensor (anisotropic) κ carries trailing (2, 2) dims that are not
    # batch axes — batch detection runs on the core shape in front of them.
    from .ops.assembly import is_tensor_kappa
    k_core = kappa.shape[:-2] if is_tensor_kappa(mesh, kappa) \
        else kappa.shape
    if kappa_batched is not None:
        k_batched = kappa_batched and len(k_core) >= 1
    elif len(k_core) == 2:
        k_batched = True
    elif len(k_core) == 1:
        L = k_core[0]
        looks_field = L in (mesh.n_elements, mesh.n_nodes)
        batch_sizes = ({f.shape[0]} if f_batched else set()) | (
            {bc_values.shape[0]} if g_batched else set())
        looks_batch = (not batch_sizes and not looks_field) or \
            (L in batch_sizes)
        if looks_field and looks_batch:
            raise ValueError(
                f"ambiguous kappa lead dim of length {L}: could be a shared "
                f"per-element/per-node field or B={L} per-scenario values "
                f"— pass kappa_batched=True (batch) or False (field)")
        k_batched = looks_batch and not looks_field
    else:
        k_batched = False

    if not (k_batched or f_batched or g_batched or _nm_b or _rb_b):
        return solve_poisson(mesh, kappa, f, method=method,
                             bc_values=bc_values, **kw)

    _nat = _nm is not None or _rb is not None
    method = _resolve_method(mesh, method, kappa=kappa,
                             structured_ok=(not _nat) or mesh.dim == 2)
    if method == "stencil" and _rb is not None:
        try:
            from .ops.stencil_natural import fold_robin_planes
            fold_robin_planes(mesh.grid, _rb.rows, _rb.cols, _rb.vals,
                              _rb.load)
        except ValueError:
            method = "dense" if mesh.n_nodes <= 4096 else "cg"

    if (method == "stencil" and mesh.dim == 3 and f_batched
            and not (g_batched or _nm_b or _rb_b)
            and kw.get("neumann") is None and kw.get("robin") is None
            and _mask_is_factory(mesh)
            and f.shape[0] >= 128):
        # Batch-minor layout: the scenario batch stays the trailing axis
        # through the whole CG (ops/stencil3d.py module note).  B ≥ 128
        # is the choose_3d_path threshold, a layout rule for the
        # benchmark to re-decide (ROADMAP); below it the per-scenario
        # vmap fallthrough runs.
        from .ops.assembly import kappa_on_elements
        from .ops.stencil3d import solve_poisson_structured_3d_batched
        grid = mesh.grid
        B = f.shape[0]
        tol, maxiter = _cg_policy(mesh, kw.get("cg_tol"),
                                  kw.get("cg_maxiter"))
        if k_batched:
            keB = jnp.broadcast_to(kappa[:, None], (B, mesh.n_elements)) \
                if kappa.ndim == 1 \
                else jax.vmap(lambda k: kappa_on_elements(mesh, k))(kappa)
        else:
            keB = jnp.broadcast_to(kappa_on_elements(mesh, kappa),
                                   (B, mesh.n_elements))
        g = mesh.bc_values if bc_values is None else bc_values
        u = solve_poisson_structured_3d_batched(
            grid, keB, f.reshape((B,) + grid.node_shape),
            g.reshape(grid.node_shape), tol, maxiter)
        return u.reshape(B, mesh.n_nodes)

    if method == "tridiag" and mesh.dim == 1:
        # Fast path: assemble batched bands directly — no vmap, one fused
        # batched PCR over the whole scenario block.
        if k_batched and kappa.ndim == 1:
            # (B,) scalar-per-scenario → (B, n_elements)
            kappa = jnp.broadcast_to(kappa[:, None],
                                     (kappa.shape[0], mesh.n_elements))
        d, e = assemble_tridiag_1d(mesh, kappa)
        F = assemble_load(mesh, f)
        neumann = kw.pop("neumann", None)
        if neumann is not None:
            # supports batched (B, n) natural-BC loads too
            F = F + jnp.asarray(neumann, dtype=mesh.dtype)
        robin = kw.pop("robin", None)
        if robin is not None:
            if not robin.diagonal_only:
                raise ValueError("tridiagonal path supports diagonal-only "
                                 "Robin terms; use method='dense'")
            from .ops.robin import robin_diag
            # robin_diag/load carry any per-scenario lead dims of α, r
            d = d + robin_diag(mesh, robin)
            F = F + robin.load
        lead = jnp.broadcast_shapes(d.shape[:-1], F.shape[:-1],
                                    bc_values.shape[:-1]
                                    if g_batched else ())
        F = jnp.broadcast_to(F, lead + F.shape[-1:])
        d = jnp.broadcast_to(d, lead + d.shape[-1:])
        e = jnp.broadcast_to(e, lead + e.shape[-1:])
        return _tridiag.solve_poisson_tridiag(mesh, d, e, F,
                                              bc_values=bc_values)

    neumann = kw.pop("neumann", None)
    if neumann is not None:
        neumann = jnp.asarray(neumann, dtype=mesh.dtype)
    nm_batched = neumann is not None and neumann.ndim >= 2
    robin = kw.pop("robin", None)
    # Per-scenario Robin: a RobinBC whose vals/load carry a leading batch
    # axis (built with batched α / r) vmaps alongside κ, f, bc, neumann;
    # rows/cols stay shared (static sparsity pattern).
    rb_batched = robin is not None and (robin.vals.ndim >= 2
                                        or robin.load.ndim >= 2)
    if rb_batched:
        import dataclasses as _dc
        rb_axes = _dc.replace(
            robin, rows=None, cols=None,
            vals=0 if robin.vals.ndim >= 2 else None,
            load=0 if robin.load.ndim >= 2 else None)
    else:
        rb_axes = None
    fn = lambda k, ff, g, nm, rb: solve_poisson(
        mesh, k, ff, method=method, bc_values=g, neumann=nm,
        robin=rb if rb is not None else robin, **kw)
    return jax.vmap(fn, in_axes=(0 if k_batched else None,
                                 0 if f_batched else None,
                                 0 if g_batched else None,
                                 0 if nm_batched else None,
                                 rb_axes))(
        kappa, f, bc_values, neumann, robin if rb_batched else None)


class DifferentiableFESolver:
    """Ergonomic wrapper matching the reference's ``solver(f)`` call shape.

    Unlike the reference nn.Module (solver.py:22-46) this holds no trainable
    state — κ is stored as a plain array and gradients are taken through the
    functional API (``jax.grad`` over ``solve_poisson``).
    """

    def __init__(self, mesh: FEMesh, kappa=1.0, method: str = "auto"):
        self.mesh = mesh
        self._kappa = jnp.asarray(kappa, dtype=mesh.dtype)
        self.method = method

    @property
    def kappa(self) -> jax.Array:
        return self._kappa

    def __call__(self, f: jax.Array) -> jax.Array:
        f = jnp.asarray(f, dtype=self.mesh.dtype)
        if f.ndim >= 2:
            return solve_poisson_batched(self.mesh, self._kappa, f,
                                         method=self.method)
        return solve_poisson(self.mesh, self._kappa, f, method=self.method)

    # torch-style alias used by reference call sites (solver.py:49)
    forward = __call__
