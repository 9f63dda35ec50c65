"""Inverse problems: κ recovery to sub-1e-6 fidelity (BASELINE gate).

The reference's demo recovers a scalar κ with 200 Adam steps to ~4-decimal
accuracy (/root/reference/examples/poisson_1d_demo.py:102-112).  The north
star demands **<1e-6 error vs the reference optimum** (BASELINE.md).  Adam
alone stalls near its step-size floor, so the production recovery here is
Adam warmup + Gauss-Newton polish: for the scalar (or low-dimensional) κ
case a handful of Newton steps on the least-squares objective converge
quadratically to machine-level optima — each step reuses the same
custom-VJP solves (jax.grad / jax.hessian of the batched objective).

Everything is jitted and scenario-batched: B independent recoveries run as
one program.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .mesh import FEMesh
from .solver import solve_poisson_batched


def recover_kappa_scalar(
    mesh: FEMesh,
    f: jax.Array,
    u_data: jax.Array,
    kappa0: Optional[jax.Array] = None,
    adam_steps: int = 100,
    newton_steps: int = 6,
    lr: float = 0.1,
    method: str = "auto",
) -> Tuple[jax.Array, jax.Array]:
    """Recover per-scenario scalar κ from observed solutions.

    f, u_data: (B, n_nodes); returns (κ (B,), per-scenario final losses).
    Parameterized as log κ for positivity.  Adam warmup gets near the basin;
    per-scenario scalar Newton (1D second derivative, safeguarded) polishes
    to <1e-6 (quadratic convergence on a smooth least-squares objective).
    """
    B = f.shape[0]
    dtype = mesh.dtype
    log_k = jnp.zeros((B,), dtype) if kappa0 is None \
        else jnp.log(jnp.asarray(kappa0, dtype))

    def per_scenario_loss(log_k):
        u = solve_poisson_batched(mesh, jnp.exp(log_k), f, method=method,
                                  kappa_batched=True)
        return jnp.mean((u - u_data) ** 2, axis=-1)      # (B,)

    total_loss = lambda lk: jnp.sum(per_scenario_loss(lk))

    opt = optax.adam(lr)

    @jax.jit
    def run(log_k):
        state = opt.init(log_k)

        def adam_step(carry, _):
            lk, st = carry
            g = jax.grad(total_loss)(lk)
            upd, st = opt.update(g, st)
            return (optax.apply_updates(lk, upd), st), None

        (log_k, _), _ = jax.lax.scan(adam_step, (log_k, state), None,
                                     length=adam_steps)

        def newton_step(lk, _):
            # the loss separates over scenarios, so the Hessian of
            # total_loss is diagonal and H·1 extracts exactly the
            # per-scenario second derivatives.  Reverse-over-reverse HVP
            # (forward mode is unavailable through custom_vjp solves).
            g = jax.grad(total_loss)(lk)
            hdiag = jax.grad(
                lambda v: jnp.vdot(jax.grad(total_loss)(v),
                                   jnp.ones_like(v)))(lk)
            step = jnp.where(hdiag > 0,
                             g / jnp.where(hdiag > 0, hdiag, 1.0),
                             jnp.sign(g) * 0.1)
            step = jnp.clip(step, -0.5, 0.5)              # safeguard
            return lk - step, None

        log_k, _ = jax.lax.scan(newton_step, log_k, None,
                                length=newton_steps)
        return log_k, per_scenario_loss(log_k)

    log_k, losses = run(log_k)
    return jnp.exp(log_k), losses


#: longest 1D chain the Pallas-Triton kernel serves.  One block row holds
#: a scenario's whole chain; on an H100 (700 W) the kernel was faster end
#: to end up to 8,192 elements and slower at 16,384, where its 8-warp
#: rows spill registers (scripts/tune_cf_chain.py, docs/PERFORMANCE.md)
CHAIN_MAX_ELEMENTS = 8192


def fit_route(dim: int, backend: str, shared_forcing: bool = True,
              n_elements: Optional[int] = None) -> str:
    """The route ``fit_kappa`` takes for a factory ``FEMesh.line`` /
    ``rectangle`` / ``box`` mesh of dimension ``dim`` on ``backend``
    (``jax.default_backend()``).

    1D with a shared forcing and at most :data:`CHAIN_MAX_ELEMENTS`
    elements runs the Pallas-Triton SGD chain on a GPU, and the XLA
    closed form otherwise (the kernel is compiled for the card only;
    tests run it with ``interpret=True``).  2D and 3D run the XLA
    stencil grad steps on every backend."""
    if dim == 1:
        if (backend == "gpu" and shared_forcing
                and (n_elements or 0) <= CHAIN_MAX_ELEMENTS):
            return "cf_chain_triton"
        return "cf_xla"
    if dim == 2:
        return "stencil2d_xla"
    if dim == 3:
        return "stencil3d_batchminor"
    raise ValueError(f"no structured fit route for dim={dim}")


def fit_kappa(
    mesh: FEMesh,
    f: jax.Array,
    u_data: jax.Array,
    steps: int = 100,
    lr: Optional[float] = None,
    kappa0: Optional[jax.Array] = None,
    iters: Optional[int] = None,
    warm: Optional[bool] = None,
    eval_final: bool = True,
) -> Tuple[jax.Array, dict]:
    """Per-element κ-field inversion on the structured fast paths.

    THE one inversion-loop API: routes the SGD loop onto the structured
    solver this mesh fits (:func:`fit_route`) and encodes the iteration
    policy, so default users get it without knowing the lore:

    * ``FEMesh.line`` meshes (two-end Dirichlet) → the exact closed-form
      prefix-sum solve (ops/cf1d.py): with a shared forcing, 32 SGD steps
      per launch of the Pallas-Triton chain kernel on a GPU
      (ops/pallas/fused_grad_cf_kernel.py), else one XLA step per scan
      iteration.  No iteration policy exists because the solve is exact.
    * ``FEMesh.rectangle`` meshes → the XLA stencil grad step
      (ops/stencil.kappa_mse_grad_step_2d) with **warm-started steps
      graded by grid size** — iters 32 (≤64²) / 8 (128²) / 4 (≥256²);
      cold-32 reaches a 45% worse converged eval loss than warm-32 at
      64² after the same steps (docs/PERFORMANCE.md).
    * ``FEMesh.box`` meshes → the batch-minor 7-point-stencil grad step
      (ops/stencil3d.kappa_mse_grad_step_3d) with **cold steps graded by
      grid size** — iters 32 (≤16³) / 100 (≥32³), the κ-error-safe
      defaults from the identifiable controls
      (scripts/probe_3d_control.py: at 16³ cold-32 ≡ cold-100; at 32³
      cold-32 caps κ error 18× worse — iteration requirements grow with
      the grid; warm starts did not help in 3D).
    * any other mesh with B ≥ 128 → the batch-minor edge-ELL CG route
      (``generic_ell_batchminor``, Adam on log κ).
    * anything else → the generic Adam field recovery
      (:func:`recover_kappa_field`).

    Parameters
    ----------
    f, u_data : (B, n_nodes) batched forcings and observed solutions
        (flat facade layout; a single (n_nodes,) scenario is promoted to
        B=1).
    steps : SGD steps.
    lr : SGD learning rate.  Defaults to the tuned values (1D and 2D:
        30.0 with the per-scenario-mean cotangent scale; 3D: 100.0, tuned
        at B=256 — the 3D loss averages over the batch, so the default
        rescales lr by B/256).
    iters, warm : override the per-step CG iteration count and
        warm-start policy (defaults 2D: graded 32/8/4 with warm=True;
        3D: graded 32/100 with warm=False).
    eval_final : additionally run one CONVERGED solve at the final κ and
        report the honest eval loss (the in-loop loss uses the step's own
        possibly-unconverged u) — the 'periodic converged check' gate.

    Returns ``(kappa, info)``: κ (B, n_elements) flat in mesh element
    order, and an info dict with ``path``, ``iters``, ``warm``,
    ``loss_history`` (steps,), and ``eval_loss``.
    """
    f = jnp.asarray(f, mesh.dtype)
    u_data = jnp.asarray(u_data, mesh.dtype)
    if f.ndim == 1:
        f, u_data = f[None], u_data[None]
    B = f.shape[0]
    grid = getattr(mesh, "grid", None)
    if grid is not None:
        # the structured inversion loops assume the factory full-boundary
        # Dirichlet mask; a replaced mask (partial Dirichlet, interior
        # pins) keeps grid metadata but must take the generic routes
        from .solver import _mask_is_factory
        if not _mask_is_factory(mesh):
            grid = None

    if mesh.dim == 1:
        from .ops.cf1d import mesh_supports_cf
        if mesh_supports_cf(mesh):
            return _fit_kappa_1d(mesh, f, u_data, steps, lr, kappa0,
                                 eval_final)

    if grid is None or mesh.dim not in (2, 3):
        if B >= 128 and mesh.dim in (2, 3):
            # batch-minor edge-ELL CG once the scenario batch is large
            # (the threshold is a layout rule for the benchmark to
            # re-decide, ROADMAP)
            return _fit_kappa_ell(mesh, f, u_data, steps, lr, kappa0,
                                  iters, eval_final)
        kappa, hist = recover_kappa_field(mesh, f, u_data,
                                          adam_steps=steps,
                                          lr=lr if lr is not None else 0.05)
        info = {"path": "generic_adam", "iters": None, "warm": None,
                "loss_history": hist, "eval_loss": None}
        if eval_final:
            u = solve_poisson_batched(mesh, kappa, f)
            info["eval_loss"] = float(jnp.mean((u - u_data) ** 2))
        return kappa, info

    if mesh.dim == 2:
        return _fit_kappa_2d(mesh, grid, f, u_data, steps, lr, kappa0,
                             iters, warm, eval_final)
    return _fit_kappa_3d(mesh, grid, f, u_data, steps, lr, kappa0,
                         iters, warm, eval_final)


import functools as _ft


@_ft.lru_cache(maxsize=64)
def _build_loop_2d(grid, iters, warm, lr, scale, steps):
    """Jitted 2D SGD inversion loop, CACHED on the static configuration —
    repeated fit_kappa calls with the same shapes hit the same
    executable (the CLI timing run relies on this)."""
    from .ops.stencil import kappa_mse_grad_step_2d

    def step(args, kl, ku, state):
        fg, g0, ug = args
        lp, (gl, gu), state = kappa_mse_grad_step_2d(
            grid, (kl, ku), fg, g0, ug, iters, scale=scale,
            warm_state=state if warm else None, return_state=True)
        # history in MSE units (mean over scenarios AND nodes), so it is
        # directly comparable to the converged ``eval_loss``
        return (kl - lr * gl, ku - lr * gu, state), \
            (scale / 2.0) * lp.mean()

    def body(args, carry, _):
        return step(args, *carry)

    @jax.jit
    def loop(kl, ku, fg, g0, ug):
        # cold first step supplies the state structure for the scan
        carry, loss0 = step((fg, g0, ug), kl, ku, None)
        (kl, ku, _), losses = jax.lax.scan(
            _ft.partial(body, (fg, g0, ug)), carry, None,
            length=max(steps - 1, 0))
        return kl, ku, jnp.concatenate([loss0[None], losses])

    return loop


@_ft.lru_cache(maxsize=64)
def _build_eval_2d(grid, maxiter):
    from .ops.stencil import solve_poisson_structured

    @jax.jit
    def ev(kl, ku, fg, g0, ug):
        u = jax.vmap(lambda a, b, ff: solve_poisson_structured(
            grid, (a, b), ff, g0, 0.0, maxiter))(kl, ku, fg)
        return jnp.mean((u - ug) ** 2)

    return ev


def _fit_kappa_2d(mesh, grid, f, u_data, steps, lr, kappa0, iters, warm,
                  eval_final):
    from .ops.stencil import kappa_lu_from_elements

    B = f.shape[0]
    H, W = grid.node_shape
    if iters is None:
        # Per-step warm-iteration policy (converged-eval gated): 64² —
        # warm-32 is the accuracy-safe point (cold-32 is 45% worse,
        # warm-16 costs ~6% loss); 128² — warm-8 matches warm-32's eval
        # loss (1.13e-2 vs 1.30e-2); ≥256² — warm-4 matches-or-beats
        # warm-32.  Bigger grids carry proportionally more of the
        # solution in the warm state per SGD step.
        n_side = max(grid.nx, grid.ny)
        iters = 32 if n_side <= 64 else (8 if n_side <= 128 else 4)
    warm = True if warm is None else warm
    lr = 30.0 if lr is None else lr
    # per-scenario-mean cotangent scale → gradient magnitude independent
    # of B (lr tuned once at this scale)
    scale = 2.0 / (H * W)
    fg = f.reshape(B, H, W)
    ug = u_data.reshape(B, H, W)
    g0 = mesh.bc_values.reshape(H, W)
    if kappa0 is None:
        kl0 = jnp.ones((B, grid.ny, grid.nx), mesh.dtype)
        ku0 = kl0
    else:
        kl0, ku0 = kappa_lu_from_elements(
            grid, jnp.broadcast_to(jnp.asarray(kappa0, mesh.dtype),
                                   (B, mesh.n_elements)))

    loop = _build_loop_2d(grid, iters, warm, float(lr), float(scale), steps)
    kl, ku, losses = loop(kl0, ku0, fg, g0, ug)
    kappa = jnp.stack([kl, ku], axis=-1).reshape(B, mesh.n_elements)
    info = {"path": fit_route(2, jax.default_backend()), "iters": iters,
            "warm": warm, "loss_history": losses, "eval_loss": None}
    if eval_final:
        ev = _build_eval_2d(grid, max(4 * iters, 256))
        info["eval_loss"] = float(ev(kl, ku, fg, g0, ug))
    return kappa, info


def _fit_kappa_ell(mesh, f, u_data, steps, lr, kappa0, iters, eval_final):
    """Generic-mesh inversion on the batch-minor edge-ELL path (B ≥ 128).

    Adam on log κ (positivity), fixed-trip CG through the gather-only
    operator (docs/PERFORMANCE.md 'Unstructured meshes').  The jitted
    loop closes over the mesh's gather tables, so repeat calls with a
    different mesh recompile (the structured paths are cached)."""
    import optax

    from .ops.assembly import assemble_load
    from .ops.unstructured import build_ell, solve_poisson_cg_ell_batched

    B = f.shape[0]
    iters = 128 if iters is None else iters
    lr = 0.05 if lr is None else lr
    ell = build_ell(mesh)
    FB = assemble_load(mesh, f)
    log_k0 = jnp.zeros((B, mesh.n_elements), mesh.dtype) \
        if kappa0 is None else jnp.log(jnp.broadcast_to(
            jnp.asarray(kappa0, mesh.dtype), (B, mesh.n_elements)))
    opt = optax.adam(lr)

    def loss_fn(lk):
        u = solve_poisson_cg_ell_batched(mesh, ell, jnp.exp(lk), FB,
                                         0.0, iters)
        return jnp.mean((u - u_data) ** 2)

    @jax.jit
    def loop(lk):
        def body(carry, _):
            lk, st = carry
            loss, g = jax.value_and_grad(loss_fn)(lk)
            upd, st = opt.update(g, st)
            return (optax.apply_updates(lk, upd), st), loss

        (lk, _), losses = jax.lax.scan(body, (lk, opt.init(lk)), None,
                                       length=steps)
        return lk, losses

    lk, losses = loop(log_k0)
    kappa = jnp.exp(lk)
    info = {"path": "generic_ell_batchminor", "iters": iters,
            "warm": None, "loss_history": losses, "eval_loss": None}
    if eval_final:
        u = solve_poisson_cg_ell_batched(mesh, ell, kappa, FB, 0.0,
                                         max(2 * iters, 256))
        info["eval_loss"] = float(jnp.mean((u - u_data) ** 2))
    return kappa, info


@_ft.lru_cache(maxsize=64)
def _build_loop_1d_chain(n_full, k, rem, lr, scale, interpret):
    """Jitted 1D chain-kernel SGD loop, cached on the static config.

    The chain kernel runs ``k`` SGD steps per launch; the loop scans
    n_full launches plus one remainder launch so exactly n_full·k + rem
    steps execute.  Loss history is per LAUNCH (the kernel reports the
    last inner step's loss)."""
    from .ops.pallas.fused_grad_cf_kernel import kappa_sgd_chain_cf

    @jax.jit
    def loop(keP, ops):
        def launch(keP, _):
            lp, keP = kappa_sgd_chain_cf(keP, ops, k, lr, scale=scale,
                                         interpret=interpret)
            return keP, lp.mean() / ops.n

        keP, hist = jax.lax.scan(launch, keP, None, length=n_full)
        if rem:
            lp, keP = kappa_sgd_chain_cf(keP, ops, rem, lr, scale=scale,
                                         interpret=interpret)
            hist = jnp.concatenate([hist, lp.mean()[None] / ops.n])
        return keP, hist

    return loop


@_ft.lru_cache(maxsize=64)
def _build_loop_1d_xla(steps, lr, scale, u_l, u_r):
    """Jitted 1D closed-form SGD loop (one XLA step per scan iteration),
    cached on the static config."""
    from .ops.cf1d import cf_step

    @jax.jit
    def loop(ke, hs, F, u_data):
        def body(ke, _):
            lp, g = cf_step(hs, ke, F, u_data, u_l, u_r, scale)
            return ke - lr * g, lp.mean() / u_data.shape[-1]

        return jax.lax.scan(body, ke, None, length=steps)

    return loop


def _fit_kappa_1d(mesh, f, u_data, steps, lr, kappa0, eval_final,
                  route=None, interpret=False):
    """1D per-element inversion on the exact closed form (ops/cf1d.py).

    ``route`` defaults to :func:`fit_route` on the current backend:
    ``"cf_chain_triton"`` (shared forcing on a GPU: the Pallas-Triton
    chain kernel, 32 SGD steps per launch) or ``"cf_xla"``
    (ops/cf1d.kappa_mse_step_cf in a jitted scan, one step per
    iteration).  Both are exact, so there is no iteration policy.  lr
    defaults to 30.0 with the B-independent per-scenario scale 2/n."""
    from .ops.assembly import assemble_load
    from .ops.cf1d import _element_widths

    B = f.shape[0]
    ne = mesh.n_elements
    n = mesh.n_nodes
    lr = 30.0 if lr is None else float(lr)
    scale = 2.0 / n
    ke0 = jnp.ones((B, ne), mesh.dtype) if kappa0 is None \
        else jnp.broadcast_to(jnp.asarray(kappa0, mesh.dtype), (B, ne))

    f_shared = bool(jax.device_get((f == f[:1]).all())) if B > 1 else True
    if route is None:
        route = fit_route(1, jax.default_backend(), f_shared, ne)
    F = assemble_load(mesh, f[0] if f_shared else f)
    hs = jnp.asarray(_element_widths(mesh), mesh.dtype)
    bc = np.asarray(mesh.bc_values, np.float64)
    u_l, u_r = float(bc[0]), float(bc[-1])
    if route == "cf_chain_triton":
        if not f_shared:
            raise ValueError("the chain kernel needs a shared forcing")
        from .ops.pallas.fused_grad_cf_kernel import (cf_packed_operands,
                                                      cf_unpack)
        keP, ops = cf_packed_operands(mesh, ke0, F, u_data)
        k = min(32, steps)
        loop = _build_loop_1d_chain(steps // k, k, steps % k, lr, scale,
                                    bool(interpret))
        keP, hist = loop(keP, ops)
        kappa = cf_unpack(keP, ops)
    elif route == "cf_xla":
        loop = _build_loop_1d_xla(steps, lr, scale, u_l, u_r)
        kappa, hist = loop(ke0, hs, F, u_data)
    else:
        raise ValueError(f"unknown 1D fit route {route!r} "
                         "(expected 'cf_chain_triton' or 'cf_xla')")

    info = {"path": route, "iters": None, "warm": None,
            "loss_history": hist, "eval_loss": None}
    if eval_final:
        info["eval_loss"] = float(_eval_1d(kappa, hs, F, u_data, u_l, u_r))
    return kappa, info


@_ft.partial(jax.jit, static_argnames=("u_l", "u_r"))
def _eval_1d(kappa, hs, F, u_data, u_l, u_r):
    from .ops.cf1d import cf_step

    lp, _ = cf_step(hs, kappa, F, u_data, u_l, u_r, 0.0)
    return jnp.sum(lp) / (lp.shape[0] * u_data.shape[-1])


@_ft.lru_cache(maxsize=64)
def _build_loop_3d(grid, iters, warm, lr, steps):
    from .ops.stencil3d import kappa_mse_grad_step_3d

    def body(args, carry, _):
        fg, g0, ug = args
        k, state = carry
        loss, gk, state = kappa_mse_grad_step_3d(
            grid, k, fg, g0, ug, iters,
            warm_state=state if warm else None, return_state=True)
        return (k - lr * gk, state), loss

    @jax.jit
    def loop(k, fg, g0, ug):
        loss0, g0k, state0 = kappa_mse_grad_step_3d(
            grid, k, fg, g0, ug, iters, return_state=True)
        (k, _), losses = jax.lax.scan(
            _ft.partial(body, (fg, g0, ug)), (k - lr * g0k, state0), None,
            length=max(steps - 1, 0))
        return k, jnp.concatenate([loss0[None], losses])

    return loop


@_ft.lru_cache(maxsize=64)
def _build_eval_3d(grid, maxiter):
    from .ops.stencil3d import solve_poisson_structured_3d_batched

    @jax.jit
    def ev(kappa, fg, g0, ug):
        u = solve_poisson_structured_3d_batched(grid, kappa, fg, g0, 0.0,
                                                maxiter)
        return jnp.mean((u - ug) ** 2)

    return ev


def _fit_kappa_3d(mesh, grid, f, u_data, steps, lr, kappa0, iters, warm,
                  eval_final):
    B = f.shape[0]
    # κ-error-safe iteration policy, GRADED BY GRID SIZE — two control
    # points (scripts/probe_3d_control.py, identifiable multi-forcing
    # workload, Adam to deep convergence, κ-error gated):
    # * 16³: cold-32 ≡ cold-100 (κ err 4.03e-3 vs 4.00e-3), cold-16 31×
    #   worse — default 32;
    # * 32³: cold-32 caps κ err at 1.53e-1 vs cold-100's 8.4e-3 (18×);
    #   cold-16 diverges; warm-100 and MG V-cycle steps don't rescue
    #   it — default 100.
    # Iteration requirements grow with the grid (CG's O(n) growth); pass
    # iters=16/32 explicitly for loss-gated shallow runs only.
    if iters is None:
        iters = 32 if max(grid.nx, grid.ny, grid.nz) <= 16 else 100
    warm = False if warm is None else warm        # warm loses in 3D
    if lr is None:
        # The 3D loss is a mean over the batch AND nodes, so the κ
        # gradient magnitude scales as 1/B; the tuned point was lr=100 at
        # B=256.  Folding the B-dependence into the default keeps the
        # EFFECTIVE step B-invariant (regression: tests/test_inverse.py).
        lr = 100.0 * (B / 256.0)
    fg = f.reshape((B,) + grid.node_shape)
    ug = u_data.reshape((B,) + grid.node_shape)
    g0 = mesh.bc_values.reshape(grid.node_shape)
    k0 = jnp.ones((B, mesh.n_elements), mesh.dtype) if kappa0 is None \
        else jnp.broadcast_to(jnp.asarray(kappa0, mesh.dtype),
                              (B, mesh.n_elements))

    loop = _build_loop_3d(grid, iters, warm, float(lr), steps)
    kappa, losses = loop(k0, fg, g0, ug)
    info = {"path": fit_route(3, jax.default_backend()), "iters": iters,
            "warm": warm, "loss_history": losses, "eval_loss": None}
    if eval_final:
        ev = _build_eval_3d(grid, max(4 * iters, 256))
        info["eval_loss"] = float(ev(kappa, fg, g0, ug))
    return kappa, info


def recover_kappa_field(
    mesh: FEMesh,
    f: jax.Array,
    u_data: jax.Array,
    adam_steps: int = 500,
    lr: float = 0.05,
    method: str = "auto",
    reg: float = 0.0,
    share_field: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Recover per-element κ fields: f, u_data (B, n); returns
    (κ, loss history (adam_steps,)).

    ``share_field=False`` (default): each scenario recovers its own field
    from its own forcing — note a single (f, u) pair determines κ only up
    to an unobserved boundary-flux constant, so independent recoveries fit
    the data without matching a ground-truth field pointwise.
    ``share_field=True``: ONE field (n_elements,) must explain ALL B
    forcings jointly — the well-posed multi-experiment inversion.

    Optional Tikhonov smoothing ``reg·Σ(Δlog κ)²`` regularizes the
    under-determined directions.
    """
    B = f.shape[0]
    dtype = mesh.dtype
    shape = (mesh.n_elements,) if share_field else (B, mesh.n_elements)
    log_k = jnp.zeros(shape, dtype)

    def loss_fn(log_k):
        kappa = jnp.exp(log_k)
        if share_field:
            kappa = jnp.broadcast_to(kappa, (B, mesh.n_elements))
        u = solve_poisson_batched(mesh, kappa, f, method=method)
        data = jnp.mean((u - u_data) ** 2)
        if reg > 0:
            smooth = jnp.mean(jnp.diff(log_k, axis=-1) ** 2)
            return data + reg * smooth
        return data

    opt = optax.adam(lr)

    @jax.jit
    def run(log_k):
        state = opt.init(log_k)

        def step(carry, _):
            lk, st = carry
            loss, g = jax.value_and_grad(loss_fn)(lk)
            upd, st = opt.update(g, st)
            return (optax.apply_updates(lk, upd), st), loss

        (log_k, _), hist = jax.lax.scan(step, (log_k, state), None,
                                        length=adam_steps)
        return log_k, hist

    log_k, hist = run(log_k)
    return jnp.exp(log_k), hist
