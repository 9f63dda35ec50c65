"""Physics-informed loss functions.

Capability parity with reference ``PhysicsLoss``
(/root/reference/diffhe/loss.py:21-105): two modes —

* ``fem_match`` — MSE between a prediction and the FEM solution for the same
  forcing.  The FEM target carries no gradient (reference computes it under
  ``torch.no_grad()`` every call, loss.py:81-82); here it is computed ONCE
  and cached (the reference re-runs the full solve every epoch — 3000
  redundant solves per training run, SURVEY.md §3.3 — with identical
  semantics since mesh/forcing are static).
* ``variational`` — finite-difference strong-form residual mean((Δu+f)²) on
  the interior of the free-node set, uniform-spacing assumption
  (loss.py:85-105).  Implemented with a static-shape validity mask instead
  of dynamic free-node slicing.

Plus one extra the reference lacks: ``energy`` — the true
variational (Ritz) energy ½uᵀKu − uᵀF, matrix-free, which is what
"variational" ought to mean and is minimized exactly by the FEM solution.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .mesh import FEMesh
from .ops.assembly import assemble_load, stiffness_apply
from .solver import solve_poisson

MODES = ("fem_match", "variational", "energy")


def fem_match_loss(mesh: FEMesh, u_pred: jax.Array,
                   u_fem: jax.Array) -> jax.Array:
    """MSE(u_pred, stop_grad(u_fem)) — reference loss.py:79-83."""
    return jnp.mean((u_pred - jax.lax.stop_gradient(u_fem)) ** 2)


def variational_fd_loss(mesh: FEMesh, u_pred: jax.Array,
                        f: jax.Array) -> jax.Array:
    """FD strong-form residual on the interior of the free set.

    Matches reference loss.py:85-105: lap_i = (u_{i-1} − 2u_i + u_{i+1})/h²,
    residual = lap + f, averaged over nodes that (a) are free, (b) have free
    neighbors on both sides — which for a standard line mesh is exactly the
    reference's ``u_free[1:-1]`` window.  Uniform spacing h taken from the
    mesh (reference takes the first free-node gap, loss.py:94).
    """
    if mesh.dim != 1:
        raise NotImplementedError("variational FD loss is 1D (as in reference)")
    x = mesh.nodes[:, 0]
    n = mesh.n_nodes
    h = (x[-1] - x[0]) / (n - 1)
    u = u_pred
    lap = (u[..., :-2] - 2.0 * u[..., 1:-1] + u[..., 2:]) / (h * h)
    residual = lap + f[..., 1:-1]
    free = 1.0 - mesh.bc_mask
    valid = free[:-2] * free[1:-1] * free[2:]
    count = jnp.maximum(jnp.sum(valid), 1.0)
    return jnp.sum((residual ** 2) * valid, axis=-1) / count


def energy_loss(mesh: FEMesh, kappa, u_pred: jax.Array,
                f: jax.Array) -> jax.Array:
    """Ritz energy ½uᵀKu − uᵀF (matrix-free) — minimized by the FEM solution.

    Extra (not in the reference): trains a surrogate without ever
    solving the system, using only stiffness applies.
    """
    Ku = stiffness_apply(mesh, kappa, u_pred)
    F = assemble_load(mesh, f)
    return 0.5 * jnp.sum(u_pred * Ku, axis=-1) - jnp.sum(u_pred * F, axis=-1)


class PhysicsLoss:
    """Callable physics loss, mirroring the reference's class ergonomics
    (loss.py:44-76): ``loss = PhysicsLoss(mesh, forcing_fn, mode)(u_pred)``.

    The FEM target for ``fem_match`` is computed lazily once and cached.
    """

    def __init__(
        self,
        mesh: FEMesh,
        forcing_fn: Callable[[jax.Array], jax.Array],
        mode: str = "fem_match",
        solver=None,
        kappa=1.0,
    ):
        if mode not in MODES:
            raise ValueError(f"Unknown mode: {mode!r}")  # loss.py:52-53
        self.mesh = mesh
        self.forcing_fn = forcing_fn
        self.mode = mode
        self.kappa = solver.kappa if solver is not None else kappa
        self._u_fem: Optional[jax.Array] = None

    def _coords(self) -> jax.Array:
        # 1D passes x as (n,), 2D as (n, 2) — reference loss.py:79 squeezes
        return self.mesh.nodes[:, 0] if self.mesh.dim == 1 else self.mesh.nodes

    @property
    def u_fem(self) -> jax.Array:
        if self._u_fem is None:
            f = self.forcing_fn(self._coords())
            self._u_fem = jax.lax.stop_gradient(
                solve_poisson(self.mesh, self.kappa, f))
        return self._u_fem

    def __call__(self, u_pred: jax.Array) -> jax.Array:
        if self.mode == "fem_match":
            return fem_match_loss(self.mesh, u_pred, self.u_fem)
        f = self.forcing_fn(self._coords())
        if self.mode == "variational":
            return variational_fd_loss(self.mesh, u_pred, f)
        return energy_loss(self.mesh, self.kappa, u_pred, f)

    forward = __call__
