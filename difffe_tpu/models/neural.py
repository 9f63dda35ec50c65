"""Neural PDE surrogate — MLP with hard Dirichlet enforcement.

Capability parity with reference ``NeuralPDE``
(/root/reference/diffhe/neural.py:19-149): a dim→[hidden,tanh]×L→1 MLP whose
output is multiplied by a boundary-vanishing lifting mask so Dirichlet BCs
hold by construction:

* 1D mask: (x−a)(b−x)/max over the span of the Dirichlet nodes
  (neural.py:85-91);
* 2D mask: binary 0-on-BC-node / 1-inside indicator (neural.py:95-101).

Differences from the reference: parameters are a plain pytree (functional
init/apply, composable with jit/vmap/grad); ``train_pde`` runs the entire
epoch loop as one jitted ``jax.lax.scan`` over optax Adam steps — the
reference interprets a Python loop with a fresh FEM solve per epoch
(neural.py:139-147, SURVEY.md §3.3); here the fem_match target is computed
once and the whole training runs on-device.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax

from ..mesh import FEMesh
from ..losses import PhysicsLoss, energy_loss, fem_match_loss, variational_fd_loss
from ..solver import solve_poisson

Params = List[Tuple[jax.Array, jax.Array]]


# --------------------------------------------------------------------------
# Functional MLP
# --------------------------------------------------------------------------

def init_mlp(key: jax.Array, in_dim: int, hidden_dim: int, n_layers: int,
             dtype=jnp.float32) -> Params:
    """Init a dim→[hidden,tanh]×n_layers→1 MLP (torch-Linear-style uniform
    ±1/√fan_in init, matching the reference architecture neural.py:46-52)."""
    dims = [in_dim] + [hidden_dim] * n_layers + [1]
    params: Params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        key, k1, k2 = jax.random.split(key, 3)
        bound = 1.0 / math.sqrt(d_in)
        W = jax.random.uniform(k1, (d_in, d_out), dtype, -bound, bound)
        b = jax.random.uniform(k2, (d_out,), dtype, -bound, bound)
        params.append((W, b))
    return params


def apply_mlp(params: Params, x: jax.Array) -> jax.Array:
    """x: (..., in_dim) → (...,) raw scalar field."""
    h = x
    for W, b in params[:-1]:
        h = jnp.tanh(h @ W + b)
    W, b = params[-1]
    return (h @ W + b)[..., 0]


def boundary_mask(mesh: FEMesh) -> jax.Array:
    """Lifting mask φ, zero on Dirichlet nodes (reference neural.py:80-101)."""
    nodes = mesh.nodes
    if mesh.dim == 1:
        x = nodes[:, 0]
        bc_idx = jnp.nonzero(mesh.bc_mask > 0.5, size=mesh.n_nodes,
                             fill_value=-1)[0]
        n_bc = jnp.sum(mesh.bc_mask > 0.5)
        if int(n_bc) >= 2:
            # span of the Dirichlet set — reference takes first/last BC-dict
            # keys (insertion order = [left, right] for line meshes)
            a = x[bc_idx[0]]
            b = x[bc_idx[n_bc - 1]]
            mask = (x - a) * (b - x)
            return mask / (jnp.max(jnp.abs(mask)) + 1e-12)
        return jnp.ones_like(x)
    # 2D: binary indicator (reference neural.py:95-101)
    return 1.0 - mesh.bc_mask


def boundary_mask_at(mesh: FEMesh, x: jax.Array) -> jax.Array:
    """Evaluate the lifting mask at arbitrary query points x (N, dim).

    The nodal mask (``boundary_mask``) is positional — valid only at mesh
    nodes.  For off-node queries the 1D polynomial mask has an analytic
    form; the 2D binary indicator does not (use
    models/collocation.smooth_mask_fn for mesh-free 2D work).
    """
    if mesh.dim != 1:
        raise NotImplementedError(
            "off-node mask evaluation is only defined for 1D meshes (the "
            "2D mask is a nodal indicator, reference neural.py:95-101); "
            "use models.collocation.smooth_mask_fn for smooth 2D masks")
    xm = mesh.nodes[:, 0]
    bc_idx = jnp.nonzero(mesh.bc_mask > 0.5, size=mesh.n_nodes,
                         fill_value=-1)[0]
    n_bc = int(jnp.sum(mesh.bc_mask > 0.5))
    if n_bc < 2:
        return jnp.ones(x.shape[:-1], dtype=mesh.dtype)
    a = xm[bc_idx[0]]
    b = xm[bc_idx[n_bc - 1]]
    raw_nodal = (xm - a) * (b - xm)
    norm = jnp.max(jnp.abs(raw_nodal)) + 1e-12
    xq = x[..., 0]
    return (xq - a) * (b - xq) / norm


def neural_pde_forward(params: Params, mesh: FEMesh, mask: jax.Array,
                       x: Optional[jax.Array] = None) -> jax.Array:
    """u(x) = φ(x)·net(x) (reference neural.py:59-76).

    With ``x=None`` (the default — every training/eval path) the precomputed
    nodal mask applies.  With explicit query points the mask is re-evaluated
    AT those points (the reference applies the nodal mask positionally to
    whatever x you pass, silently zeroing interior predictions —
    neural.py:75; fixed here).
    """
    if x is None:
        return mask * apply_mlp(params, mesh.nodes)
    return boundary_mask_at(mesh, x) * apply_mlp(params, x)


# --------------------------------------------------------------------------
# Training (scan-jitted)
# --------------------------------------------------------------------------

def train_pde(
    params: Params,
    mesh: FEMesh,
    forcing_fn: Callable[[jax.Array], jax.Array],
    n_epochs: int = 2000,
    lr: float = 1e-3,
    mode: str = "fem_match",
    kappa=1.0,
) -> Tuple[Params, jax.Array]:
    """Train the surrogate; returns (trained params, per-epoch losses).

    The whole loop is one ``lax.scan`` under jit — zero host round-trips
    (vs one Python iteration + fresh FEM solve per epoch in the reference,
    neural.py:139-147).
    """
    mask = boundary_mask(mesh)
    coords = mesh.nodes[:, 0] if mesh.dim == 1 else mesh.nodes
    f = forcing_fn(coords)

    if mode == "fem_match":
        u_fem = jax.lax.stop_gradient(solve_poisson(mesh, kappa, f))
        loss_of = lambda u: fem_match_loss(mesh, u, u_fem)
    elif mode == "variational":
        loss_of = lambda u: variational_fd_loss(mesh, u, f)
    elif mode == "energy":
        loss_of = lambda u: energy_loss(mesh, kappa, u, f)
    else:
        raise ValueError(f"Unknown mode: {mode!r}")

    opt = optax.adam(lr)

    def loss_fn(p):
        return loss_of(neural_pde_forward(p, mesh, mask))

    @jax.jit
    def run(p):
        state = opt.init(p)

        def step(carry, _):
            p, st = carry
            loss, g = jax.value_and_grad(loss_fn)(p)
            updates, st = opt.update(g, st)
            p = optax.apply_updates(p, updates)
            return (p, st), loss

        (p, _), losses = jax.lax.scan(step, (p, state), None, length=n_epochs)
        return p, losses

    return run(params)


def train_pde_batched(
    keys: jax.Array,
    mesh: FEMesh,
    f_batch: jax.Array,
    n_epochs: int = 2000,
    lr: float = 1e-3,
    hidden_dim: int = 32,
    n_layers: int = 3,
    kappa=1.0,
    kappa_batched: Optional[bool] = None,
) -> Tuple[Params, jax.Array]:
    """Scenario-batched surrogate training (BASELINE config 5: 'NeuralPDE
    residual training, 1e4+ scenarios').

    Trains B independent networks — one per forcing scenario f_batch[b],
    initialized from keys[b] — as ONE vmapped+jitted program: every epoch
    runs B forward/backward passes fused across the batch.  Per-scenario κ
    supported via a (B,...) kappa; when a 1-D κ length collides with both B
    and n_elements/n_nodes, pass ``kappa_batched`` explicitly (forwarded to
    ``solve_poisson_batched``, which raises on the ambiguity rather than
    guessing).  Returns (stacked params pytree with leading B axis,
    losses (B, n_epochs)).
    """
    B = f_batch.shape[0]
    mask = boundary_mask(mesh)
    kappa = jnp.asarray(kappa, dtype=mesh.dtype)

    # FEM targets for all scenarios in one batched solve
    from ..solver import solve_poisson_batched
    u_fem = jax.lax.stop_gradient(
        solve_poisson_batched(mesh, kappa, f_batch,
                              kappa_batched=kappa_batched))

    opt = optax.adam(lr)

    def train_one(key, u_target):
        params = init_mlp(key, mesh.dim, hidden_dim, n_layers,
                          dtype=mesh.dtype)
        state = opt.init(params)

        def loss_fn(p):
            u = neural_pde_forward(p, mesh, mask)
            return jnp.mean((u - u_target) ** 2)

        def step(carry, _):
            p, st = carry
            loss, g = jax.value_and_grad(loss_fn)(p)
            updates, st = opt.update(g, st)
            return (optax.apply_updates(p, updates), st), loss

        (params, _), losses = jax.lax.scan(step, (params, state), None,
                                           length=n_epochs)
        return params, losses

    return jax.jit(jax.vmap(train_one))(keys, u_fem)


# --------------------------------------------------------------------------
# Ergonomic wrapper (reference class shape)
# --------------------------------------------------------------------------

class NeuralPDE:
    """Reference-shaped facade: ``model = NeuralPDE(mesh); model.train_pde(f)``.

    Holds the parameter pytree; all compute goes through the functional API.
    """

    def __init__(self, mesh: FEMesh, hidden_dim: int = 32, n_layers: int = 3,
                 key: Optional[jax.Array] = None):
        self.mesh = mesh
        self.dim = mesh.dim
        if key is None:
            key = jax.random.PRNGKey(0)
        self.params = init_mlp(key, mesh.dim, hidden_dim, n_layers,
                               dtype=mesh.dtype)
        self._mask = boundary_mask(mesh)

    def __call__(self, x: Optional[jax.Array] = None) -> jax.Array:
        return neural_pde_forward(self.params, self.mesh, self._mask, x)

    forward = __call__

    def train_pde(
        self,
        forcing_fn: Callable[[jax.Array], jax.Array],
        n_epochs: int = 2000,
        lr: float = 1e-3,
        mode: str = "fem_match",
        verbose: bool = True,
        log_every: int = 200,
        kappa=1.0,
    ) -> List[float]:
        """Train in place; returns per-epoch losses as a Python list
        (reference signature neural.py:105-113)."""
        self.params, losses = train_pde(self.params, self.mesh, forcing_fn,
                                        n_epochs=n_epochs, lr=lr, mode=mode,
                                        kappa=kappa)
        losses_list = [float(l) for l in losses]
        if verbose:
            for e in range(log_every - 1, n_epochs, log_every):
                print(f"  Epoch {e + 1:5d}  loss = {losses_list[e]:.3e}")
        return losses_list
