"""Device-mesh sharding for scenario-batched differentiable FEM.

The reference has zero parallelism (SURVEY.md §2b — no torch.distributed, no
batching; one unbatched solve per call, /root/reference/diffhe/solver.py:49-67).
This module supplies the device-mesh equivalents:

* **DP — scenario-batch parallelism** (the workhorse axis): shard the
  B-scenario axis of (κ, f, u_data) over mesh axis ``"dp"``; per-scenario
  adjoint solves are independent, gradient reductions ride the
  collectives XLA inserts under jit (or explicit ``psum`` in the
  ``shard_map`` variant below).
* **TP/SP — DOF sharding**: shard the node/DOF axis over mesh axis
  ``"dof"``; the PCR shifts / element scatter-adds become XLA collective
  permutes — the domain's analogue of halo exchange.

Everything uses GSPMD via ``jax.sharding`` + jit ``in_shardings``; no
hand-written transport (XLA emits the collectives, NCCL over NVLink
between GPUs).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..mesh import FEMesh
from ..solver import solve_poisson


def make_device_mesh(
    n_devices: Optional[int] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("dp", "dof"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2D (dp × dof) device mesh.

    Default: all devices on the dp (scenario) axis, dof=1 — the right layout
    whenever the per-chip DOF count fits HBM (BASELINE configs 1-3).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n, 1)
    if mesh_shape[0] * mesh_shape[1] != n:
        raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
    dev_array = np.array(devices).reshape(mesh_shape)
    return Mesh(dev_array, axis_names)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Scenario-batched array (B, ...): B over dp, trailing axes replicated."""
    return NamedSharding(mesh, P("dp"))


def batch_dof_sharding(mesh: Mesh) -> NamedSharding:
    """(B, n_dof) array: B over dp, DOFs over dof."""
    return NamedSharding(mesh, P("dp", "dof"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays, shard_dof: bool = False):
    """Place scenario-batched arrays onto the device mesh."""
    sh = batch_dof_sharding(mesh) if shard_dof else batch_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out[0] if len(out) == 1 else out


# --------------------------------------------------------------------------
# Flagship distributed training step: batched κ-field inversion
# --------------------------------------------------------------------------

def make_inversion_step(
    fe_mesh: FEMesh,
    device_mesh: Mesh,
    lr: float = 0.1,
    method: str = "auto",
    shard_dof: bool = False,
    optimizer: Optional[optax.GradientTransformation] = None,
):
    """Build (init_fn, step_fn) for scenario-batched κ recovery.

    Each scenario b learns log κ_b — a scalar (B,) or a per-element field
    (B, n_elements) — minimizing MSE(u(exp(log κ_b), f_b), u_data_b).  The
    per-scenario state is sharded over ``dp``; one jitted step = B forward
    solves + B adjoint solves + optimizer update, all on-device.  This is
    BASELINE config 2 ('1024 κ/forcing scenarios, 128-element mesh,
    adjoint gradients') as a single pjit computation.  ``optimizer``
    defaults to ``optax.adam(lr)``; ``optax.sgd(1.0)`` makes one step's
    update the loss gradient itself.
    """
    opt = optax.adam(lr) if optimizer is None else optimizer
    state_sh = batch_sharding(device_mesh)
    data_sh = batch_dof_sharding(device_mesh) if shard_dof \
        else batch_sharding(device_mesh)

    def solve_one(log_k, f):
        return solve_poisson(fe_mesh, jnp.exp(log_k), f, method=method)

    def loss_fn(log_k, f, u_data):
        u = jax.vmap(solve_one)(log_k, f)
        # per-scenario MSE, then mean over the (dp-sharded) batch — XLA
        # lowers the mean to a psum across the dp axis
        return jnp.mean((u - u_data) ** 2)

    def init_fn(log_k0):
        log_k0 = jax.device_put(log_k0, state_sh)
        # opt state pytree inherits the dp sharding from log_k0 (scalar
        # leaves like Adam's step count stay replicated)
        return log_k0, opt.init(log_k0)

    @jax.jit
    def step_fn(log_k, opt_state, f, u_data):
        loss, g = jax.value_and_grad(loss_fn)(log_k, f, u_data)
        updates, opt_state = opt.update(g, opt_state)
        log_k = optax.apply_updates(log_k, updates)
        return log_k, opt_state, loss

    return init_fn, step_fn, data_sh


# --------------------------------------------------------------------------
# shard_map variant — explicit psum (the "comms backend" path)
# --------------------------------------------------------------------------

def make_inversion_step_shard_map(
    fe_mesh: FEMesh,
    device_mesh: Mesh,
    lr: float = 0.1,
    method: str = "auto",
):
    """Same semantics as ``make_inversion_step`` but with explicit SPMD:
    per-device shards under ``shard_map``, loss averaged with an explicit
    ``psum`` over the dp axis — the pattern multi-host runs use directly.
    Per-scenario gradients need no cross-device traffic (scenarios are
    independent); only the scalar loss is psum-reduced, so the optimizer
    update runs outside the shard_map on dp-sharded arrays."""
    opt = optax.adam(lr)

    def solve_one(log_k, f):
        return solve_poisson(fe_mesh, jnp.exp(log_k), f, method=method)

    def local_loss(log_k, f, u_data):
        u = jax.vmap(solve_one)(log_k, f)
        sq = jnp.sum((u - u_data) ** 2)
        cnt = jnp.asarray(u.size, u.dtype)
        # explicit reduction across the scenario shards
        total = jax.lax.psum(sq, "dp")
        n = jax.lax.psum(cnt, "dp")
        return total / n

    grad_step = jax.shard_map(
        lambda log_k, f, u_data: jax.value_and_grad(local_loss)(
            log_k, f, u_data),
        mesh=device_mesh,
        in_specs=(P("dp"), P("dp"), P("dp")),
        out_specs=(P(), P("dp")),
    )

    @jax.jit
    def step(log_k, opt_state, f, u_data):
        loss, g = grad_step(log_k, f, u_data)
        updates, opt_state = opt.update(g, opt_state)
        log_k = optax.apply_updates(log_k, updates)
        return log_k, opt_state, loss

    def init_fn(log_k0):
        log_k0 = jax.device_put(log_k0, batch_sharding(device_mesh))
        return log_k0, opt.init(log_k0)

    return init_fn, step
