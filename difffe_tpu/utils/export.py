"""AOT export of compiled solver programs (deployment/serving path).

``jax.export`` serializes a traced+lowered computation to portable
StableHLO: the batched differentiable solve (or any jitted pipeline built
on it) can be compiled once, shipped as bytes, and executed later without
retracing Python — the deployment story the reference (a demo script,
SURVEY.md §1) has no analogue for.

Typical use::

    blob = export_batched_solver(mesh, batch=8192)
    ...                                  # ship blob to the serving fleet
    solve = load_exported(blob)
    u = solve(kappas, forcings)
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import export as jax_export

from ..mesh import FEMesh


def export_fn(fn: Callable, *example_args,
              platforms: Optional[Sequence[str]] = None) -> bytes:
    """Serialize a jitted callable for the given example shapes.

    ``platforms`` defaults to the current backend; pass e.g.
    ``["cuda", "cpu"]`` to build a multi-platform artifact.
    """
    shapes = [jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a))
              for a in example_args]
    exp = jax_export.export(jax.jit(fn), platforms=platforms)(*shapes)
    return bytes(exp.serialize())


def load_exported(blob: bytes) -> Callable:
    """Deserialize an exported program; returns ``fn(*args) → result``."""
    exp = jax_export.deserialize(blob)
    return exp.call


def load_exported_with_avals(blob: bytes):
    """(call_fn, input avals) — avals carry the exact shapes/dtypes the
    artifact was traced with (serving layers cast requests to them)."""
    exp = jax_export.deserialize(blob)
    return exp.call, exp.in_avals


def export_batched_solver(mesh: FEMesh, batch: int,
                          method: str = "auto",
                          platforms: Optional[Sequence[str]] = None) -> bytes:
    """AOT-export the scenario-batched Poisson solve for fixed (mesh, B).

    The artifact takes (κ (B,), f (B, n_nodes)) and returns u (B, n_nodes).
    """
    from ..solver import solve_poisson_batched

    def fn(kappa_b, f_b):
        return solve_poisson_batched(mesh, kappa_b, f_b, method=method,
                                     kappa_batched=True)

    kappa_b = jnp.ones((batch,), mesh.dtype)
    f_b = jnp.ones((batch, mesh.n_nodes), mesh.dtype)
    return export_fn(fn, kappa_b, f_b, platforms=platforms)


def export_gradient_step(mesh: FEMesh, batch: int,
                         method: str = "auto",
                         platforms: Optional[Sequence[str]] = None) -> bytes:
    """AOT-export one fwd+adjoint κ-gradient step (the inversion hot loop).

    Artifact signature: (log_κ (B,), f (B,n), u_data (B,n)) →
    (loss scalar, grad (B,)).
    """
    from ..solver import solve_poisson_batched

    def loss_fn(log_k, f_b, u_data):
        u = solve_poisson_batched(mesh, jnp.exp(log_k), f_b, method=method,
                                  kappa_batched=True)
        return jnp.mean((u - u_data) ** 2)

    fn = jax.value_and_grad(loss_fn)
    z = jnp.zeros((batch,), mesh.dtype)
    fb = jnp.ones((batch, mesh.n_nodes), mesh.dtype)
    return export_fn(fn, z, fb, fb, platforms=platforms)
