"""Pipeline parallelism over the TIME axis: GPipe-style heat-rollout chunks.

SURVEY §2b's PP row.  For FEM there are no "layers" to cut — the sequential
axis is TIME.  The horizon H is split into P contiguous chunks, one per
device along the ``pp`` mesh axis; the scenario batch is split into M
microbatches that stream through the chunks.  At outer stage s, device d
advances microbatch (s − d) through its time window — the classic pipeline
schedule with bubble fraction (P − 1)/(M + P − 1).

Where the reference would thread torch modules over NCCL ranks, here the
whole schedule is ONE jitted SPMD program: a ``shard_map`` over the device
mesh whose stage hand-off is a single ``lax.ppermute`` of the microbatch
state (neighbor traffic only — no gather, no host).  The per-chunk
stepper is the ordinary ``control.heat`` backward-Euler scan, so every
linear solve keeps its custom-VJP adjoint, and ``ppermute`` is linear with
a ppermute transpose — the WHOLE pipeline is reverse-differentiable
(gradients to κ, u0, and the full forcing sequence flow back through the
stage hand-offs in the transposed direction).

When to use: H·B·n state that fits one chip should stay on the dp axis
(scan + remat, control/heat.py — cheaper than any pipeline).  PP pays off
when per-device memory bounds the *time window* you can remat through, or
when κ/operator state is so large that replicating it per dp shard loses
to splitting the horizon.  Validated for exactness and gradient parity vs
the single-device rollout on the virtual 8-device mesh
(tests/test_pipeline.py).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..mesh import FEMesh
from ..ops.assembly import assemble_load, assemble_lumped_mass, \
    assemble_tridiag_1d
from ..ops.tridiag import solve_poisson_tridiag


def _axis_size(dmesh: Mesh, axis: str) -> int:
    return dmesh.shape[axis]


def pipelined_rollout(
    dmesh: Mesh,
    mesh: FEMesh,
    kappa,
    u0: jax.Array,
    f_seq: jax.Array,
    dt: float,
    n_micro: Optional[int] = None,
    axis: str = "dof",
    cost_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
):
    """Pipeline the backward-Euler heat rollout over ``axis`` of ``dmesh``.

    mesh: 1D chain FEMesh (tridiag stepper); kappa: scalar or per-element
    (replicated across stages); u0: (B, n); f_seq: (H, B, n) nodal forcing
    per step.  H must divide by the pipeline depth P, B by ``n_micro``
    (default: one microbatch per pipeline stage).

    Returns ``u_final (B, n)`` — the state after all H steps — or
    ``(u_final, cost)`` when ``cost_fn`` (per-step ``u (Bm, n) → scalar``)
    is given; the cost is the sum over all steps and microbatches (the MPC
    objective shape, BASELINE config 3).

    The default ``axis="dof"`` reuses the standard dp×dof mesh (sharding.py)
    — a pipeline stage is "model parallelism" in time, so it rides the same
    mesh axis TP would.
    """
    Pn = _axis_size(dmesh, axis)
    H, B, n = f_seq.shape
    M = n_micro if n_micro is not None else Pn
    if H % Pn:
        raise ValueError(f"horizon {H} not divisible by pipeline depth {Pn}")
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_micro {M}")
    Hc, Bm = H // Pn, B // M

    M_lump = assemble_lumped_mass(mesh)
    dK, eK = assemble_tridiag_1d(mesh, jnp.asarray(kappa, mesh.dtype))
    bands = (M_lump + dt * dK, dt * eK)

    # (H, B, n) → (P, Hc, M, Bm, n): chunk axis sharded over the pipeline
    f_chunks = f_seq.reshape(Pn, Hc, M, Bm, n)
    u0_micro = u0.reshape(M, Bm, n)

    other_axes = tuple(a for a in dmesh.axis_names if a != axis)
    # compose with dp: shard the per-microbatch scenario axis when it divides
    dp_axis = next((a for a in other_axes
                    if dmesh.shape[a] > 1 and Bm % dmesh.shape[a] == 0), None)
    repl_axes = tuple(a for a in other_axes if a != dp_axis)

    def chunk_scan(u, f_chunk, Ml, bd, be):
        """Advance one microbatch through this device's Hc steps."""
        def step(carry, f_t):
            u_c, cost_c = carry
            rhs = Ml * u_c + dt * assemble_load(mesh, f_t)
            # rank-match the bands to the batched rhs: tridiag_solve's
            # custom-VJP cotangents carry the rhs batch shape, and the
            # broadcast_to transpose sums them back to (n,) for the κ grad
            bd_b = jnp.broadcast_to(bd, rhs.shape)
            be_b = jnp.broadcast_to(be, rhs.shape[:-1] + be.shape[-1:])
            u_next = solve_poisson_tridiag(mesh, bd_b, be_b, rhs)
            if cost_fn is not None:
                cost_c = cost_c + cost_fn(u_next)
            return (u_next, cost_c), None

        (u_out, cost), _ = jax.lax.scan(
            step, (u, jnp.zeros((), u.dtype)), f_chunk)
        return u_out, cost

    # κ-dependent operands enter as explicit replicated shard_map args:
    # closure-captured tracers break the ppermute/psum transpose (rank
    # mismatch in the κ cotangent path, observed on jax 0.8).
    def body(u0_m, f_loc, Ml, bd, be):
        # u0_m: (M, Bm_local, n) — Bm sharded over dp when it divides;
        # f_loc: (1, Hc, M, Bm_local, n) — this stage's time window
        d = jax.lax.axis_index(axis)
        Bm_l = u0_m.shape[1]
        cur = jnp.zeros((Bm_l, n), u0_m.dtype)
        finals = jnp.zeros((M, Bm_l, n), u0_m.dtype)
        cost_total = jnp.zeros((), u0_m.dtype)
        fwd = [(i, (i + 1) % Pn) for i in range(Pn)]

        for s in range(M + Pn - 1):
            m = jnp.clip(s - d, 0, M - 1)
            valid = (s - d >= 0) & (s - d <= M - 1)
            # stage 0 injects microbatch s at the head of the pipe
            inject = u0_m[jnp.minimum(s, M - 1)]
            cur = jnp.where((d == 0) & (s < M), inject, cur)
            f_m = jax.lax.dynamic_index_in_dim(
                f_loc[0], m, axis=1, keepdims=False)       # (Hc, Bm, n)
            new, cost = chunk_scan(cur, f_m, Ml, bd, be)
            vmask = jnp.where(valid, 1.0, 0.0).astype(u0_m.dtype)
            cost_total = cost_total + vmask * cost
            # last stage records the finished microbatch
            done = (d == Pn - 1) & valid
            finals = jax.lax.dynamic_update_index_in_dim(
                finals, jnp.where(done, new, finals[m]), m, axis=0)
            # hand the (masked) state to the next stage — one hop
            cur = jax.lax.ppermute(vmask * new, axis, fwd)

        # finals live only on the last stage; costs are per-stage partials
        finals = jax.lax.psum(
            jnp.where(d == Pn - 1, finals, jnp.zeros_like(finals)), axis)
        cost_total = jax.lax.psum(cost_total, axis)
        if dp_axis is not None:
            cost_total = jax.lax.psum(cost_total, dp_axis)
        if repl_axes:
            cost_total = jax.lax.pmean(cost_total, repl_axes)
        return finals, cost_total

    in_specs = (P(None, dp_axis), P(axis, None, None, dp_axis),
                P(), P(), P())
    out_specs = (P(None, dp_axis), P())
    finals, cost = shard_map(
        body, mesh=dmesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False)(u0_micro, f_chunks, M_lump, bands[0], bands[1])
    u_final = finals.reshape(B, n)
    if cost_fn is not None:
        return u_final, cost
    return u_final
