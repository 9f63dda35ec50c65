"""Expert parallelism: a sharded bank of per-regime surrogate experts.

SURVEY §2b's EP row.  The framework's "experts" are operator surrogates
(models/neural.py MLPs, the config-5 workload): PDE scenarios live in
distinct κ-regimes, each regime gets its own expert, and the expert bank is
sharded across devices along the ``dof``/``ep`` mesh axis while scenarios
stay on ``dp``.

MoE dispatch (Mesh-TensorFlow / GShard style, no host logic):

  1. route:    expert id per scenario from a static κ-statistic bucketing;
  2. dispatch: one-hot (B, E, C) tensor D; expert inputs are the einsum
               ``becd = D[b,e,c] · X[b,d]`` — under GSPMD with X sharded on
               dp and experts on ep, XLA lowers this to the all_to_all;
  3. apply:    one vmap over the stacked expert params (E on the ep axis);
  4. combine:  the transpose einsum back to (B, d) on dp.

Everything is dense einsums with static shapes — no gather/scatter, no
data-dependent control flow — so it jits, vmaps, and differentiates like
any other op (gradients flow to expert params AND through the combine back
to the inputs; the router is a hard assignment and contributes none, the
usual switch-routing convention).

Capacity: each expert processes at most C scenarios; overflow within an
expert's queue is DROPPED (output zeros + a ``dropped`` count returned for
observability) — the standard static-shape trade.  Size C for the worst
expected imbalance, or pre-sort scenarios by regime.

Validated: sharded == single-device apply to 1e-12, drop accounting, and
gradient flow (tests/test_expert.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def route_by_bucket(values: jax.Array, boundaries: jax.Array) -> jax.Array:
    """Expert ids (B,) int32 from bucketing ``values`` (B,) at ``boundaries``
    (E-1,) sorted ascending — e.g. mean-log-κ quantiles per regime."""
    return jnp.searchsorted(boundaries, values).astype(jnp.int32)


def make_dispatch(expert_ids: jax.Array, n_experts: int,
                  capacity: int) -> Tuple[jax.Array, jax.Array]:
    """Dispatch tensor D (B, E, C) and the number of dropped scenarios.

    D[b, e, c] = 1 iff scenario b is the c-th scenario routed to expert e
    and c < capacity.  Scenarios past an expert's capacity are dropped
    (row of zeros → combine returns zeros for them).
    """
    B = expert_ids.shape[0]
    onehot = jax.nn.one_hot(expert_ids, n_experts, dtype=jnp.int32)  # (B, E)
    pos = jnp.cumsum(onehot, axis=0) * onehot - 1                    # (B, E)
    keep = (pos >= 0) & (pos < capacity)
    D = (jax.nn.one_hot(jnp.clip(pos, 0, capacity - 1), capacity,
                        dtype=jnp.float32)
         * keep[..., None].astype(jnp.float32))                     # (B,E,C)
    # keep-count in int32: summing the float32 dispatch tensor is only
    # integer-exact up to 2^24 kept scenarios (advisor finding, round 2)
    dropped = B - jnp.sum(keep.astype(jnp.int32))
    return D, dropped


def moe_apply(
    params_stacked,
    X: jax.Array,
    expert_ids: jax.Array,
    apply_fn: Callable,
    capacity: Optional[int] = None,
    dmesh: Optional[Mesh] = None,
    ep_axis: str = "dof",
    dp_axis: str = "dp",
):
    """Apply the expert bank: X (B, d_in) → (Y (B, d_out), dropped).

    params_stacked: pytree with a leading E axis on every leaf (one expert
    per slice — build with ``jax.vmap(init_fn)(keys)``).  apply_fn(params,
    x_batch) → y_batch is the single-expert forward (e.g.
    models.neural.apply_mlp vmapped over its batch).  capacity defaults to
    2·B/E.  When ``dmesh`` is given, sharding constraints pin X/Y to
    ``dp_axis`` and the expert-major intermediates + params to ``ep_axis``,
    so GSPMD materializes the dispatch/combine einsums as all_to_all over
    the expert axis.  Dropped scenarios return zero rows.
    """
    E = jax.tree_util.tree_leaves(params_stacked)[0].shape[0]
    B = X.shape[0]
    C = capacity if capacity is not None else max(1, (2 * B) // E)

    D, dropped = make_dispatch(expert_ids, E, C)

    def constrain(v, spec):
        if dmesh is None:
            return v
        return jax.lax.with_sharding_constraint(
            v, NamedSharding(dmesh, spec))

    X = constrain(X, P(dp_axis, None))
    Xe = jnp.einsum("bec,bd->ecd", D, X)            # (E, C, d_in)
    Xe = constrain(Xe, P(ep_axis, None, None))
    params_sh = params_stacked
    if dmesh is not None:
        params_sh = jax.tree_util.tree_map(
            lambda p: constrain(p, P(*((ep_axis,) + (None,) * (p.ndim - 1)))),
            params_stacked)
    Ye = jax.vmap(apply_fn)(params_sh, Xe)          # (E, C, d_out)
    Ye = constrain(Ye, P(ep_axis, None, None))
    Y = jnp.einsum("bec,ecd->bd", D, Ye)            # (B, d_out)
    return constrain(Y, P(dp_axis, None)), dropped
