"""Multi-host initialization, failure detection, and scaling measurement.

The reference has no distributed backend at all (SURVEY.md §5).  Here:
``jax.distributed.initialize`` for multi-process runs (the coordinator
for host coordination, XLA collectives between devices), a heartbeat-style
health check, and
a scaling-efficiency harness for the ≥80% multi-host target (BASELINE.md).

On a single host these are no-ops / single-process paths, so the same
driver script runs everywhere.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX.

    Must run before any other JAX call (``jax.distributed.initialize``
    refuses once the XLA backend exists) — so this probes nothing first and
    only swallows the benign already-initialized error; genuine failures
    (wrong coordinator, backend already up) propagate instead of silently
    degrading every process to an independent single-host job.
    """
    if coordinator_address is None:
        return  # single process: nothing to coordinate
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        msg = str(e).lower()
        # jax 0.9 phrases double-init as 'distributed.initialize should
        # only be called once.'; older versions said 'already initialized'
        if "only be called once" in msg or "already initialized" in msg:
            return
        raise


def is_primary() -> bool:
    return jax.process_index() == 0


def timed_block_until_ready(x, timeout_s: float) -> bool:
    """Wait for ``x`` at most ``timeout_s`` seconds; True iff it completed.

    ``jax.block_until_ready`` has no timeout, so a hung collective would
    hang the caller forever.  The wait runs in a daemon thread and the
    caller joins it with a deadline — if the device never finishes, the
    thread is abandoned (it costs one parked OS thread) and the caller
    gets False inside the budget, which is what lets a supervisor abort
    and restart from the latest checkpoint.  Execution errors (device
    failure surfacing as an exception) also return False."""
    done = threading.Event()
    state = {"ok": False}

    def _wait():
        try:
            jax.block_until_ready(x)
            state["ok"] = True
        except Exception:
            state["ok"] = False
        finally:
            done.set()

    t = threading.Thread(target=_wait, daemon=True)
    t.start()
    if not done.wait(timeout_s):
        return False
    return state["ok"]


@dataclasses.dataclass
class HealthCheck:
    """Cross-device liveness probe: a real all-reduce with a wall-clock
    budget.

    ``ping`` shard_maps a per-device token (each device contributes
    ``axis_index + 1``) and psums it over every device in the mesh, so the
    collective genuinely rendezvouses on all participants — a hung or dead
    device stalls the psum, the timed wait (``timed_block_until_ready``,
    a watchdog thread with a deadline) returns False within ``timeout_s``,
    and the caller can abort and restart from the latest checkpoint
    (utils/checkpoint.py), which is the failure-recovery story for long
    optimizations (SURVEY.md §5 'failure detection / elastic recovery').
    The expected sum 1+2+…+n also verifies every device's *distinct*
    contribution arrived (tested on the virtual 8-device mesh)."""

    timeout_s: float = 60.0

    def ping(self, device_mesh=None) -> bool:
        from jax.sharding import Mesh, PartitionSpec as P

        if device_mesh is None:
            devices = jax.devices()
            device_mesh = Mesh(devices, ("hb",))
        axes = device_mesh.axis_names
        n = device_mesh.size

        def contribute(tok):
            # distinct per-device contribution: flattened index + 1
            idx = jnp.zeros((), jnp.int32)
            stride = 1
            for ax in reversed(axes):
                idx = idx + jax.lax.axis_index(ax) * stride
                stride *= jax.lax.axis_size(ax)
            total = tok * (idx + 1).astype(tok.dtype)
            for ax in axes:
                total = jax.lax.psum(total, ax)
            return total[None]

        probe = jax.jit(jax.shard_map(
            contribute, mesh=device_mesh,
            in_specs=P(), out_specs=P(axes[0])))

        t0 = time.time()
        total = probe(jnp.ones(()))
        if not timed_block_until_ready(total, self.timeout_s):
            return False  # hung or failed collective — abort inside budget
        elapsed = time.time() - t0
        expected = n * (n + 1) // 2
        return bool((total == expected).all()) and elapsed < self.timeout_s


def scaling_efficiency(step_fn: Callable, make_args: Callable[[int], tuple],
                       device_counts, iters: int = 10):
    """Measure weak-scaling efficiency of ``step_fn`` across device subsets.

    ``make_args(n_devices)`` builds per-run inputs whose batch scales with n.
    Returns {n: (throughput, efficiency vs linear from smallest n)}.
    """
    from ..utils.profiling import timeit_jax
    results = {}
    base = None
    for n in device_counts:
        args = make_args(n)
        timing = timeit_jax(step_fn, *args, iters=iters)
        thr = n / timing.mean_s  # device-steps per second
        if base is None:
            base = thr / n
        results[n] = (thr, thr / (base * n))
    return results
