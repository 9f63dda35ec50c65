"""Tracing / profiling harness — absent in the reference (SURVEY.md §5:
no profiler import, no timers anywhere).

* ``timeit_jax`` — wall-clock timing with proper ``block_until_ready``
  synchronization and compile-warmup exclusion (the correct way to time XLA).
* ``trace`` — context manager around ``jax.profiler`` emitting
  Perfetto/XProf traces.
* ``roofline`` — per-kernel speed-of-light estimate: achieved FLOP/s and
  bytes/s against the device's published peaks (``DEVICE_PEAKS``, keyed
  by ``device_kind``), to judge how close a kernel is to the memory
  bandwidth or arithmetic ceiling.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class TimingResult:
    mean_s: float
    min_s: float
    iters: int

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    def throughput(self, items: int) -> float:
        """items processed per second at the mean latency."""
        return items / self.mean_s


def timeit_jax(fn: Callable, *args, iters: int = 20, warmup: int = 2,
               **kwargs) -> TimingResult:
    """Time a JAX callable: warm up (compile), then time ``iters`` calls with
    a single trailing synchronization (amortizes dispatch, like production
    pipelining) and a per-call minimum from individual synced runs.
    Repeated identical calls can overlap in the dispatch queue; for a
    device rate of a step, prefer :func:`timeit_chained`.
    """
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    mean = (time.perf_counter() - t0) / iters

    best = float("inf")
    for _ in range(min(iters, 5)):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return TimingResult(mean_s=mean, min_s=best, iters=iters)


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True):
    """Capture a profiler trace viewable in XProf/Perfetto/TensorBoard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published dense peaks of one device (no sparsity)."""

    bf16_tflops: float
    tf32_tflops: float
    f32_tflops: float
    hbm_gbps: float
    source: str


#: Keyed by the exact ``jax.Device.device_kind``.  The H100 SXM rates
#: assume its full 700 W power limit; a card set lower cannot hold its top
#: clock under load, so report its ``power.limit`` beside any share.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        bf16_tflops=989.0, tf32_tflops=495.0, f32_tflops=67.0,
        hbm_gbps=3350.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, 700 W"),
}


def device_peaks(device_kind: str) -> DevicePeaks:
    """Peaks of ``device_kind``; a device not in the table is an error."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add a "
            f"DEVICE_PEAKS row with its source") from None


@dataclasses.dataclass(frozen=True)
class Roofline:
    achieved_tflops: float
    achieved_gbps: float
    flops_fraction: float
    bandwidth_fraction: float
    bound: str  # 'compute' | 'memory'


def roofline(timing: TimingResult, flops: float, bytes_moved: float,
             device_kind: str, dtype: str = "f32") -> Roofline:
    """Judge a kernel against the speed of light of ``device_kind``.

    ``dtype``: 'bf16', 'tf32' (f32 matmuls at default precision) or 'f32'
    (f32 arithmetic outside the tensor cores)."""
    peaks = device_peaks(device_kind)
    peak_tflops = {"bf16": peaks.bf16_tflops, "tf32": peaks.tf32_tflops,
                   "f32": peaks.f32_tflops}[dtype]
    t = timing.min_s
    achieved_tflops = flops / t / 1e12
    achieved_gbps = bytes_moved / t / 1e9
    ai = flops / max(bytes_moved, 1.0)  # arithmetic intensity
    ridge = peak_tflops * 1e12 / (peaks.hbm_gbps * 1e9)
    return Roofline(
        achieved_tflops=achieved_tflops,
        achieved_gbps=achieved_gbps,
        flops_fraction=achieved_tflops / peak_tflops,
        bandwidth_fraction=achieved_gbps / peaks.hbm_gbps,
        bound="memory" if ai < ridge else "compute",
    )


def timeit_chained(step_fn: Callable, x0, length: int = 32,
                   repeats: int = 3, args=()) -> TimingResult:
    """Honest device throughput: ``length`` CHAINED steps inside one jitted
    ``lax.scan`` (step N+1 consumes step N's carry — nothing to elide, no
    async-dispatch credit), one host fetch at the end to force completion.

    ``step_fn(carry) -> carry`` must return a pytree matching ``carry``.
    Returns per-STEP timing.  The single dispatch+fetch round trip is
    amortized across ``length`` steps; increase ``length`` until two
    repeats agree if the op is very fast.

    Pass large non-carry operands via ``args`` (forwarded as
    ``step_fn(carry, *args)``): closure-captured arrays are baked into the
    HLO as constants, which inflates the program and its compile time.
    """
    @jax.jit
    def run(c0, *a):
        def body(c, _):
            return step_fn(c, *a), ()
        c, _ = jax.lax.scan(body, c0, None, length=length)
        return c

    out = run(x0, *args)
    jax.tree_util.tree_map(
        lambda a: float(jnp.asarray(a).ravel()[0]), out)   # materialize

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run(x0, *args)
        jax.tree_util.tree_map(
            lambda a: float(jnp.asarray(a).ravel()[0]), out)
        times.append((time.perf_counter() - t0) / length)
    return TimingResult(mean_s=sum(times) / len(times), min_s=min(times),
                        iters=length * repeats)
