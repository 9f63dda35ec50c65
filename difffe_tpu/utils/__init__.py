"""Utilities: checkpointing, profiling, configs, metrics, debug guards."""

from .checkpoint import CheckpointManager
from .debug import check_deterministic, golden_compare, nan_guard
from .config import BASELINE_CONFIGS, ScenarioConfig
from .metrics import MetricsLogger
from .profiling import (DEVICE_PEAKS, Roofline, TimingResult, device_peaks,
                        roofline, timeit_jax, trace)

__all__ = [
    "CheckpointManager",
    "check_deterministic",
    "golden_compare",
    "nan_guard",
    "BASELINE_CONFIGS",
    "ScenarioConfig",
    "MetricsLogger",
    "DEVICE_PEAKS",
    "device_peaks",
    "Roofline",
    "TimingResult",
    "roofline",
    "timeit_jax",
    "trace",
]
