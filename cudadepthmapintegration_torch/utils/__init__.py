"""Utilities: logging, phase timing, dtype conversions and profiling."""

from .log import RAY_POTENTIAL_ASCII, Log
from .profiling import FusionMetrics, device_memory_stats, trace

__all__ = [
    "FusionMetrics",
    "Log",
    "RAY_POTENTIAL_ASCII",
    "device_memory_stats",
    "trace",
]
