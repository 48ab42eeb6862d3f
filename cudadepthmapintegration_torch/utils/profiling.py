"""Profiling & metrics: device traces, throughput counters, roofline report.

The reference's only instrumentation is CPU ``clock()`` wall time
(``vtkCudaReconstructionFilter.cxx:101-148``) plus NSight debugging docs
(``README:43-50``). Here:

* :func:`trace` — context manager around ``torch.profiler`` (host ops and,
  with a card, CUDA kernels and copies) writing a Chrome trace JSON file
  into a directory;
* :func:`device_memory_stats` — live and peak bytes of the caching
  allocator and the card's memory;
* :class:`FusionMetrics` — structured counters for a fusion run (voxel
  updates/s, views/s, bytes of volume traffic, and that traffic's share of
  the card's peak memory bandwidth), with the JAX package's report keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import torch

__all__ = ["trace", "FusionMetrics", "device_memory_stats"]

# Peak memory bandwidth (bytes/s) by card name, as torch.cuda.get_device_name
# gives it (NVIDIA's data sheet). A card not listed gets no roofline fraction.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/trace'):`` records a ``torch.profiler`` trace of
    the block (CPU activity, and CUDA activity when a card is present) and
    writes it to ``log_dir/<time>.<pid>.trace.json`` (Chrome trace format,
    loadable in Perfetto or chrome://tracing), also when the block raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        name = f"{time.strftime('%Y%m%d_%H%M%S')}.{os.getpid()}.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def device_memory_stats(device="cuda") -> dict:
    """Live and peak bytes held by PyTorch's allocator on a CUDA device, and
    the device's memory size; ``{}`` for a device that is not a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }


def _card_name() -> str:
    return torch.cuda.get_device_name() if torch.cuda.is_available() else ""


@dataclasses.dataclass
class FusionMetrics:
    """Throughput accounting for a fusion run. ``chip`` is the card's name
    (``torch.cuda.get_device_name``; empty without a card)."""

    voxels: int = 0
    views: int = 0
    seconds: float = 0.0
    bytes_volume_traffic: int = 0
    chip: str = dataclasses.field(default_factory=_card_name)
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None
        return self

    def add_fusion(self, num_cells: int, num_views: int, passes: int = 1):
        """Record one fused batch: `passes` = volume read+write sweeps."""
        self.voxels = num_cells
        self.views += num_views
        self.bytes_volume_traffic += passes * 2 * 4 * num_cells
        return self

    @property
    def voxel_updates_per_sec(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.voxels * self.views / self.seconds

    @property
    def views_per_sec(self) -> float:
        return self.views / self.seconds if self.seconds > 0 else 0.0

    @property
    def hbm_roofline_fraction(self) -> float | None:
        """Volume traffic over the card's peak memory bandwidth (the
        kernel's least traffic); None for a card not in ``HBM_PEAK``."""
        if self.seconds <= 0:
            return 0.0
        peak = HBM_PEAK.get(self.chip)
        if peak is None:
            return None
        return (self.bytes_volume_traffic / self.seconds) / peak

    def report(self) -> dict:
        return {
            "voxels": self.voxels,
            "views": self.views,
            "seconds": round(self.seconds, 6),
            "voxel_updates_per_sec": self.voxel_updates_per_sec,
            "views_per_sec": self.views_per_sec,
            "hbm_roofline_fraction": self.hbm_roofline_fraction,
        }

    def json(self) -> str:
        return json.dumps(self.report())
