"""What the port's scripts share: the device a script runs on, the
card's description, a clock that drains the card at both ends, the host
render of a rig's sphere maps, the integrate kernel's staged inputs, the
bitwise comparison of two volumes and the flipped-sample rule of the float32
studies."""

from __future__ import annotations

import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import camera
from ..core.view import DepthMapView
from ..kernels import integrate_cuda
from ..ops.integrate import projection_tables
from ..testing import render_sphere_view

__all__ = ["Clock", "card_description", "kernel_flips", "render_views", "same_bits",
           "script_device", "staged_inputs"]


def script_device(device, script: str) -> torch.device:
    """``device`` as a torch.device for ``script`` (named in the error): cuda
    or cpu, and a CUDA device with no card raises (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{script} runs on cuda or cpu, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{script} on a CUDA device needs a card and none is available "
                           "(--device cpu runs the plain versions)")
    return device


def card_description(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


class Clock:
    """Seconds of a block of work: host wall time with the device drained at
    both ends (``seconds``) and, on a card, the CUDA-event time on the
    current stream (``event_seconds``, else None)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.seconds = self.event_seconds = None

    def __enter__(self) -> "Clock":
        if self.cuda:
            torch.cuda.synchronize()
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            self._events[1].record()
            torch.cuda.synchronize()
            self.event_seconds = self._events[0].elapsed_time(self._events[1]) / 1e3
        self.seconds = time.perf_counter() - self._t0


def staged_inputs(grid, views, dtype, device) -> list[torch.Tensor]:
    """The integrate kernel's inputs for ``views`` on ``device``: the
    projection tables (tx, ty, tz, tc) and the stacked maps, in ``dtype``."""
    t = projection_tables(grid, views, dtype)
    depths = np.stack([v.depth for v in views]).astype(dtype)
    return [torch.from_numpy(a).to(device) for a in (t.tx, t.ty, t.tz, t.tc, depths)]


def render_views(cameras, width: int, height: int, **kwargs) -> list[DepthMapView]:
    """``testing.render_sphere_view`` of every camera on the host, in
    float64, one map a thread of a pool (NumPy lets go of the interpreter
    lock in its loops): the maps of one loop over the cameras, in order."""
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(lambda c: render_sphere_view(c, width, height, **kwargs), cameras))


def same_bits(a, b) -> bool:
    """Equal shapes and bit patterns (tensors or NumPy arrays, viewed as
    int32): unlike ``==``, tells -0.0 from +0.0."""
    if a.shape != b.shape:
        return False
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(np.array_equal(a.view(np.int32), b.view(np.int32)))


def kernel_flips(u64, v64, z64, hom32, width: int, height: int):
    """The flipped-sample rule: where the integrate kernel's float32
    projection of a sample (a cell centre in one view) and its float64
    projection disagree.

    ``u64``, ``v64`` are the float64 pixel coordinates before rounding and
    ``z64`` the homogeneous z; ``hom32`` are the kernel's three float32
    homogeneous rows, ``ty + (tx + (tz + tc))``. Both round half away from
    zero. A sample is on the ``width`` x ``height`` map where its z is not
    negative and its pixel lies inside; it is projected where either
    projection puts it on the map, and flipped where the two differ in its
    pixel or in its being on the map at all. NumPy arrays or tensors, all of
    one kind. Returns the float64 pixel and on-map mask ``(px, py, on64)``
    and the masks ``(projected, flipped)``."""
    rnd = (integrate_cuda.round_half_away if isinstance(u64, torch.Tensor)
           else camera.round_half_away)

    def on_map(px, py, z):  # a NaN or infinite pixel fails a bound
        return (z >= 0) & (px >= 0) & (py >= 0) & (px < width) & (py < height)

    px, py = rnd(u64), rnd(v64)
    on64 = on_map(px, py, z64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u32, v32 = rnd(hom32[0] / hom32[2]), rnd(hom32[1] / hom32[2])
    on32 = on_map(u32, v32, hom32[2])
    flipped = (on64 != on32) | (on64 & ((px != u32) | (py != v32)))
    return (px, py, on64), (on64 | on32, flipped)
