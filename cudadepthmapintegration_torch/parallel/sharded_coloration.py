"""Distributed mesh coloration: vertices partitioned over the mesh's devices.

Coloration is per-vertex independent (``MeshColoration.cxx:140-190``), so it
shards as pure data parallelism: vertices are split into one contiguous
partition per mesh entry, and each partition runs the coloration kernel
(``kernels/coloration_cuda.gather_colors``) on its entry's device.

Views are streamed in ``view_chunk`` batches, read once and uploaded once
per distinct device. Each partition keeps its gathered samples on its
device for the exact masked median; the per-batch integer sums and counts
are accumulated in float64 and int64 on the host (integer-exact), so the
result equals ``ops.coloration.colorize_points`` element for element.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.coloration_cuda import gather_colors
from ..ops.coloration import POINT_CHUNK, _median_from_samples, _view_colors
from ..utils.dtype import numpy_dtype, torch_dtype
from .mesh import DeviceMesh

__all__ = ["sharded_colorize_points"]


def sharded_colorize_points(
    points: np.ndarray,
    views,
    mesh: DeviceMesh,
    view_chunk: int = 64,
    z_test: bool = False,
    dtype=torch.float32,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Like ``ops.coloration.colorize_points`` but partitioned over the mesh.

    Returns (mean_uint8 (N,3), median_uint8 (N,3), count_int32 (N,)).
    """
    n_views = len(views)
    if n_views == 0:
        raise ValueError("no views given for coloration")
    np_dtype = numpy_dtype(torch_dtype(dtype))
    h, w = views[0].depth.shape
    n = points.shape[0]
    devices = list(mesh.devices.reshape(-1))
    bounds = np.linspace(0, n, len(devices) + 1).astype(np.int64)
    parts = [
        torch.from_numpy(np.ascontiguousarray(points[a:b], np_dtype)).to(dev)
        for a, b, dev in zip(bounds[:-1], bounds[1:], devices)
    ]
    samples = [[] for _ in devices]
    valid = [[] for _ in devices]
    sums = np.zeros((n, 3), np.float64)
    counts = np.zeros((n,), np.int64)
    vc = min(view_chunk, n_views)
    for vs in range(0, n_views, vc):
        batch = [views[i] for i in range(vs, min(vs + vc, n_views))]
        proj = np.stack([(v.camera.k4 @ v.camera.rt)[:3, :] for v in batch]).astype(np_dtype)
        colors = np.stack([_view_colors(v, h, w) for v in batch])
        staged = {}
        for p, (a, b, dev) in enumerate(zip(bounds[:-1], bounds[1:], devices)):
            if dev not in staged:
                staged[dev] = (torch.from_numpy(proj).to(dev), torch.from_numpy(colors).to(dev))
            rgb, ok = gather_colors(parts[p], *staged[dev], z_test)
            samples[p].append(rgb)
            valid[p].append(ok)
            sums[a:b] += (rgb.to(torch.int64) * ok[..., None]).sum(dim=0).cpu().numpy()
            counts[a:b] += ok.sum(dim=0).cpu().numpy()

    meds = np.zeros((n, 3), np.float32)
    for p, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        smp, ok = torch.cat(samples[p]), torch.cat(valid[p])
        # In vertex chunks: bounds the sort's buffers as colorize_points does.
        for c in range(0, b - a, POINT_CHUNK):
            meds[a + c : min(a + c + POINT_CHUNK, b)] = (
                _median_from_samples(smp[:, c : c + POINT_CHUNK], ok[:, c : c + POINT_CHUNK])
                .cpu().numpy()
            )
    mean = sums / np.maximum(counts[:, None], 1)
    # vtk uchar-array SetTuple truncates doubles (MeshColoration.cxx:180,185).
    mean_u8 = np.clip(mean, 0, 255).astype(np.uint8)
    med_u8 = np.clip(meds, 0, 255).astype(np.uint8)
    return mean_u8, med_u8, counts.astype(np.int32)
