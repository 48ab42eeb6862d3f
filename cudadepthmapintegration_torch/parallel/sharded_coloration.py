"""Distributed mesh coloration: vertices partitioned over the mesh's devices.

Coloration is per-vertex independent (``MeshColoration.cxx:140-190``), so it
shards as pure data parallelism: vertices are split into one contiguous
partition per mesh entry, and each partition runs the coloration kernels
(``kernels/coloration_cuda``) on its entry's device.

Views are streamed in ``view_chunk`` batches, read once and uploaded once
per distinct device. Each partition keeps one (V, n_part) buffer of packed
sample words on its device, which every batch's gather fills row by row;
the statistics kernel then reduces it in ``POINT_CHUNK`` column slices, one
host copy a slice. The statistics are integer-exact, so the result equals
``ops.coloration.colorize_points`` element for element.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.coloration_cuda import color_stats, gather_colors, split_stats, stage_texels
from ..ops.coloration import POINT_CHUNK, _check_kernel_dtype, _view_colors
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
    for dev in devices:
        _check_kernel_dtype(torch_dtype(dtype), torch.device(dev))
    bounds = np.linspace(0, n, len(devices) + 1).astype(np.int64)
    parts = [
        torch.from_numpy(np.ascontiguousarray(points[a:b], np_dtype)).to(dev)
        for a, b, dev in zip(bounds[:-1], bounds[1:], devices)
    ]
    words = [torch.empty((n_views, b - a), dtype=torch.int32, device=dev)
             for a, b, dev in zip(bounds[:-1], bounds[1:], devices)]
    vc = min(view_chunk, n_views)
    for vs in range(0, n_views, vc):
        batch = [views[i] for i in range(vs, min(vs + vc, n_views))]
        proj = np.stack([(v.camera.k4 @ v.camera.rt)[:3, :] for v in batch]).astype(np_dtype)
        colors = np.stack([_view_colors(v, h, w) for v in batch])
        staged = {}
        for p, dev in enumerate(devices):
            if dev not in staged:
                staged[dev] = (torch.from_numpy(proj).to(dev),
                               stage_texels(torch.from_numpy(colors).to(dev)))
            gather_colors(parts[p], *staged[dev], z_test, out=words[p], view_offset=vs)

    mean_u8 = np.zeros((n, 3), np.uint8)
    med_u8 = np.zeros((n, 3), np.uint8)
    counts = np.zeros((n,), np.int32)
    for p, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        for c in range(a, b, POINT_CHUNK):
            e = min(c + POINT_CHUNK, b)
            stats = color_stats(words[p][:, c - a : e - a]).cpu()
            mean_u8[c:e], med_u8[c:e], counts[c:e] = (t.numpy() for t in split_stats(stats))
    return mean_u8, med_u8, counts
