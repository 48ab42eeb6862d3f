"""Mesh coloration: per-vertex color statistics over all views.

Port of ``MeshColoration::ProcessColoration``
(``Coloration/MeshColoration.cxx:98-199``) as the JAX package has it: a
batched project -> gather -> masked reduction over (vertex-chunk,
view-chunk) blocks, on a PyTorch device. Both steps are the kernels of
``kernels/coloration_cuda`` (CUDA kernels for CUDA tensors, their plain
versions for CPU tensors): per vertex chunk every view batch's
``gather_colors`` writes its rows of one (V, chunk) buffer of packed sample
words, one ``color_stats`` reduces it, and one copy brings the chunk's
10 bytes a vertex to the host.

Memory model: views are staged ``view_chunk`` at a time (colours as RGBX
words), and staged batches are kept for the next vertex chunk while their
total stays under a budget. Per vertex chunk the sample words of all views
are kept for the exact median.

Reference semantics preserved exactly:

* Projection via ``TransformWorldToDepthMapPosition``
  (``Sources/ReconstructionData.cxx:169-182``); **no** hom.z < 0 rejection
  and **no** occlusion test unless asked for (``z_test``,
  ``occlusion_tol``).
* Bounds test against view-0 dimensions (``MeshColoration.cxx:158-163``).
* ``MeanColoration``: the reference accumulates uchar samples into an int
  (``MeshColoration.cxx:176-178``); the sums here are integers too, so
  ``compat_int_mean`` is accepted as a no-op for CLI compatibility. The
  mean is then truncated to uchar.
* ``MedianColoration``: the middle of the sorted samples; even counts
  average the two middle values (``Sources/Helper.h:174-187``), then
  truncate to uchar.
* ``NbProjectedDepthMap``: int count of in-bounds projections.
* Zero-hit vertices keep (0,0,0)/0 (``MeshColoration.cxx:113-133,173``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.view import DepthMapView
from ..io.polydata import PolyData
from ..kernels.coloration_cuda import color_stats, gather_colors, split_stats, stage_texels
from ..utils.dtype import numpy_dtype, torch_dtype

__all__ = ["POINT_CHUNK", "colorize_mesh", "colorize_points"]

# Vertices per chunk: bounds the (views, chunk) word buffer the statistics
# read (4 bytes a sample).
POINT_CHUNK = 1 << 16
# Bytes of staged view batches kept on the device across vertex chunks;
# above it each batch is staged again per chunk (the streaming regime).
_STAGED_BUDGET = 1536 << 20


def _view_colors(v: DepthMapView, h: int, w: int) -> np.ndarray:
    return v.color if v.color is not None else np.zeros((h, w, 3), np.uint8)


def _check_kernel_dtype(dtype: torch.dtype, device: torch.device) -> None:
    """The CUDA kernels project in float32 only, with or without the
    occlusion test: refuse any other dtype on a CUDA device up front."""
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"coloration on a CUDA device projects in float32 only, got {dtype} "
                         "(float64 runs on the CPU device)")


def colorize_points(
    points: np.ndarray,
    views,
    chunk: int = POINT_CHUNK,
    view_chunk: int = 64,
    z_test: bool = False,
    dtype=torch.float32,
    compat_int_mean: bool = False,
    occlusion_tol: float | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Color statistics for (N, 3) world points against all views.

    ``views`` is any indexable sequence of DepthMapView (e.g. a lazy
    dataset): views are loaded and staged ``view_chunk`` at a time.
    ``dtype`` is the projection compute precision; on a CUDA device the
    kernels take float32 only, and any other dtype raises. ``occlusion_tol``
    (opt-in) hands each view batch's depth maps to the gather, which then
    rejects occluded samples.

    Returns (mean_uint8 (N,3), median_uint8 (N,3), count_int32 (N,)).
    """
    del compat_int_mean  # the integer sums already are the int accumulate
    n_views = len(views)
    if n_views == 0:
        raise ValueError("no views given for coloration")
    dtype = torch_dtype(dtype)
    device = torch.device(device)
    _check_kernel_dtype(dtype, device)
    np_dtype = numpy_dtype(dtype)
    h, w = views[0].depth.shape
    n = points.shape[0]
    mean_u8 = np.zeros((n, 3), np.uint8)
    med_u8 = np.zeros((n, 3), np.uint8)
    counts = np.zeros((n,), np.int32)
    vc = min(view_chunk, n_views)
    staged: dict[int, tuple] = {}
    staged_bytes = 0

    def stage(vs: int) -> tuple:
        nonlocal staged_bytes
        if vs in staged:
            return staged[vs]
        batch = [views[i] for i in range(vs, min(vs + vc, n_views))]
        proj = np.stack([(v.camera.k4 @ v.camera.rt)[:3, :] for v in batch]).astype(np_dtype)
        colors = np.stack([_view_colors(v, h, w) for v in batch])
        texels = stage_texels(torch.from_numpy(colors).to(device))
        depths = None
        if occlusion_tol is not None:
            depths = torch.from_numpy(np.stack([np.asarray(v.depth, np.float32)
                                                for v in batch])).to(device)
        arrays = (torch.from_numpy(proj).to(device), texels, depths)
        nbytes = texels.nbytes + (0 if depths is None else depths.nbytes)
        if staged_bytes + nbytes <= _STAGED_BUDGET:
            staged[vs] = arrays
            staged_bytes += nbytes
        return arrays

    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        pts = torch.from_numpy(np.ascontiguousarray(points[start:stop], np_dtype)).to(device)
        words = torch.empty((n_views, stop - start), dtype=torch.int32, device=device)
        for vs in range(0, n_views, vc):
            proj, texels, depths = stage(vs)
            gather_colors(pts, proj, texels, z_test, depths=depths,
                          occlusion_tol=occlusion_tol or 0.0, out=words, view_offset=vs)
        mean_u8[start:stop], med_u8[start:stop], counts[start:stop] = (
            t.numpy() for t in split_stats(color_stats(words).cpu()))
    return mean_u8, med_u8, counts


def colorize_mesh(
    mesh: PolyData,
    views,
    chunk: int = POINT_CHUNK,
    view_chunk: int = 64,
    z_test: bool = False,
    dtype=torch.float32,
    compat_int_mean: bool = False,
    occlusion_tol: float | None = None,
    device: str | torch.device = "cuda",
) -> PolyData:
    """Attach MeanColoration / MedianColoration / NbProjectedDepthMap arrays
    (names per ``MeshColoration.cxx:113-133``) to a copy of `mesh`."""
    out = PolyData(mesh.points.copy(), mesh.triangles.copy())
    out.point_data = dict(mesh.point_data)
    out.active_scalars = getattr(mesh, "active_scalars", None)
    mean_u8, med_u8, counts = colorize_points(
        mesh.points, views, chunk=chunk, view_chunk=view_chunk,
        z_test=z_test, dtype=dtype, compat_int_mean=compat_int_mean,
        occlusion_tol=occlusion_tol, device=device,
    )
    out.point_data["MeanColoration"] = mean_u8
    out.point_data["MedianColoration"] = med_u8
    out.point_data["NbProjectedDepthMap"] = counts
    return out
