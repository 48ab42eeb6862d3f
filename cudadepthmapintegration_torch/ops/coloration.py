"""Mesh coloration: per-vertex color statistics over all views.

Port of ``MeshColoration::ProcessColoration``
(``Coloration/MeshColoration.cxx:98-199``) as the JAX package has it: a
batched project -> gather -> masked reduction over (vertex-chunk,
view-chunk) blocks, on a PyTorch device. The gather is
``kernels/coloration_cuda.gather_colors`` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors); the reductions are plain
PyTorch on the same device.

Memory model: views are staged ``view_chunk`` at a time, and staged batches
are kept for the next vertex chunk while their total stays under a budget.
Per vertex chunk the gathered samples of all views are kept for the exact
masked median.

Reference semantics preserved exactly:

* Projection via ``TransformWorldToDepthMapPosition``
  (``Sources/ReconstructionData.cxx:169-182``); **no** hom.z < 0 rejection
  and **no** occlusion test unless asked for (``z_test``,
  ``occlusion_tol``).
* Bounds test against view-0 dimensions (``MeshColoration.cxx:158-163``).
* ``MeanColoration``: the reference accumulates uchar samples into an int
  (``MeshColoration.cxx:176-178``); the sums here are int64, so the int
  and float accumulates coincide, and ``compat_int_mean`` is accepted as
  a no-op for CLI compatibility. The mean is then truncated to uchar.
* ``MedianColoration``: sort + middle; even counts average the two middle
  values (``Sources/Helper.h:174-187``), then truncate to uchar.
* ``NbProjectedDepthMap``: int count of in-bounds projections.
* Zero-hit vertices keep (0,0,0)/0 (``MeshColoration.cxx:113-133,173``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.view import DepthMapView
from ..io.polydata import PolyData
from ..kernels.coloration_cuda import gather_colors, project_points
from ..utils.dtype import numpy_dtype, torch_dtype

__all__ = ["POINT_CHUNK", "colorize_mesh", "colorize_points"]

# Vertices per gather call: bounds the (views, chunk, 3) sample buffer the
# exact median sorts.
POINT_CHUNK = 1 << 16
# Bytes of staged view batches kept on the device across vertex chunks;
# above it each batch is staged again per chunk (the streaming regime).
_STAGED_BUDGET = 1536 << 20


def _gather_occluded(points, proj, colors, depths, z_test, occlusion_tol):
    """Plain gather with the opt-in occlusion test (the counterpart of the
    JAX package's XLA ``_gather_chunk(occlusion=True)``; the reference
    samples straight through occluders). A sample is rejected when its
    camera z exceeds the view's depth at the pixel by more than
    ``occlusion_tol``, when that depth is the -1 sentinel, or when the
    vertex is behind the camera (z <= 0)."""
    n_views, h, w, _ = colors.shape
    idx, valid, z = project_points(points, proj, h, w, z_test)
    d = torch.take_along_dim(depths.reshape(n_views, h * w), idx, dim=1).to(z.dtype)
    tol = torch.tensor(occlusion_tol, dtype=z.dtype, device=z.device)
    valid &= (z > 0) & (d != -1.0) & (z <= d + tol)
    samples = torch.take_along_dim(colors.reshape(n_views, h * w, 3), idx[..., None], dim=1)
    return samples, valid


def _median_from_samples(samples: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked median over the view axis: samples (V, N, 3) uint8,
    valid (V, N) bool -> median (N, 3) float32.

    Invalid -> +inf, sort ascending over views, then the two middle *valid*
    entries are at (count-1)//2 and count//2 (Helper.h:174-187)."""
    count = valid.sum(dim=0)
    big = torch.where(valid[..., None], samples.to(torch.float32), torch.inf)
    srt = torch.sort(big, dim=0).values  # (V, N, 3)
    lo = torch.clamp((count - 1) // 2, min=0)
    hi = count // 2

    def take(i):
        return torch.gather(srt, 0, i[None, :, None].expand(1, -1, 3))[0]

    med = 0.5 * (take(lo) + take(hi))
    return torch.where(count[:, None] > 0, med, 0.0)


def _view_colors(v: DepthMapView, h: int, w: int) -> np.ndarray:
    return v.color if v.color is not None else np.zeros((h, w, 3), np.uint8)


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
    kernel takes float32 only. ``occlusion_tol`` (opt-in) runs the plain
    occlusion-testing gather instead of the kernel.

    Returns (mean_uint8 (N,3), median_uint8 (N,3), count_int32 (N,)).
    """
    del compat_int_mean  # the int64 sums already are the int accumulate
    n_views = len(views)
    if n_views == 0:
        raise ValueError("no views given for coloration")
    dtype = torch_dtype(dtype)
    device = torch.device(device)
    np_dtype = numpy_dtype(dtype)
    h, w = views[0].depth.shape
    n = points.shape[0]
    means = np.zeros((n, 3), np.float64)
    meds = np.zeros((n, 3), np.float32)
    counts = np.zeros((n,), np.int64)
    vc = min(view_chunk, n_views)
    staged: dict[int, tuple] = {}
    staged_bytes = 0

    def stage(vs: int) -> tuple:
        nonlocal staged_bytes
        if vs in staged:
            return staged[vs]
        batch = [views[i] for i in range(vs, min(vs + vc, n_views))]
        proj = np.stack([(v.camera.k4 @ v.camera.rt)[:3, :] for v in batch])
        colors = np.stack([_view_colors(v, h, w) for v in batch])
        depths = None
        if occlusion_tol is not None:
            depths = np.stack([np.asarray(v.depth, np.float32) for v in batch])
        arrays = tuple(
            None if a is None else torch.from_numpy(a).to(device)
            for a in (proj.astype(np_dtype), colors, depths)
        )
        nbytes = colors.nbytes + (0 if depths is None else depths.nbytes)
        if staged_bytes + nbytes <= _STAGED_BUDGET:
            staged[vs] = arrays
            staged_bytes += nbytes
        return arrays

    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        pts = torch.from_numpy(np.ascontiguousarray(points[start:stop], np_dtype)).to(device)
        sample_parts, valid_parts = [], []
        for vs in range(0, n_views, vc):
            proj, colors, depths = stage(vs)
            if occlusion_tol is None:
                rgb, ok = gather_colors(pts, proj, colors, z_test)
            else:
                rgb, ok = _gather_occluded(pts, proj, colors, depths, z_test, occlusion_tol)
            sample_parts.append(rgb)
            valid_parts.append(ok)
        samples = torch.cat(sample_parts)
        valid = torch.cat(valid_parts)
        cnt = valid.sum(dim=0)
        sums = (samples.to(torch.int64) * valid[..., None]).sum(dim=0)
        meds[start:stop] = _median_from_samples(samples, valid).cpu().numpy()
        cnt_host = cnt.cpu().numpy()
        counts[start:stop] = cnt_host
        means[start:stop] = sums.cpu().numpy() / np.maximum(cnt_host[:, None], 1)

    # vtk uchar-array SetTuple truncates doubles (MeshColoration.cxx:180,185).
    mean_u8 = np.clip(means, 0, 255).astype(np.uint8)
    med_u8 = np.clip(meds, 0, 255).astype(np.uint8)
    return mean_u8, med_u8, counts.astype(np.int32)


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
