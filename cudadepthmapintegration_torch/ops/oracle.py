"""Float64 NumPy oracle for TSDF integration.

Literal (but vectorized) re-statement of the CUDA kernel semantics
(``Reconstruction/CudaReconstruction.cu:158-212``), the ground truth that
``chip_smoke.py`` holds the integrate kernel to (the reference computes in double:
``TypeCompute = double``, ``CudaReconstruction.cu:51``, and instantiates
``ProcessDepthMap<double>`` at ``vtkCudaReconstructionFilter.cxx:175``).

Per voxel (cell) center and per view:
  1. center = origin + (idx + 0.5) * spacing            (.cu:78-83)
  2. world  = grid_matrix @ center                      (.cu:168)
  3. cam    = RT @ world                                (.cu:172)
  4. hom    = K4 @ cam; reject hom.z < 0                (.cu:176-180)
  5. pixel  = round(hom.xy / hom.z); bounds-check       (.cu:183-197)
  6. depth  = depth_map[pixel] (y-flip); reject == -1   (.cu:200-205)
  7. value  = ray_potential(cam.z, depth)               (.cu:207-209)
  8. volume[voxel] += value                             (.cu:211)
"""

from __future__ import annotations

import numpy as np

from ..core.camera import round_half_away
from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential, ray_potential_np
from ..core.view import DepthMapView

__all__ = ["integrate_views_oracle"]


def integrate_views_oracle(
    grid: VoxelGrid,
    views: list[DepthMapView],
    params: RayPotential,
    threshold_best_cost: float | None = None,
    initial: np.ndarray | None = None,
) -> np.ndarray:
    """Fuse `views` into a (cz, cy, cx) float64 volume.

    ``threshold_best_cost`` applies the best-cost depth invalidation
    (``ReconstructionData.cxx:138-167``) before integration, as the streaming
    loop does at ``CudaReconstruction.cu:348``.
    """
    vol = (
        np.zeros(grid.volume_shape, dtype=np.float64)
        if initial is None
        else initial.astype(np.float64).copy()
    )
    centers = grid.cell_centers_world(np.float64)  # (cz, cy, cx, 3)

    for view in views:
        if threshold_best_cost is not None:
            view = view.thresholded(threshold_best_cost)
        h, w = view.depth.shape
        u, v, cam_z, hom_z = view.camera.project_points(centers)
        px = round_half_away(u)
        py = round_half_away(v)
        valid = (
            (hom_z >= 0)
            & np.isfinite(px)
            & np.isfinite(py)
            & (px >= 0)
            & (py >= 0)
            & (px < w)
            & (py < h)
        )
        ui = np.where(valid, px, 0).astype(np.int64)
        vi = np.where(valid, py, 0).astype(np.int64)
        depth = view.depth[vi, ui]  # top-down storage == reference's y-flip read
        valid &= depth != -1.0
        value = ray_potential_np(cam_z, depth, params)
        vol += np.where(valid, value, 0.0)
    return vol
