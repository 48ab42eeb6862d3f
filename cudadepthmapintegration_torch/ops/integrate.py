"""TSDF integration on a PyTorch device.

Counterpart of ``cudadepthmapintegration_tpu/ops/integrate.py``:

* **Separable projection.** A voxel center is ``origin + (idx+0.5)*spacing``,
  so for the composed projection ``P = K4 @ RT @ grid_matrix`` the
  homogeneous coordinate of cell (k, j, i) is a sum of three per-axis 1-D
  tables plus a constant. The tables are built on the host in float64 and
  rounded once into the compute dtype (:func:`projection_tables`).
* **Per-voxel work** runs in ``kernels/integrate_cuda``: the hand-written
  CUDA kernel for a CUDA volume, its plain PyTorch version for a CPU volume.
* **Summation order** is the Pallas kernel's at ``view_block=1`` and the
  reference CUDA kernel's: views are added into each voxel one at a time,
  in the order given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.camera import compose_projection
from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..core.view import DepthMapView
from ..kernels.integrate_cuda import integrate_views
from ..utils.dtype import numpy_dtype, torch_dtype

__all__ = ["ProjectionTables", "projection_tables", "TSDFIntegrator"]


@dataclasses.dataclass
class ProjectionTables:
    """Per-view separable projection tables.

    Rows 0..2 are the composed projection ``P = K4 @ RT @ grid_matrix``;
    row 3 is the camera-z functional (row 2 of ``RT @ grid_matrix``) that
    supplies ``realDepth`` (``CudaReconstruction.cu:207``).

    Shapes: tx (V, 4, cx), ty (V, 4, cy), tz (V, 4, cz), tc (V, 4).
    """

    tx: np.ndarray
    ty: np.ndarray
    tz: np.ndarray
    tc: np.ndarray


def projection_tables(
    grid: VoxelGrid, views: list[DepthMapView], dtype=np.float32
) -> ProjectionTables:
    """Build per-view separable tables in float64, rounding once to `dtype`."""
    xs, ys, zs = grid.cell_center_axes(np.float64)
    tx, ty, tz, tc = [], [], [], []
    for view in views:
        p_full, cam_row = compose_projection(view.camera, grid)
        rows = np.vstack([p_full[:3, :], cam_row[None, :]])  # (4, 4)
        tx.append(rows[:, 0:1] * xs[None, :])
        ty.append(rows[:, 1:2] * ys[None, :])
        tz.append(rows[:, 2:3] * zs[None, :])
        tc.append(rows[:, 3])
    return ProjectionTables(
        tx=np.stack(tx).astype(dtype),
        ty=np.stack(ty).astype(dtype),
        tz=np.stack(tz).astype(dtype),
        tc=np.stack(tc).astype(dtype),
    )


class TSDFIntegrator:
    """Streamed TSDF fusion (``ProcessDepthMap``,
    ``CudaReconstruction.cu:302-386``): owns a (cz, cy, cx) volume on
    ``device`` and adds streamed batches of depth maps into it.

    The volume is updated in place by every :meth:`integrate` call; only
    :meth:`result` copies it to the host. On a CUDA device it must be
    float32 (the kernel's type); on the CPU float64 is allowed too.
    """

    def __init__(
        self,
        grid: VoxelGrid,
        params: RayPotential,
        dtype=torch.float32,
        device: str | torch.device = "cuda",
    ):
        self.grid = grid
        self.params = params
        self.dtype = torch_dtype(dtype)
        self.device = torch.device(device)
        self.volume: torch.Tensor | None = None
        self.views_fused = 0
        # Volume read+write sweeps since reset: one per kernel launch.
        self.volume_sweeps = 0
        # (h, w) of the first view since reset: every map must match it
        # (vtkCudaReconstructionFilter.cxx:167-173).
        self._map_shape: tuple[int, int] | None = None

    def reset(self, initial=None) -> "TSDFIntegrator":
        """Start from zeros, or resume from ``initial``: any (cz, cy, cx)
        array, e.g. the JAX integrator's ``result()``. It is copied."""
        shape = self.grid.volume_shape
        if initial is None:
            self.volume = torch.zeros(shape, dtype=self.dtype, device=self.device)
        else:
            vol = torch.from_numpy(np.array(initial))  # a copy
            if tuple(vol.shape) != shape:
                raise ValueError(
                    f"initial volume has shape {tuple(vol.shape)}, expected {shape}"
                )
            self.volume = vol.to(self.device, self.dtype).contiguous()
        self.views_fused = 0
        self.volume_sweeps = 0
        self._map_shape = None
        return self

    def integrate(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
    ) -> "TSDFIntegrator":
        """Fuse a batch of views into the held volume (one kernel launch)."""
        if self.volume is None:
            self.reset()
        if not views:
            return self
        if threshold_best_cost is not None:
            views = [v.thresholded(threshold_best_cost) for v in views]
        expected = self._map_shape or views[0].depth.shape
        for view in views:
            if view.depth.shape != expected:
                raise ValueError(
                    f"depth map {view.name!r} has shape {view.depth.shape}, "
                    f"expected {expected}"
                )
        self._map_shape = expected
        np_dtype = numpy_dtype(self.dtype)
        tables = projection_tables(self.grid, views, np_dtype)
        depths = np.stack([v.depth for v in views]).astype(np_dtype)
        integrate_views(
            self.volume,
            *(torch.from_numpy(a).to(self.device)
              for a in (tables.tx, tables.ty, tables.tz, tables.tc, depths)),
            self.params,
        )
        self.views_fused += len(views)
        self.volume_sweeps += 1
        return self

    def synchronize(self) -> "TSDFIntegrator":
        """Wait until the device has finished every launch so far."""
        if self.volume is not None and self.volume.is_cuda:
            torch.cuda.synchronize(self.volume.device)
        return self

    def flush(self) -> "TSDFIntegrator":
        """Kept for the JAX integrator's interface: this one buffers no
        views, so there is nothing to flush."""
        return self

    def result(self) -> np.ndarray:
        """Copy the fused (cz, cy, cx) volume to the host."""
        if self.volume is None:
            self.reset()
        return self.volume.to("cpu", copy=True).numpy()
