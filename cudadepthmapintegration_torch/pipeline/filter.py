"""Filter-style embedding API.

Counterpart of ``vtkCudaReconstructionFilter``
(``Reconstruction/vtkCudaReconstructionFilter.h:48-120``), for codebases that
consumed the reference as a pipeline filter (TeleSculptor/MAP-Tk style):
construct, call the same setters, ``update()``, read the fused grid and
``get_execution_time()``.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..io.dataset import DepthMapDataset
from ..ops.integrate import TSDFIntegrator
from .streaming import batched, prefetch_views

__all__ = ["ReconstructionFilter"]

# Views fused per kernel launch.
BATCH = 32


class ReconstructionFilter:
    """Mirrors the VTK filter surface: Set* -> Update() -> outputs.

    vtk name -> here:
      SetRayPotentialRho/Thickness/Eta/Delta  -> set_ray_potential_*
      SetThresholdBestCost                    -> set_threshold_best_cost
      SetFilePathKRTD / SetFilePathVTI        -> set_file_path_krtd / _vti
      SetGridMatrix                           -> set_grid_matrix
      SetInputData(grid)                      -> set_input_grid
      Update()                                -> update()
      GetOutput() cell array                  -> get_output_volume()
      GetExecutionTime()                      -> get_execution_time()

    ``set_device`` chooses where the volume lives and the kernel runs:
    ``"cuda"`` (the default) or ``"cpu"`` (the kernel's plain version).
    """

    def __init__(self):
        self._rho = 0.0
        self._thick = 0.0
        self._eta = 0.0
        self._delta = 0.0
        self._threshold_best_cost = 0.0
        self._krtd_path: str | None = None
        self._vti_path: str | None = None
        self._grid_matrix = np.eye(4)
        self._grid: VoxelGrid | None = None
        self._device = "cuda"
        self._volume: np.ndarray | None = None
        self._execution_time = -1.0

    # -- setters (vtkCudaReconstructionFilter.h:56-86 parity) ---------------

    def set_ray_potential_rho(self, rho: float):
        self._rho = float(rho)
        return self

    def set_ray_potential_thickness(self, thick: float):
        self._thick = float(thick)
        return self

    def set_ray_potential_eta(self, eta: float):
        self._eta = float(eta)
        return self

    def set_ray_potential_delta(self, delta: float):
        self._delta = float(delta)
        return self

    def set_threshold_best_cost(self, threshold: float):
        self._threshold_best_cost = float(threshold)
        return self

    def set_file_path_krtd(self, path: str):
        self._krtd_path = path
        return self

    def set_file_path_vti(self, path: str):
        self._vti_path = path
        return self

    def set_grid_matrix(self, matrix: np.ndarray):
        self._grid_matrix = np.asarray(matrix, dtype=np.float64)
        return self

    def set_input_grid(
        self,
        dims: tuple[int, int, int],
        origin: tuple[float, float, float],
        spacing: tuple[float, float, float],
    ):
        self._grid = VoxelGrid(
            dims=dims, origin=origin, spacing=spacing, matrix=self._grid_matrix
        )
        return self

    def set_device(self, device: str):
        self._device = device
        return self

    # -- execution -----------------------------------------------------------

    def update(self) -> "ReconstructionFilter":
        """Run fusion (RequestData equivalent,
        ``vtkCudaReconstructionFilter.cxx:96-155``)."""
        if self._krtd_path is None or self._vti_path is None:
            # Reference: "Error, some inputs have not been set." (.cxx:115)
            raise ValueError("Error, some inputs have not been set.")
        if self._grid is None:
            raise ValueError("input grid has not been set")
        if self._rho == 0.0 and self._thick == 0.0:
            # Reference check at .cxx:137-142.
            raise ValueError(
                "Error : Ray potential Rho or Thickness or both have not been set"
            )
        # Unlike the CLI, the filter accepts an ARBITRARY 4x4 grid matrix and
        # performs no delta>=thick validation — mirroring the reference
        # filter's looser contract (.cxx:114-118,137-142 only check paths and
        # rho/thick).
        grid = VoxelGrid(
            dims=self._grid.dims,
            origin=self._grid.origin,
            spacing=self._grid.spacing,
            matrix=self._grid_matrix,
        )
        params = RayPotential(
            thick=self._thick, rho=self._rho, eta=self._eta, delta=self._delta
        )
        dataset = DepthMapDataset(self._vti_path, self._krtd_path)
        t0 = time.perf_counter()
        integrator = TSDFIntegrator(grid, params, device=self._device).reset()
        for batch in batched(prefetch_views(dataset), BATCH):
            integrator.integrate(batch, self._threshold_best_cost)
        integrator.synchronize()
        self._volume = integrator.result()
        self._execution_time = time.perf_counter() - t0
        return self

    # -- outputs -------------------------------------------------------------

    def get_output_volume(self) -> np.ndarray:
        """The fused (cz, cy, cx) cell scalars ('reconstruction_scalar')."""
        if self._volume is None:
            raise RuntimeError("call update() first")
        return self._volume

    def get_execution_time(self) -> float:
        """Fusion wall seconds (``GetExecutionTime``, .h:81), up to the
        fused volume on the host."""
        return self._execution_time
