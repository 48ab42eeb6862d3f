"""End-to-end reconstruction pipeline.

Equivalent of ``vtkCudaReconstructionFilter`` + the CLI pipeline in
``Reconstruction/main.cxx:106-212``:

  grid setup -> streamed TSDF fusion -> (always) .mha volume dump ->
  cell->point -> contour at `contour_value` -> grid-matrix transform ->
  .vtp mesh -> .vts structured grid -> optional summary file.

Views are fused in batches of ``stream_batch`` (one kernel launch each) into
a volume that stays on the configured device; cell->point and the marching
cubes run there too, and only the welded soup, the point volume (for the
.mha and the normals) and the cell volume (for the .vts) reach the host.
The execution-time bookkeeping mirrors ``GetExecutionTime``
(``vtkCudaReconstructionFilter.cxx:101-148``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from ..core.grid import VoxelGrid, are_vectors_orthogonal, grid_matrix_from_axes
from ..core.ray_potential import RayPotential
from ..core.view import DepthMapView
from ..io.dataset import DepthMapDataset
from ..io.mha import write_mha
from ..io.polydata import PolyData, write_vtp, write_vts
from ..ops.cell_to_point import cell_to_point
from ..ops.integrate import TSDFIntegrator
from ..ops.marching_cubes import extract_isosurface
from ..parallel.rig import grid_for_sharding, permute_volume, unpermute_volume
from ..parallel.sharded_integrate import ShardedTSDFIntegrator
from ..utils.log import RAY_POTENTIAL_ASCII, Log
from .runner import FaultTolerantRunner
from .streaming import prefetch_views

__all__ = ["ReconstructionConfig", "ReconstructionPipeline", "ReconstructionResult"]


@dataclasses.dataclass
class ReconstructionConfig:
    """All reconstruction parameters (CLI flags of ``Reconstruction/main.cxx:
    224-245`` keep their names and defaults in the CLI layer)."""

    grid_dims: tuple[int, int, int] | None = None
    grid_spacing: tuple[float, float, float] | None = None
    grid_origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    grid_end: tuple[float, float, float] | None = None
    grid_vec_x: tuple[float, float, float] = (1.0, 0.0, 0.0)
    grid_vec_y: tuple[float, float, float] = (0.0, 1.0, 0.0)
    grid_vec_z: tuple[float, float, float] = (0.0, 0.0, 1.0)
    ray_thick: float = 2.0
    ray_rho: float = 0.8
    ray_eta: float = 0.03
    ray_delta: float = 0.3
    threshold_best_cost: float = 0.14
    contour_value: float = 1.0
    force_cubic_voxel: bool = False
    dtype: str = "float32"
    device: str = "cuda"  # where the volume lives: 'cuda' or 'cpu'
    stream_batch: int = 32  # views per host->device transfer and launch
    write_mha_path: str | None = "meta_image_volume.mha"
    # Fault-tolerant mode: fuse as retried, checkpointed view-range units
    # (pipeline/runner.py); re-running with the same path RESUMES. The
    # reference has no equivalent (gpuAssert exits, CudaReconstruction.cu:
    # 68-76); unit size = stream_batch.
    checkpoint_path: str | None = None

    def make_grid(self) -> VoxelGrid:
        """Grid construction with the CLI's dims/spacing/gridEnd inference
        (``Reconstruction/main.cxx:309-340``) and orthogonality check
        (``main.cxx:363-382``)."""
        if not are_vectors_orthogonal(self.grid_vec_x, self.grid_vec_y, self.grid_vec_z):
            raise ValueError("Given vectors are not orthogonals.")
        matrix = grid_matrix_from_axes(self.grid_vec_x, self.grid_vec_y, self.grid_vec_z)
        if self.grid_dims is not None and self.grid_spacing is not None:
            # The reference CLI rejects setting both (main.cxx:249-254); the
            # filter API accepts explicit dims+spacing, so we allow it here.
            return VoxelGrid(
                dims=self.grid_dims,
                origin=self.grid_origin,
                spacing=self.grid_spacing,
                matrix=matrix,
            )
        if self.grid_end is None:
            raise ValueError(
                "gridEnd is required when only one of dims/spacing is given"
            )
        return VoxelGrid.from_bounds(
            origin=self.grid_origin,
            end=self.grid_end,
            dims=self.grid_dims,
            spacing=self.grid_spacing,
            matrix=matrix,
            force_cubic_voxel=self.force_cubic_voxel,
        )

    def ray_potential(self) -> RayPotential:
        return RayPotential(
            thick=self.ray_thick,
            rho=self.ray_rho,
            eta=self.ray_eta,
            delta=self.ray_delta,
        ).validate()


@dataclasses.dataclass
class ReconstructionResult:
    grid: VoxelGrid
    volume: np.ndarray  # (cz, cy, cx) fused cell scalars
    mesh: PolyData  # contoured + grid-matrix-transformed mesh
    execution_time: float  # fusion seconds (GetExecutionTime parity)
    total_time: float
    views_fused: int
    # Volume read+write sweeps made by the integrator: one per kernel launch
    # (per shard on a mesh).
    volume_sweeps: int = 0


class ReconstructionPipeline:
    def __init__(
        self,
        config: ReconstructionConfig,
        log: Log | None = None,
        mesh=None,
        shard_axis: str = "z",
    ):
        """`mesh`: optional ``parallel.DeviceMesh`` — fusion then runs
        z-slab-sharded across its devices (parallel/sharded_integrate), and
        the mesh's devices, not ``config.device``, hold the volume.

        `shard_axis`: 'z' (default) slices the grid's native z axis;
        'auto' relabels the grid so the slab sharding cuts the axis the
        cameras look along LEAST (parallel/rig.py). The relabeling permutes
        the volume exactly but regroups the kernel's table sum, so values
        may move by an ulp; the result is returned in the canonical layout
        either way. Requires a mesh. Composes with
        `checkpoint_path`: checkpoints always store canonical-layout
        volumes (the permutation is applied at the integrator boundary),
        so a run resumed with a different axis choice — or none — stays
        correct."""
        if shard_axis not in ("z", "auto"):
            raise ValueError(f"shard_axis must be 'z' or 'auto', got {shard_axis!r}")
        self.config = config
        self.log = log or Log(verbose=False)
        self.mesh = mesh
        self.shard_axis = shard_axis

    def _print_parameters(self, grid: VoxelGrid) -> None:
        """Verbose parameter dump (``ShowFilledParameters``, main.cxx:396-454)."""
        log, cfg = self.log, self.config
        if not log.verbose:
            return
        avg = sum(grid.spacing) / 3.0
        log.info("----------------------\n** OUTPUT GRID :\n----------------------")
        log.info(f"--- Dimensions : {grid.dims}")
        log.info(f"--- Spacing    : {grid.spacing}")
        log.info(f"--- Origin     : {grid.origin}")
        log.info(f"--- Nb voxels  : {grid.num_cells}")
        log.info("----------------------\n** DEPTH MAP :\n----------------------")
        log.info(f"--- Threshold for BestCost  : {cfg.threshold_best_cost}")
        log.info("----------------------\n** TSDF :\n----------------------")
        log.info(RAY_POTENTIAL_ASCII)
        log.info(
            f"--- Thickness ray potential : {cfg.ray_thick}"
            f" ( ~ {cfg.ray_thick / avg:.3g} voxels)"
        )
        log.info(f"--- Rho ray potential :       {cfg.ray_rho}")
        log.info(f"--- Eta ray potential :       {cfg.ray_eta}")
        log.info(
            f"--- Delta ray potential :     {cfg.ray_delta}"
            f" ( ~ {cfg.ray_delta / avg:.3g} voxels)"
        )
        log.info(f"--- Contour : {cfg.contour_value}\n")

    def fuse(
        self,
        views: Iterable[DepthMapView] | Sequence[DepthMapView],
        initial: np.ndarray | None = None,
    ):
        """Streamed fusion of all views; returns (integrator, seconds).

        The integrator is a ``TSDFIntegrator``, or a
        ``ShardedTSDFIntegrator`` when the pipeline has a mesh. The seconds
        end when the devices have finished the last batch."""
        cfg = self.config
        grid = cfg.make_grid()
        params = cfg.ray_potential()
        self._print_parameters(grid)
        perm = (0, 1, 2)  # identity unless shard_axis='auto' relabels below
        if self.mesh is not None:
            fuse_grid = grid
            if self.shard_axis == "auto":
                # Sequences/datasets are scored via lazy camera access
                # (rig_cameras); only a bare generator must materialize,
                # since it is consumed again by the fusion loop below.
                views = views if hasattr(views, "__getitem__") else list(views)
                fuse_grid, perm = grid_for_sharding(
                    grid, views, n_shards=self.mesh.shape["z"]
                )
            init = initial
            if perm != (0, 1, 2) and initial is not None:
                init = permute_volume(np.asarray(initial), perm)
            sharded = ShardedTSDFIntegrator(
                fuse_grid, params, self.mesh, dtype=cfg.dtype
            ).reset(init)
            if perm != (0, 1, 2):
                raw_result = sharded.result
                sharded.result = (  # type: ignore[method-assign]
                    lambda: np.ascontiguousarray(
                        unpermute_volume(raw_result(), perm)
                    )
                )
            integrator = sharded
        else:
            integrator = TSDFIntegrator(
                grid, params, dtype=cfg.dtype, device=cfg.device
            ).reset(initial)

        if cfg.checkpoint_path is not None:
            if initial is not None:
                raise ValueError(
                    "checkpoint_path and an explicit initial volume are "
                    "mutually exclusive (the checkpoint seeds the volume)"
                )
            def to_fuse_layout(vol):
                # Checkpoints (and the runner) live in the CANONICAL grid
                # layout; a shard_axis='auto' integrator fuses on the
                # relabeled grid, so seeds cross the boundary permuted
                # (result() is already wrapped to unpermute) — this is what
                # lets 'auto' compose with resume across axis choices.
                if vol is None or perm == (0, 1, 2):
                    return vol
                return permute_volume(np.asarray(vol), perm)

            sweeps = 0

            def integrate_fn(vol, batch):
                # Every unit round-trips the volume through the host: the
                # runner snapshots and checkpoints host volumes.
                nonlocal sweeps
                integrator.reset(to_fuse_layout(vol))
                integrator.integrate(batch, cfg.threshold_best_cost)
                sweeps += integrator.volume_sweeps
                return integrator.result()

            runner = FaultTolerantRunner(
                grid,
                params,
                integrate_fn,
                unit_size=cfg.stream_batch,
                checkpoint_path=cfg.checkpoint_path,
                log=self.log,
            )
            t0 = time.perf_counter()
            seq = views if hasattr(views, "__getitem__") else list(views)
            volume = runner.run(seq)
            integrator.reset(to_fuse_layout(volume))
            integrator.views_fused = len(seq)
            integrator.volume_sweeps = sweeps
            integrator.synchronize()
            return integrator, time.perf_counter() - t0

        t0 = time.perf_counter()
        batch: list[DepthMapView] = []
        n_total = len(views) if hasattr(views, "__len__") else None
        done = 0
        if isinstance(views, DepthMapDataset):
            # Overlap disk I/O + decode with device fusion (the reference
            # serializes them: CudaReconstruction.cu:343-365).
            views = prefetch_views(views, prefetch=2 * cfg.stream_batch)
        for view in views:
            batch.append(view)
            if len(batch) >= cfg.stream_batch:
                integrator.integrate(batch, cfg.threshold_best_cost)
                done += len(batch)
                if n_total:
                    self.log.progress(done, n_total)
                batch = []
        if batch:
            integrator.integrate(batch, cfg.threshold_best_cost)
        if n_total:
            self.log.progress(n_total, n_total)
            self.log.info("")
        integrator.synchronize()
        return integrator, time.perf_counter() - t0

    def run(
        self,
        views: Iterable[DepthMapView] | DepthMapDataset,
        output_mesh_path: str | None = None,
        output_grid_path: str | None = None,
        initial: np.ndarray | None = None,
    ) -> ReconstructionResult:
        cfg = self.config
        log = self.log
        t_start = time.perf_counter()
        log.info("---START---")

        grid = cfg.make_grid()
        with log.phase("Launch reconstruction"):
            integrator, exec_time = self.fuse(views, initial=initial)
        if self.mesh is None:
            volume_dev = integrator.volume
        else:
            # The sharded volume is gathered once, in the canonical layout,
            # onto the mesh's first device for the dense extraction.
            volume = integrator.result()
            volume_dev = torch.from_numpy(volume).to(self.mesh.devices[0, 0])

        # The reference ALWAYS writes the cell->point volume as a compressed
        # .mha in the cwd (main.cxx:157-161).
        if cfg.write_mha_path:
            with log.phase("Save meta-image volume"):
                pv = cell_to_point(volume_dev).cpu().numpy()
                write_mha(
                    cfg.write_mha_path,
                    pv.astype(np.float64),
                    origin=grid.origin,
                    spacing=grid.spacing,
                    compress=True,
                )

        with log.phase("Compute contour"):
            mesh = extract_isosurface(grid, volume_dev, cfg.contour_value)

        if output_mesh_path:
            with log.phase("Save mesh"):
                write_vtp(output_mesh_path, mesh)

        if self.mesh is None:
            volume = integrator.result()
        if output_grid_path:
            with log.phase("Save volume"):
                # Structured grid of all grid points, transformed by the grid
                # matrix (main.cxx:191-198), with the cell scalars attached.
                xs, ys, zs = grid.point_axes(np.float64)
                gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
                pts = np.stack([gx, gy, gz], -1).transpose(2, 1, 0, 3)
                m = grid.matrix
                pts = pts @ m[:3, :3].T + m[:3, 3]
                write_vts(
                    output_grid_path,
                    pts,
                    cell_arrays={
                        "reconstruction_scalar": volume.reshape(-1).astype(
                            np.float64
                        )
                    },
                )

        total = time.perf_counter() - t_start
        log.info(f"Reconstruction execution time : {exec_time} s")
        log.info("---END---")
        return ReconstructionResult(
            grid=grid,
            volume=volume,
            mesh=mesh,
            execution_time=exec_time,
            total_time=total,
            views_fused=integrator.views_fused,
            volume_sweeps=integrator.volume_sweeps,
        )

    def write_summary(
        self, path: str, result: ReconstructionResult, argv: list[str] | None = None
    ) -> None:
        """Summary report file (``WriteSummaryFile``, main.cxx:458-516)."""
        cfg = self.config
        g = result.grid
        lines = [
            "----------------------",
            "** COMMAND LINE :",
            "----------------------",
            " ".join(argv or []),
            "",
            "----------------------",
            "** OUTPUT GRID :",
            "----------------------",
            f"--- Dimensions : {g.dims}",
            f"--- Spacing    : {g.spacing}",
            f"--- Origin     : {g.origin}",
            f"--- Nb voxels  : {g.num_cells}",
            "----------------------",
            "** DEPTH MAP :",
            "----------------------",
            f"--- Threshold for BestCost  : {cfg.threshold_best_cost}",
            f"--- Views fused : {result.views_fused}",
            "----------------------",
            "** TSDF :",
            "----------------------",
            f"--- Thickness ray potential : {cfg.ray_thick}",
            f"--- Rho ray potential :       {cfg.ray_rho}",
            f"--- Eta ray potential :       {cfg.ray_eta}",
            f"--- Delta ray potential :     {cfg.ray_delta}",
            "----------------------",
            "** OTHER :",
            "----------------------",
            f"--- Contour : {cfg.contour_value}",
            "",
            "----------------------",
            "** TIME :",
            "----------------------",
            f"--- Reconstruction : {result.execution_time} s",
            f"--- Total :          {result.total_time} s",
            "",
        ]
        with open(path, "w") as f:
            f.write("\n".join(lines))
