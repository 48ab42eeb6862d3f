"""Multi-device TSDF fusion over a :class:`~.mesh.DeviceMesh`.

Two complementary strategies (composable on a (z, v) mesh):

* **Spatial (z-slab) sharding** — the volume is a list of z-slabs, shard
  ``s`` on ``mesh.devices[s, 0]``, and every shard integrates all views
  against its own slab with its own rows of the z-dependent projection
  table. A voxel's update depends only on that voxel, so fusion needs no
  communication; the reference's view-outer loop
  (``CudaReconstruction.cu:343-365``) is inverted per slab.
* **View sharding** — views are split along ``v``; each device fuses its
  view subset into a zero partial of its z-slab, and the partials are
  summed in ``v`` order onto the slab (fusion is an associative sum over
  views, ``CudaReconstruction.cu:211``).

Every launch is the integrate kernel of ``csrc/integrate.cu`` on a CUDA
slab (its plain PyTorch version on a CPU slab), through
``kernels.integrate_cuda.integrate_views``. Each voxel receives the views
in the order given, so the z-slab, frustum-culled and interleaved paths
equal the single-device ``ops.integrate.TSDFIntegrator`` bit for bit:
they change which launches happen, never a voxel's add order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..core.view import DepthMapView
from ..kernels.integrate_cuda import integrate_views
from ..ops.integrate import projection_tables
from ..utils.dtype import numpy_dtype, torch_dtype
from .frustum import slab_view_mask
from .mesh import DeviceMesh

__all__ = ["ShardedTSDFIntegrator"]

# The JAX package's sharded Pallas modes. Every one launches the same CUDA
# kernel here; the JAX kernel variants differ only in how they stage the
# depth maps on a TPU, never in a value.
PALLAS_MODES = ("rowsel", "rowsel3", "rowselh", "rowsel3h", "windows")


class ShardedTSDFIntegrator:
    """Fusion over a (z, v) mesh.

    The volume lives as per-shard slabs on the mesh's devices between
    calls; only :meth:`result` gathers it to the host.
    """

    def __init__(
        self,
        grid: VoxelGrid,
        params: RayPotential,
        mesh: DeviceMesh,
        dtype=torch.float32,
        slab_interleave: bool = False,
    ):
        """``slab_interleave=True`` assigns z slices to shards round-robin
        (shard d owns original slices d, d+nz, d+2*nz, ...) instead of one
        contiguous slab each. For rigs whose coverage concentrates on few
        contiguous slabs this balances per-shard work at the cost of making
        per-shard frustum culling useless (each shard's slices span the
        whole grid). Implemented as an EXACT z-permutation: the slabs hold
        the permuted volume, tz tables are permuted at staging, and
        :meth:`result` unpermutes."""
        self.grid = grid
        self.params = params.validate()
        self.mesh = mesh
        self.dtype = torch_dtype(dtype)
        nz = mesh.shape["z"]
        cz = grid.volume_shape[0]
        if cz % nz:
            raise ValueError(
                f"grid z cells ({cz}) must divide over the z mesh axis ({nz});"
                " pad the grid dims"
            )
        self.slab_interleave = bool(slab_interleave)
        # Round-robin layout: new slice d*m + j holds original slice
        # j*nz + d, so shard d's contiguous block is original slices d::nz.
        m = cz // nz
        order = np.arange(cz).reshape(m, nz).T.reshape(-1)  # new <- old
        self._z_order = order if self.slab_interleave else None
        self._z_inv = np.argsort(order) if self.slab_interleave else None
        self.slabs: list[torch.Tensor] | None = None
        self.views_fused = 0
        # Per-shard volume read+write sweeps: one per launch on a slab.
        self.volume_sweeps = 0

    @property
    def slab_cells(self) -> int:
        """z cells per shard."""
        return self.grid.volume_shape[0] // self.mesh.shape["z"]

    def slab_device(self, s: int) -> torch.device:
        return self.mesh.devices[s, 0]

    def reset(self, initial: np.ndarray | None = None) -> "ShardedTSDFIntegrator":
        """Start from zeros, or from a (cz, cy, cx) ``initial`` (copied)."""
        cz, cy, cx = self.grid.volume_shape
        m, nz = self.slab_cells, self.mesh.shape["z"]
        if initial is None:
            self.slabs = [
                torch.zeros((m, cy, cx), dtype=self.dtype, device=self.slab_device(s))
                for s in range(nz)
            ]
        else:
            init = np.asarray(initial)
            if init.shape != (cz, cy, cx):
                raise ValueError(
                    f"initial volume has shape {init.shape}, expected {(cz, cy, cx)}"
                )
            if self._z_order is not None:
                init = init[self._z_order]
            self.slabs = [
                torch.from_numpy(np.ascontiguousarray(init[s * m : (s + 1) * m]))
                .to(self.slab_device(s), self.dtype, copy=True)
                for s in range(nz)
            ]
        self.views_fused = 0
        self.volume_sweeps = 0
        return self

    def _tables(self, views: list[DepthMapView]):
        """Host tables and maps in the compute dtype; tz in slab layout."""
        np_dtype = numpy_dtype(self.dtype)
        t = projection_tables(self.grid, views, np_dtype)
        tz = t.tz if self._z_order is None else t.tz[:, :, self._z_order]
        depths = np.stack([v.depth for v in views]).astype(np_dtype)
        return t, tz, depths

    def integrate(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
    ) -> "ShardedTSDFIntegrator":
        """Fuse a batch of views, spatially sharded (no communication): each
        slab gets every view and its own contiguous ``tz[:, :, z0:z1]``, one
        launch of the CUDA integrate kernel per slab."""
        return self.integrate_pallas(views, threshold_best_cost)

    def integrate_view_parallel(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
    ) -> "ShardedTSDFIntegrator":
        """Fuse with views split over the ``v`` mesh axis.

        Device ``(s, j)`` fuses the j-th contiguous share of the views into a
        zero partial of slab ``s`` (one CUDA kernel launch); the partials are
        summed in ``v`` order on the slab's device and added to the slab.
        The sum regroups each voxel's float additions, so the result matches
        :meth:`integrate` to rounding, not bit for bit. Requires len(views)
        divisible by the v-axis size (pad with dummy views whose depth is the
        -1 sentinel if needed).
        """
        if self.slabs is None:
            self.reset()
        if threshold_best_cost is not None:
            views = [v.thresholded(threshold_best_cost) for v in views]
        nv = self.mesh.shape["v"]
        if len(views) % nv:
            raise ValueError(f"need a multiple of {nv} views, got {len(views)}")
        t, tz, depths = self._tables(views)
        m, per = self.slab_cells, len(views) // nv
        for s, slab in enumerate(self.slabs):
            total = None
            for j in range(nv):
                dev = self.mesh.devices[s, j]
                sel = slice(j * per, (j + 1) * per)
                args = [
                    torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (t.tx[sel], t.ty[sel], tz[sel, :, s * m : (s + 1) * m],
                              t.tc[sel], depths[sel])
                ]
                part = torch.zeros(slab.shape, dtype=self.dtype, device=dev)
                integrate_views(part, *args, self.params)
                part = part.to(slab.device)
                total = part if total is None else total + part
            slab += total
        self.views_fused += len(views)
        self.volume_sweeps += 1
        return self

    def integrate_pallas(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
        **stage_kw,
    ) -> "ShardedTSDFIntegrator":
        """Spatially-sharded fusion with the CUDA integrate kernel per
        z-slab: :meth:`stage_pallas_views` + :meth:`run_staged_pallas`.
        The name is the JAX package's, whose per-shard kernel is Pallas."""
        if not views:
            return self
        staged = self.stage_pallas_views(views, threshold_best_cost, **stage_kw)
        self.run_staged_pallas(staged)
        self.views_fused += len(views)
        self.volume_sweeps += 1
        return self

    def stage_pallas_views(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
        mode: str = "rowsel",
        frustum_cull: bool = False,
    ) -> list[tuple[torch.Tensor, ...] | None]:
        """Stage one view batch for the per-slab CUDA integrate kernel:
        per shard, the kernel's ``(tx, ty, tz, tc, depths)`` on the shard's
        device, or ``None`` when frustum culling left the shard no view.

        Tables and maps are built on the host once and uploaded once per
        distinct device of the z axis (four shards on one card share one
        upload); each shard gets its own contiguous rows of the z table.
        ``mode`` takes the five names the JAX package's sharded path accepts;
        each launches the same CUDA kernel. ``frustum_cull=True`` gives each
        shard only the views whose frustum can reach its slab
        (:func:`.frustum.slab_view_mask`); a culled view would add exactly
        ``+0.0`` to every voxel of the slab, so culling changes no value.
        """
        if self.slabs is None:
            self.reset()
        if mode not in PALLAS_MODES:
            raise ValueError(
                f"sharded integrate supports mode 'rowsel', 'rowsel3', "
                f"'rowselh', 'rowsel3h' or 'windows', got {mode!r}"
            )
        if threshold_best_cost is not None:
            views = [v.thresholded(threshold_best_cost) for v in views]
        h, w = views[0].depth.shape
        nz, m = self.mesh.shape["z"], self.slab_cells
        cull_mask = None
        if frustum_cull:
            if self._z_order is not None:
                raise ValueError(
                    "frustum_cull does not compose with slab_interleave "
                    "(interleaved shards span the whole grid)"
                )
            # Cameras only — conservative; thresholding doesn't move them.
            cull_mask = slab_view_mask(self.grid, views, nz, int(h), int(w))
        t, tz, depths = self._tables(views)
        shared: dict[torch.device, tuple[torch.Tensor, ...]] = {}
        shards: list[tuple[torch.Tensor, ...] | None] = []
        for s in range(nz):
            dev = self.slab_device(s)
            if dev not in shared:
                shared[dev] = tuple(
                    torch.from_numpy(a).to(dev) for a in (t.tx, t.ty, t.tc, depths)
                )
            tx, ty, tc, d = shared[dev]
            tz_s = torch.from_numpy(
                np.ascontiguousarray(tz[:, :, s * m : (s + 1) * m])
            ).to(dev)
            if cull_mask is not None and not cull_mask[s].all():
                if not cull_mask[s].any():
                    shards.append(None)
                    continue
                idx = torch.from_numpy(np.flatnonzero(cull_mask[s])).to(dev)
                tx, ty, tz_s, tc, d = (
                    a.index_select(0, idx) for a in (tx, ty, tz_s, tc, d)
                )
            shards.append((tx, ty, tz_s, tc, d))
        return shards

    def run_staged_pallas(self, staged) -> "ShardedTSDFIntegrator":
        """Launch the CUDA integrate kernel on every slab with a staged
        batch (from :meth:`stage_pallas_views`), adding into the current
        slabs: the device-resident steady state (benchmarking; or re-fusing
        the same batch into several volumes)."""
        if self.slabs is None:
            self.reset()
        for slab, args in zip(self.slabs, staged):
            if args is not None:
                integrate_views(slab, *args, self.params)
        return self

    def synchronize(self) -> "ShardedTSDFIntegrator":
        """Wait until every device has finished its launches."""
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    def result(self) -> np.ndarray:
        """Gather the fused (cz, cy, cx) volume to the host."""
        if self.slabs is None:
            self.reset()
        vol = torch.cat([s.to("cpu") for s in self.slabs]).numpy()
        if self._z_inv is not None:
            vol = vol[self._z_inv]
        return vol
