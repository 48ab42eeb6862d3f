"""Sparse block-allocated TSDF fusion (incremental RGB-D sequences).

The port of ``cudadepthmapintegration_tpu/ops/sparse_grid.py``. The reference
holds the whole dense grid in GPU memory (``CudaReconstruction.cu:326``),
capping scene size. For incremental fusion (BASELINE.json config 5) the
world is an unbounded virtual grid of fixed-shape blocks (voxel block
hashing):

* only blocks that intersect the truncation band around observed surfaces
  are allocated; they live in one pool tensor ``(capacity, bz, by, bx)`` on
  ``device``, and the block-coord -> slot map lives on the host (numpy
  bookkeeping, identical to the JAX package's, so both allocate the same
  blocks into the same slots);
* per frame the host back-projects (subsampled) depth pixels, walks the
  ±delta band along each ray and allocates the touched blocks; the device
  then fuses the frame into the union of the touched blocks and every
  already-allocated block inside the frame's frustum (``carve=True``).
  Frustum re-integration matters: the dense kernel applies the ``-eta*rho``
  empty-space vote to every voxel in front of the surface
  (``CudaReconstruction.cu:114-115``), so an allocated block sitting in a
  later frame's free space must receive that vote too.

The per-frame device work is one call of
``kernels/sparse_cuda.sparse_fuse``: the CUDA kernel for a CUDA pool, the
plain PyTorch version for a CPU pool. Allocation follows sorted block order
(the JAX package's ``gather_backend="xla"`` order; its Morton order and
slot bucketing exist only for the TPU compiler).

Parity contract (tested): once a block is allocated, every SUBSEQUENT frame
contributes to it exactly as the dense grid would. Frames fused before a
block's allocation contribute nothing to it, so late-allocated blocks can
sit slightly above their dense value; pre-walking a known trajectory with
:meth:`preallocate` makes sparse == dense exactly.

Isosurface extraction is per block on the host (memory ∝ allocated
blocks): each block contours its own cells with a 1-cell halo from its
neighbours; cell->point averaging is masked to allocated cells, so the
fabricated 0.0 of unallocated space never enters a point value; vertices
are welded across blocks by canonical global edge keys.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import compose_projection
from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..core.view import DepthMapView
from ..io.polydata import PolyData
from ..kernels.sparse_cuda import sparse_fuse

__all__ = ["FrameBatch", "SparseTSDFGrid"]


class FrameBatch(NamedTuple):
    """One frame's device inputs to ``sparse_fuse``: the touched blocks'
    ``slots`` (B,) int32 and ``origins`` (B, 3), the projection rows (4, 4),
    the depth (h, w) float32 and the colour (h, w, 3) uint8 or None."""

    slots: torch.Tensor
    origins: torch.Tensor
    proj_rows: torch.Tensor
    depth: torch.Tensor
    rgb: torch.Tensor | None


class SparseTSDFGrid:
    """Unbounded sparse TSDF volume with device-pooled blocks."""

    def __init__(
        self,
        voxel_size: float,
        params: RayPotential,
        block_shape: tuple[int, int, int] = (8, 8, 8),
        capacity: int = 1 << 14,
        pixel_stride: int = 4,
        with_color: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.voxel_size = float(voxel_size)
        self.params = params
        self.block_shape = tuple(int(b) for b in block_shape)
        self.capacity = int(capacity)
        self.pixel_stride = int(pixel_stride)
        self.with_color = bool(with_color)
        self.device = torch.device(device)
        self.block_map: dict[tuple[int, int, int], int] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0
        shape = (self.capacity, *self.block_shape)
        self.pool = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.color_pool = None
        self.weight_pool = None
        if self.with_color:
            self.color_pool = torch.zeros((*shape, 3), dtype=torch.float32, device=self.device)
            self.weight_pool = torch.zeros(shape, dtype=torch.float32, device=self.device)
        # Voxel-centre offsets within a block along x, y, z: (3, max(block)).
        bz, by, bx = self.block_shape
        axes = np.zeros((3, max(self.block_shape)), np.float32)
        for a, n in enumerate((bx, by, bz)):
            axes[a, :n] = (np.arange(n) + 0.5) * self.voxel_size
        self.axes = torch.from_numpy(axes).to(self.device)
        self.frames_fused = 0

    @property
    def num_allocated(self) -> int:
        return len(self.block_map)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, extra: dict | None = None) -> None:
        """Atomic checkpoint of the full sparse state: config, block hash
        map, the USED prefix of the pools, frame counter, and a
        JSON-serializable ``extra`` dict for the caller (e.g. the driving
        CLI's frame cursor). The ``.npz`` layout (version 1) is the JAX
        package's, so a checkpoint resumes in either package. Written via
        tmp + ``os.replace`` so a crash mid-save leaves the previous
        checkpoint intact."""
        ns = self._next_slot
        coords = np.array(sorted(self.block_map), np.int64).reshape(-1, 3)
        slots = np.array([self.block_map[tuple(c)] for c in coords], np.int64)
        data = {
            "version": 1,
            "voxel_size": self.voxel_size,
            "params": np.array(
                [self.params.thick, self.params.rho, self.params.eta, self.params.delta],
                np.float64,
            ),
            "block_shape": np.array(self.block_shape, np.int64),
            "capacity": self.capacity,
            "pixel_stride": self.pixel_stride,
            "with_color": self.with_color,
            "coords": coords,
            "slots": slots,
            "free_slots": np.array(self._free_slots, np.int64),
            "next_slot": ns,
            "frames_fused": self.frames_fused,
            "pool": self.pool[:ns].cpu().numpy(),
            "extra_json": json.dumps(extra or {}),
        }
        if self.with_color:
            data["color_pool"] = self.color_pool[:ns].cpu().numpy()
            data["weight_pool"] = self.weight_pool[:ns].cpu().numpy()
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **data)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda"):
        """Restore a :meth:`save` checkpoint (of either package) onto
        ``device``. Returns ``(grid, extra)``."""
        with np.load(path, allow_pickle=False) as z:
            p = z["params"]
            grid = cls(
                voxel_size=float(z["voxel_size"]),
                params=RayPotential(
                    thick=float(p[0]), rho=float(p[1]), eta=float(p[2]), delta=float(p[3]),
                ),
                block_shape=tuple(int(b) for b in z["block_shape"]),
                capacity=int(z["capacity"]),
                pixel_stride=int(z["pixel_stride"]),
                with_color=bool(z["with_color"]),
                device=device,
            )
            ns = int(z["next_slot"])
            grid._next_slot = ns
            grid._free_slots = [int(s) for s in z["free_slots"]]
            grid.block_map = {
                tuple(int(x) for x in c): int(s) for c, s in zip(z["coords"], z["slots"])
            }
            grid.frames_fused = int(z["frames_fused"])
            if ns:
                pools = [(grid.pool, "pool")]
                if grid.with_color:
                    pools += [(grid.color_pool, "color_pool"), (grid.weight_pool, "weight_pool")]
                for dst, key in pools:
                    dst[:ns] = torch.from_numpy(z[key]).to(grid.device)
            extra = json.loads(str(z["extra_json"]))
        return grid, extra

    @property
    def _block_extent(self) -> np.ndarray:
        """Block world extent per axis, (x, y, z) order."""
        return np.array(
            [self.block_shape[2], self.block_shape[1], self.block_shape[0]], np.float64
        ) * self.voxel_size

    # -- allocation ----------------------------------------------------------

    def _touched_blocks(self, view: DepthMapView) -> set[tuple[int, int, int]]:
        """Back-project subsampled pixels; walk the ±delta band along each
        viewing ray; collect intersected block coords."""
        s = self.pixel_stride
        depth = view.depth[::s, ::s]
        hs, ws = depth.shape
        vs, us = np.meshgrid(np.arange(hs) * s, np.arange(ws) * s, indexing="ij")
        mask = depth > 0
        if not mask.any():
            return set()
        z = depth[mask]
        u = us[mask].astype(np.float64)
        v = vs[mask].astype(np.float64)
        k_inv = np.linalg.inv(view.camera.k)
        pix = np.stack([u, v, np.ones_like(u)], axis=1)
        rays = pix @ k_inv.T  # camera-frame directions with dir_z == 1
        rt = view.camera.rt
        r_inv = rt[:3, :3].T
        cam_origin = -r_inv @ rt[:3, 3]
        bs = self._block_extent
        delta = self.params.delta
        n_steps = max(2, int(np.ceil(2 * delta / min(bs))) + 2)
        touched: set[tuple[int, int, int]] = set()
        for step in np.linspace(-delta, delta, n_steps):
            zs = z + step
            cam_pts = rays * zs[:, None]
            world = cam_pts @ r_inv.T + cam_origin
            coords = np.floor(world / bs).astype(np.int64)
            touched.update(map(tuple, np.unique(coords, axis=0)))
        return touched

    def _allocated_in_frustum(self, view: DepthMapView) -> list[tuple[int, int, int]]:
        """Already-allocated blocks that may project into `view`'s image.

        Conservative 8-corner test: a block is kept when any corner is in
        front of the camera and the projected corner bbox overlaps the
        image (blocks straddling the camera plane are always kept — their
        projection is unbounded). Over-inclusion is harmless: the update
        computes a zero/invalid contribution per voxel."""
        if not self.block_map:
            return []
        coords = np.array(list(self.block_map.keys()), np.float64)  # (N, 3)
        bs = self._block_extent
        corner_off = np.array(list(itertools.product((0.0, 1.0), repeat=3)), np.float64)
        world = (coords[:, None, :] + corner_off[None, :, :]) * bs  # (N, 8, 3)
        p, _ = compose_projection(view.camera, None)
        hom = world @ p[:3, :3].T + p[:3, 3]  # (N, 8, 3)
        front = hom[..., 2] > 0
        any_front = front.any(axis=1)
        all_front = front.all(axis=1)
        z = np.where(front, hom[..., 2], 1.0)
        u = np.where(front, hom[..., 0] / z, 0.0)
        v = np.where(front, hom[..., 1] / z, 0.0)
        h, w = view.depth.shape
        big = 1e18
        u_lo = np.where(front, u, big).min(axis=1)
        u_hi = np.where(front, u, -big).max(axis=1)
        v_lo = np.where(front, v, big).min(axis=1)
        v_hi = np.where(front, v, -big).max(axis=1)
        overlaps = (u_hi >= -1) & (u_lo < w + 1) & (v_hi >= -1) & (v_lo < h + 1)
        keep = any_front & (overlaps | ~all_front)
        keys = list(self.block_map.keys())
        return [keys[i] for i in np.nonzero(keep)[0]]

    def _allocate(self, coords) -> np.ndarray:
        slots = []
        for c in coords:
            slot = self.block_map.get(c)
            if slot is None:
                if self._free_slots:
                    slot = self._free_slots.pop()
                elif self._next_slot < self.capacity:
                    slot = self._next_slot
                    self._next_slot += 1
                else:
                    raise RuntimeError(
                        f"sparse block pool exhausted (capacity {self.capacity})"
                    )
                self.block_map[c] = slot
            slots.append(slot)
        return np.asarray(slots, np.int32)

    def preallocate(self, views) -> int:
        """Allocate the truncation-band blocks of every view WITHOUT fusing.

        For a known trajectory this makes subsequent carved fusion EXACTLY
        equal to the dense path on allocated voxels (no late-allocation
        gap). Returns the number of allocated blocks."""
        for v in views:
            self._allocate(sorted(self._touched_blocks(v)))
        return self.num_allocated

    # -- eviction ------------------------------------------------------------

    def evict_blocks(self, coords) -> int:
        """Remove blocks; their pool slots are zeroed and recycled.

        A re-observed evicted block reallocates from zero (its history is
        gone) — the standard streaming trade-off; only evict blocks that
        are out of the working set or carry no surface (see
        :meth:`evict_deep_free_space`)."""
        slots = []
        for c in coords:
            slot = self.block_map.pop(tuple(c), None)
            if slot is not None:
                slots.append(slot)
                self._free_slots.append(slot)
        if slots:
            idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
            self.pool[idx] = 0.0
            if self.with_color:
                self.color_pool[idx] = 0.0
                self.weight_pool[idx] = 0.0
        return len(slots)

    def evict_far_from(self, center_xyz, radius: float, keep_at_most: int | None = None) -> int:
        """Spatial working-set eviction: evict blocks whose center lies
        farther than `radius` from `center_xyz` (e.g. the current camera
        position). With `keep_at_most`, additionally evict the farthest
        blocks until at most that many remain — the streaming block-budget
        policy for unbounded sequences. Returns evicted count."""
        if not self.block_map:
            return 0
        coords = np.array(list(self.block_map.keys()), np.float64)
        centers = (coords + 0.5) * self._block_extent
        dist = np.linalg.norm(centers - np.asarray(center_xyz, np.float64), axis=1)
        keys = list(self.block_map.keys())
        evict = [k for k, d in zip(keys, dist) if d > radius]
        if keep_at_most is not None:
            remaining = [(d, k) for k, d in zip(keys, dist) if d <= radius]
            excess = len(remaining) - int(keep_at_most)
            if excess > 0:
                remaining.sort()
                evict.extend(k for _, k in remaining[-excess:])
        return self.evict_blocks(evict)

    def evict_deep_free_space(self, threshold: float | None = None) -> int:
        """Evict blocks whose every voxel is at or below `threshold`
        (deeply carved free space: no sign crossing can touch them).

        Default threshold: two full empty-space votes (-2*eta*rho)."""
        if threshold is None:
            threshold = -2.0 * self.params.eta * self.params.rho
        if not self.block_map:
            return 0
        block_max = self.pool.amax(dim=(1, 2, 3)).cpu().numpy()
        coords = [c for c, slot in self.block_map.items() if block_max[slot] <= threshold]
        return self.evict_blocks(coords)

    # -- fusion --------------------------------------------------------------

    def frame_batch(self, view: DepthMapView, carve: bool = True) -> FrameBatch | None:
        """Allocate the blocks `view` touches (its truncation band and, with
        ``carve``, the allocated blocks in its frustum) and stage its inputs
        on the device, or return None when it touches nothing."""
        band = self._touched_blocks(view)
        if not band and not (carve and self.block_map):
            return None
        coords_set = set(band)
        if carve:
            coords_set.update(self._allocated_in_frustum(view))
        if not coords_set:
            return None
        coords = sorted(coords_set)
        slots = self._allocate(coords)
        origins = (np.array(coords, np.float64) * self._block_extent).astype(np.float32)
        p, cam_row = compose_projection(view.camera, None)
        proj_rows = np.vstack([p[:3, :], cam_row[None, :]]).astype(np.float32)
        rgb = None
        if self.with_color and view.color is not None:
            if view.color.dtype != np.uint8:
                raise ValueError(f"colour must be uint8, got {view.color.dtype}")
            rgb = torch.from_numpy(np.ascontiguousarray(view.color)).to(self.device)
        dev = self.device
        return FrameBatch(
            slots=torch.from_numpy(slots).to(dev),
            origins=torch.from_numpy(origins).to(dev),
            proj_rows=torch.from_numpy(proj_rows).to(dev),
            depth=torch.from_numpy(np.ascontiguousarray(view.depth, np.float32)).to(dev),
            rgb=rgb,
        )

    @property
    def color_band(self) -> float:
        """Colour band: the full truncation band, but at least ±1 voxel —
        with a narrower band the voxels flanking the zero-crossing (where
        mesh vertices sample from) would never receive colour, and
        grazing-angle views (along-ray distance >> Euclidean) would miss the
        surface entirely."""
        return float(max(self.params.delta, self.voxel_size))

    def fuse_batch(self, batch: FrameBatch) -> None:
        """Add one staged frame into the pools (one ``sparse_fuse`` call)."""
        colour = {}
        if batch.rgb is not None:
            colour = dict(color_pool=self.color_pool, weight_pool=self.weight_pool,
                          rgb=batch.rgb, band=self.color_band)
        sparse_fuse(self.pool, batch.slots, batch.origins, batch.proj_rows,
                    self.axes, batch.depth, self.params, **colour)

    def integrate_frame(
        self,
        view: DepthMapView,
        threshold_best_cost: float | None = None,
        carve: bool = True,
    ):
        """Fuse one RGB-D frame; allocates band blocks on the fly.

        carve=True (default, dense-parity behavior) also re-integrates every
        already-allocated block inside this frame's frustum, so blocks in
        the frame's free space receive the ``-eta*rho`` carve vote exactly
        like the dense kernel (``CudaReconstruction.cu:114-115``).
        carve=False restores band-only updates (cheaper; documented
        divergence from dense values in multi-viewpoint sequences)."""
        if threshold_best_cost is not None:
            view = view.thresholded(threshold_best_cost)
        batch = self.frame_batch(view, carve)
        if batch is None:
            return self
        self.fuse_batch(batch)
        self.frames_fused += 1
        return self

    # -- extraction ----------------------------------------------------------

    def allocated_bounds(self):
        """((xmin, ymin, zmin), (xmax, ymax, zmax)) in block coords, or None."""
        if not self.block_map:
            return None
        arr = np.array(list(self.block_map.keys()))  # (N, 3) as (x, y, z)
        return arr.min(axis=0), arr.max(axis=0)

    def _bbox_grid(self) -> VoxelGrid:
        """VoxelGrid of the allocated bounding box (the global key/coordinate
        domain for meshing and `to_dense`)."""
        lo, hi = self.allocated_bounds()
        nbx, nby, nbz = (hi - lo) + 1
        bz, by, bx = self.block_shape
        origin = (
            lo[0] * bx * self.voxel_size,
            lo[1] * by * self.voxel_size,
            lo[2] * bz * self.voxel_size,
        )
        return VoxelGrid(
            dims=(nbx * bx + 1, nby * by + 1, nbz * bz + 1),
            origin=origin,
            spacing=(self.voxel_size,) * 3,
        )

    def to_dense(self) -> tuple[np.ndarray, VoxelGrid]:
        """Materialize allocated blocks into a dense (cz, cy, cx) volume +
        its VoxelGrid (for parity tests / interop on SMALL scenes — memory
        is the bounding box; meshing does NOT use this, see extract_mesh).
        Unallocated space is 0."""
        bounds = self.allocated_bounds()
        if bounds is None:
            raise ValueError("no blocks allocated")
        lo, _ = bounds
        grid = self._bbox_grid()
        bz, by, bx = self.block_shape
        dense = np.zeros(grid.volume_shape, np.float32)
        pool = self.pool.cpu().numpy()
        for (cx_, cy_, cz_), slot in self.block_map.items():
            iz = (cz_ - lo[2]) * bz
            iy = (cy_ - lo[1]) * by
            ix = (cx_ - lo[0]) * bx
            dense[iz : iz + bz, iy : iy + by, ix : ix + bx] = pool[slot]
        return dense, grid

    def extract_mesh(self, iso: float = 0.0, compute_normals: bool = True) -> PolyData:
        """Per-block marching cubes on the host: memory ∝ allocated blocks.

        Per block: its own cells + a 1-cell halo gathered from allocated
        neighbors; cell->point conversion averages ONLY allocated cells
        (matching ``vtkCellDataToPointData``'s existing-cells semantics at
        the data boundary, and preventing fabricated-zero crossing sheets
        at the allocation edge); triangles are emitted per owning cell
        exactly once; vertices weld across blocks by canonical global edge
        keys. Where a cell's full 27-neighborhood is allocated the point
        math is bit-identical to `to_dense()` + dense extraction (fp32
        averaging in the same add order)."""
        from .marching_cubes import _weld_triangle_soup, marching_cubes

        if not self.block_map:
            raise ValueError("no blocks allocated")
        lo, _ = self.allocated_bounds()
        grid = self._bbox_grid()
        nx, ny, nz = grid.point_shape[2], grid.point_shape[1], grid.point_shape[0]
        xs, ys, zs = grid.point_axes(np.float32)
        bz, by, bx = self.block_shape
        pool = self.pool.cpu().numpy()

        # (bz+2, by+2, bx+2) halo source slices per neighbor offset.
        def _slices(d, n):
            if d < 0:
                return slice(n - 1, n), slice(0, 1)
            if d == 0:
                return slice(0, n), slice(1, n + 1)
            return slice(0, 1), slice(n + 1, n + 2)

        all_verts, all_keys = [], []
        npts_loc = (bx + 1) * (by + 1) * (bz + 1)
        for (cx_, cy_, cz_), slot in sorted(self.block_map.items()):
            cells = np.zeros((bz + 2, by + 2, bx + 2), np.float32)
            present = np.zeros((bz + 2, by + 2, bx + 2), bool)
            for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
                ns = self.block_map.get((cx_ + dx, cy_ + dy, cz_ + dz))
                if ns is None:
                    continue
                sz, tz_ = _slices(dz, bz)
                sy, ty_ = _slices(dy, by)
                sx, tx_ = _slices(dx, bx)
                cells[tz_, ty_, tx_] = pool[ns][sz, sy, sx]
                present[tz_, ty_, tx_] = True

            # Masked cell->point averaging, fp32 adds in cell_to_point's
            # (dz, dy, dx) order so fully-allocated neighborhoods match the
            # dense path bit-for-bit.
            tot = np.zeros((bz + 1, by + 1, bx + 1), np.float32)
            cnt = np.zeros((bz + 1, by + 1, bx + 1), np.float32)
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        tot = tot + cells[dz : dz + bz + 1, dy : dy + by + 1, dx : dx + bx + 1]
                        cnt = cnt + present[
                            dz : dz + bz + 1, dy : dy + by + 1, dx : dx + bx + 1
                        ].astype(np.float32)
            pts = tot / np.maximum(cnt, 1.0)

            iz0 = (cz_ - lo[2]) * bz
            iy0 = (cy_ - lo[1]) * by
            ix0 = (cx_ - lo[0]) * bx
            verts, keys = marching_cubes(
                torch.from_numpy(pts), iso,
                xs[ix0 : ix0 + bx + 1], ys[iy0 : iy0 + by + 1], zs[iz0 : iz0 + bz + 1],
                return_soup=True,
            )
            if len(keys) == 0:
                continue
            # Local edge keys -> global bbox-domain keys (same decomposition
            # as the JAX package's parallel/sharded_mesh.py slab weld).
            axis = keys // npts_loc
            flat = keys % npts_loc
            kk = flat // ((bx + 1) * (by + 1)) + iz0
            rem = flat % ((bx + 1) * (by + 1))
            jj = rem // (bx + 1) + iy0
            ii = rem % (bx + 1) + ix0
            all_verts.append(verts)
            all_keys.append(axis * (nx * ny * nz) + (kk * ny + jj) * nx + ii)

        if not all_verts:
            empty = PolyData(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
            if compute_normals:  # attribute-set parity with non-empty
                empty.point_data["Normals"] = np.zeros((0, 3), np.float32)
            return empty
        mesh = _weld_triangle_soup(
            np.concatenate(all_verts), np.concatenate(all_keys), grid.matrix
        )
        if compute_normals:
            # Area-weighted winding normals (see ops/normals.py for why the
            # sparse path does not use gradient normals).
            from .normals import geometric_vertex_normals

            mesh.point_data["Normals"] = geometric_vertex_normals(mesh.points, mesh.triangles)
        return mesh

    # -- online color --------------------------------------------------------

    def vertex_colors(self, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-point mean ONLINE color from the block color pool.

        Each point samples the nearest voxel center (mesh vertices lie on
        cell edges, so the nearest center is one of the edge's endpoint
        voxels — both inside the truncation band where color accumulates);
        if that voxel's block is unallocated or unobserved, its 6-neighbor
        voxels are tried (crossing block boundaries). Requires
        ``with_color=True``. Returns (mean_uint8 (N, 3), weight_f32 (N,))
        where weight is the accumulated proximity-falloff mass, with
        (0,0,0)/0 for never-observed points — the zero-hit convention of
        ``MeshColoration.cxx:113-133``."""
        if not self.with_color:
            raise ValueError("grid was built with with_color=False")
        pts = np.asarray(points, np.float64)
        n = len(pts)
        mean = np.zeros((n, 3), np.float64)
        count = np.zeros((n,), np.float32)
        if n == 0 or not self.block_map:
            return mean.astype(np.uint8), count
        color = self.color_pool.cpu().numpy()
        weight = self.weight_pool.cpu().numpy()
        bz, by, bx = self.block_shape
        bdims = np.array([bx, by, bz], np.int64)
        vox = np.floor(pts / self.voxel_size).astype(np.int64)  # (N, 3) xyz
        offs = np.array(
            [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
            np.int64,
        )
        done = np.zeros(n, bool)
        for off in offs:
            todo = ~done
            if not todo.any():
                break
            v = vox[todo] + off
            bc = np.floor_divide(v, bdims)
            lc = v - bc * bdims  # (M, 3) within-block xyz
            slots = np.fromiter(
                (self.block_map.get(tuple(c), -1) for c in bc), np.int64, count=len(bc)
            )
            ok = slots >= 0
            if not ok.any():
                continue
            s = slots[ok]
            lz, ly, lx = lc[ok, 2], lc[ok, 1], lc[ok, 0]
            wgt = weight[s, lz, ly, lx]
            hit = wgt > 0
            idx = np.nonzero(todo)[0][ok][hit]
            mean[idx] = color[s[hit], lz[hit], ly[hit], lx[hit]] / wgt[hit][:, None]
            count[idx] = wgt[hit]
            done[idx] = True
        return np.clip(mean, 0, 255).astype(np.uint8), count

    def extract_colored_mesh(self, iso: float = 0.0) -> PolyData:
        """:meth:`extract_mesh` + online vertex colors attached as
        ``MeanColoration`` / ``ColorWeight`` point arrays (ColorWeight is
        the accumulated proximity-falloff mass, not an integer count)."""
        mesh = self.extract_mesh(iso=iso)
        mean, wgt = self.vertex_colors(mesh.points)
        mesh.point_data["MeanColoration"] = mean
        mesh.point_data["ColorWeight"] = wgt.astype(np.float32)
        return mesh
