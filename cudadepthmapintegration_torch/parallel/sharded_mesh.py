"""Distributed isosurface extraction over z-sharded volumes.

The single-device path (``ops/marching_cubes.extract_isosurface``) needs the
whole volume on one device. Here each z-slab is converted to point scalars
with a halo exchange (:func:`.halo.sharded_cell_to_point`), walked with the
port's marching cubes on its own device using GLOBAL cell offsets, and the
per-slab triangle soups are welded by the same canonical global edge keys
the single-device path uses — so the result is identical to meshing the
gathered volume, without ever materializing it on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import VoxelGrid
from ..io.polydata import PolyData
from ..ops.marching_cubes import _weld_triangle_soup, marching_cubes
from ..ops.normals import normals_for_edge_keys, transform_normals
from ..utils.dtype import numpy_dtype
from .halo import sharded_cell_to_point
from .mesh import DeviceMesh

__all__ = ["sharded_extract_isosurface"]


def _gather_rows(blocks, lo: int, hi: int, device) -> torch.Tensor:
    """Global point planes ``[lo, hi)`` from consecutive z-blocks, on
    ``device``."""
    parts, start = [], 0
    for b in blocks:
        a, c = max(lo, start), min(hi, start + b.shape[0])
        if a < c:
            parts.append(b[a - start : c - start].to(device))
        start += b.shape[0]
    return torch.cat(parts)


def sharded_extract_isosurface(
    slabs: list[torch.Tensor],
    grid: VoxelGrid,
    iso: float,
    mesh: DeviceMesh,
    compute_normals: bool = True,
) -> PolyData:
    """Contour a z-sharded fused volume (contiguous slabs, e.g.
    ``ShardedTSDFIntegrator.slabs``) into one welded mesh, equal to
    ``extract_isosurface(grid, volume, iso)`` of the gathered volume.

    Each slab's marching cubes runs on its shard's device. With
    ``compute_normals`` (default, matching the single-device path) each
    slab is pulled with a ONE-PLANE z margin so the central differences at
    slab-boundary nodes see the same neighbour values as the dense path.
    Boundary edges are computed by both adjacent slabs from identical
    values, and the weld keeps the later slab's copy, as the dense soup's
    cell order does."""
    blocks = sharded_cell_to_point(slabs)
    dtype = numpy_dtype(slabs[0].dtype)
    xs, ys, zs = grid.point_axes(dtype)
    nz, ny, nx = grid.point_shape
    bz = slabs[0].shape[0]

    all_verts, all_keys, all_normals = [], [], []
    for s in range(mesh.shape["z"]):
        device = slabs[s].device
        k0 = s * bz
        # Point planes [k0, k0+bz] — cells [k0, k0+bz); each cell belongs
        # to exactly one slab (no duplicate triangles), while the shared
        # boundary plane gives identical edge keys for exact welding.
        k0m = max(k0 - 1, 0)  # margined pull for gradient normals
        k1m = min(k0 + bz + 1, nz - 1)
        slab_m = _gather_rows(blocks, k0m, k1m + 1, device)
        slab = slab_m[k0 - k0m : k0 - k0m + bz + 1]
        verts, keys = marching_cubes(
            slab, iso, xs, ys, zs[k0 : k0 + bz + 1], return_soup=True
        )
        if len(keys) == 0:
            continue
        # Translate slab-local keys to global: key = axis*(nx*ny*NZ) + flat
        # with flat = (k_local*ny + j)*nx + i.
        nz_slab = bz + 1
        axis = keys // (nx * ny * nz_slab)
        flat = keys % (nx * ny * nz_slab)
        kk = flat // (nx * ny) + k0
        rem = flat % (nx * ny)
        gkeys = axis * (nx * ny * nz) + (kk * ny + rem // nx) * nx + rem % nx
        all_verts.append(verts)
        all_keys.append(gkeys)
        if compute_normals:
            nzm = slab_m.shape[0]
            mkeys = (
                axis * (nx * ny * nzm)
                + ((kk - k0m) * ny + rem // nx) * nx
                + rem % nx
            )
            all_normals.append(
                normals_for_edge_keys(
                    slab_m.cpu().numpy(), xs, ys, zs[k0m : k1m + 1], mkeys, iso
                )
            )

    if not all_verts:
        out = PolyData(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        if compute_normals:  # attribute-set parity with non-empty results
            out.point_data["Normals"] = np.zeros((0, 3), np.float32)
    else:
        soup_keys = np.concatenate(all_keys)
        out, uniq = _weld_triangle_soup(
            np.concatenate(all_verts), soup_keys, grid.matrix, return_keys=True
        )
        if compute_normals:
            welded = np.zeros((uniq.shape[0], 3), np.float32)
            welded[np.searchsorted(uniq, soup_keys)] = np.concatenate(all_normals)
            out.point_data["Normals"] = transform_normals(welded, grid.matrix)
    # The contoured scalars, as extract_isosurface attaches them.
    out.point_data["reconstruction_scalar"] = np.full(out.num_points, iso, np.float64)
    out.active_scalars = "reconstruction_scalar"
    return out
