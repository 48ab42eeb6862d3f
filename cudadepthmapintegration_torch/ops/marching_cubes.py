"""Marching-cubes isosurface extraction (PyTorch, two-phase compaction).

Replaces the VTK pipeline ``vtkCellDataToPointData`` -> ``vtkContourFilter``
-> ``vtkTransformFilter`` (``Reconstruction/main.cxx:150-189``); the port of
``marching_cubes`` in the JAX package, whose ``backend="jax"`` is this
module's ``backend="device"``:

* **Phase 1 (dense, on the volume's device):** the 8-bit cube configuration
  of every cell of the point-scalar volume, from elementwise compares and
  shifts.
* **Compaction:** active cells (config not 0/255) are found with
  ``torch.nonzero`` on the device, in C order.
* **Phase 2 (compact, on the device):** for each active cell, up to 5
  triangles with vertices interpolated along cube edges, in chunks of
  :data:`CELL_CHUNK` cells; each vertex carries the *global canonical edge
  id* of the edge it lies on.
* **Weld:** the compacted soup is welded by exact integer edge key,
  matching vtkContourFilter's merged points: on the host
  (:func:`_weld_triangle_soup`, the default) or on the device
  (:func:`weld_soup_device`, ``weld_backend="device"``), bit for bit alike.

``backend="native"`` walks the volume on the host in float64 instead, with
the native library's table walker (``native.py``), and welds on the host.

The isovalue convention matches VTK: vertices interpolate where the scalar
crosses ``iso``; cells entirely >= or < iso produce nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import VoxelGrid
from ..io.polydata import PolyData
from ..utils.dtype import numpy_dtype
from .cell_to_point import cell_to_point
from .mc_tables import CORNER_OFFSETS, EDGE_CANONICAL, EDGE_CORNERS, TRI_TABLE

__all__ = ["marching_cubes", "extract_isosurface"]

# Active cells per _active_cell_triangles call: bounds the (A, 15, 3)
# temporaries; module-level so tests can force multi-chunk runs.
CELL_CHUNK = 1 << 18


def _cube_config(points: torch.Tensor, iso: torch.Tensor) -> torch.Tensor:
    """(nz, ny, nx) point scalars -> (nz-1, ny-1, nx-1) uint8 configs.

    Bit i set when corner value < iso (Bourke convention)."""
    below = (points < iso).to(torch.uint8)
    nz, ny, nx = (s - 1 for s in points.shape)
    cfg = torch.zeros((nz, ny, nx), dtype=torch.uint8, device=points.device)
    for bit, (dx, dy, dz) in enumerate(CORNER_OFFSETS.tolist()):
        cfg |= below[dz : dz + nz, dy : dy + ny, dx : dx + nx] << bit
    return cfg


def _active_cell_triangles(points_flat, iso, cell_idx, cfg, xs, ys, zs, dims):
    """Emit the triangle-slot vertices of a chunk of active cells.

    ``cell_idx`` (A, 3) holds (k, j, i), ``cfg`` (A,) their configurations.
    Returns verts (A, 15, 3) in the grid frame, keys (A, 15) int64 canonical
    global edge ids (-1 at unused slots) and valid (A, 15) slot flags."""
    nx, ny, nz = dims
    dev = points_flat.device
    tri_table = torch.as_tensor(TRI_TABLE, device=dev).long()  # (256, 16)
    edge_corners = torch.as_tensor(EDGE_CORNERS, device=dev).long()  # (12, 2)
    corner_off = torch.as_tensor(CORNER_OFFSETS, device=dev).long()  # (8, 3)
    edge_canon = torch.as_tensor(EDGE_CANONICAL, device=dev).long()  # (12, 4)

    k, j, i = cell_idx[:, 0], cell_idx[:, 1], cell_idx[:, 2]
    # Corner point values of each active cell: (A, 8).
    corner_vals = torch.stack(
        [
            points_flat[((k + dz) * ny + (j + dy)) * nx + (i + dx)]
            for dx, dy, dz in CORNER_OFFSETS.tolist()
        ],
        dim=1,
    )
    # Up to 15 vertex slots; slot s uses edge id tri_table[cfg, s].
    edges = tri_table[cfg][:, :15]  # (A, 15)
    valid = edges >= 0
    e = torch.where(valid, edges, 0)

    ca = edge_corners[:, 0][e]  # (A, 15) corner index a
    cb = edge_corners[:, 1][e]
    va = torch.gather(corner_vals, 1, ca)
    vb = torch.gather(corner_vals, 1, cb)
    denom = vb - va
    one = torch.ones((), dtype=denom.dtype, device=dev)
    t = torch.where(
        denom != 0, (iso - va) / torch.where(denom == 0, one, denom), 0.5
    )
    t = torch.clamp(t, 0.0, 1.0)

    ijk = torch.stack([i, j, k], dim=1)[:, None, :]  # (A, 1, 3)
    ia = ijk + corner_off[ca]  # (A, 15, 3) point indices
    ib = ijk + corner_off[cb]

    def coords(idx3):
        return torch.stack(
            [xs[idx3[..., 0]], ys[idx3[..., 1]], zs[idx3[..., 2]]], dim=-1
        )

    pa = coords(ia)
    pb = coords(ib)
    verts = pa + t[..., None] * (pb - pa)  # (A, 15, 3)

    # Canonical global edge key: axis * (nz*ny*nx) + flat index of the
    # edge's canonical origin point.
    axis, ox, oy, oz = (edge_canon[:, c][e] for c in range(4))
    flat_origin = ((k[:, None] + oz) * ny + (j[:, None] + oy)) * nx + (i[:, None] + ox)
    keys = torch.where(valid, axis * (nx * ny * nz) + flat_origin, -1)
    return verts, keys, valid


def _transform_points(points: np.ndarray, matrix: np.ndarray | None) -> np.ndarray:
    """The grid-matrix transform of mesh points, in float64 on the host."""
    if matrix is None:
        return points
    m = np.asarray(matrix, dtype=np.float64)
    return points @ m[:3, :3].T + m[:3, 3]


def _weld_triangle_soup(
    used_verts: np.ndarray,  # (M, 3) vertex positions, 3 per triangle
    used_keys: np.ndarray,  # (M,) canonical edge ids
    matrix: np.ndarray | None,
    return_keys: bool = False,
) -> PolyData:
    """Merge duplicate vertices by exact integer edge identity (each MC
    vertex lies on one grid edge), then drop degenerate triangles — matching
    vtkContourFilter's merged-points output without float tolerances.
    ``return_keys=True`` additionally returns the per-point canonical edge
    keys (same order as ``points``) for gradient-normal computation."""
    uniq, inverse = np.unique(used_keys, return_inverse=True)
    points = np.zeros((uniq.shape[0], 3), dtype=used_verts.dtype)
    # Last write wins per key. Duplicates agree to 1 ulp (two cells
    # interpolate the shared edge with opposite corner order), so the
    # deterministic pick matters only for bit-level reproducibility —
    # weld_soup_device selects the same occurrence.
    points[inverse] = used_verts
    triangles = inverse.reshape(-1, 3).astype(np.int64)
    ok = (
        (triangles[:, 0] != triangles[:, 1])
        & (triangles[:, 1] != triangles[:, 2])
        & (triangles[:, 0] != triangles[:, 2])
    )
    mesh = PolyData(_transform_points(points, matrix), triangles[ok])
    return (mesh, uniq) if return_keys else mesh


def weld_soup_device(
    verts: torch.Tensor, keys: torch.Tensor
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weld a triangle soup on its device: only the final mesh (unique
    points, triangles, unique keys) crosses to the host. Returns (points
    (V, 3) in the soup's dtype, triangles (T, 3) int64, keys (V,)), bit for
    bit what :func:`_weld_triangle_soup` gives without a matrix.

    A stable sort of the keys puts equal keys in runs in their original
    order. The host weld scatters the soup in original order, so the LAST
    original occurrence of each key wins: duplicates may differ by one ulp
    (two cells interpolate the shared edge with opposite corner order), so
    the last element of each run is the one kept, not the first."""
    sorted_keys, order = torch.sort(keys, stable=True)
    step = sorted_keys[1:] != sorted_keys[:-1]
    edge = torch.ones(1, dtype=torch.bool, device=keys.device)
    first = torch.cat([edge, step])
    last = torch.cat([step, edge])
    inverse = torch.empty_like(order)
    inverse[order] = torch.cumsum(first, 0) - 1
    tri = inverse.reshape(-1, 3)
    ok = (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2]) & (tri[:, 0] != tri[:, 2])
    return (
        verts[order][last].cpu().numpy(),
        tri[ok].cpu().numpy(),
        sorted_keys[last].cpu().numpy(),
    )


def _empty_mesh(compute_normals: bool) -> PolyData:
    empty = PolyData(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    if compute_normals:
        # Non-empty results carry "Normals"; keep the attribute set
        # shape-stable for consumers that index it unconditionally.
        empty.point_data["Normals"] = np.zeros((0, 3), np.float32)
    return empty


def _device_soup(pv: torch.Tensor, iso: float, xs, ys, zs):
    """The compacted triangle soup of the two-phase extraction, on the
    volume's device: (verts (M, 3), keys (M,)) in cell order, or None when
    no cell crosses ``iso``."""
    nz, ny, nx = pv.shape
    iso_t = torch.tensor(iso, dtype=pv.dtype, device=pv.device)
    cfg = _cube_config(pv, iso_t).reshape(-1)
    flat_idx = torch.nonzero((cfg != 0) & (cfg != 255)).squeeze(1)
    if flat_idx.numel() == 0:
        return None
    ncx, ncy = nx - 1, ny - 1
    cell_idx = torch.stack(
        [flat_idx // (ncy * ncx), (flat_idx // ncx) % ncy, flat_idx % ncx], dim=1
    )
    cfg_active = cfg[flat_idx].long()
    pvf = pv.reshape(-1)
    np_dtype = numpy_dtype(pv.dtype)
    axes = [torch.as_tensor(np.asarray(a, np_dtype), device=pv.device) for a in (xs, ys, zs)]
    verts_parts, keys_parts = [], []
    # Chunks keep cell order, so the soup (and the welded mesh) does not
    # depend on CELL_CHUNK.
    for s in range(0, flat_idx.shape[0], CELL_CHUNK):
        verts, keys, valid = _active_cell_triangles(
            pvf, iso_t, cell_idx[s : s + CELL_CHUNK], cfg_active[s : s + CELL_CHUNK],
            *axes, (nx, ny, nz),
        )
        verts_parts.append(verts[valid])
        keys_parts.append(keys[valid])
    return torch.cat(verts_parts), torch.cat(keys_parts)


def marching_cubes(
    point_volume: torch.Tensor,
    iso: float,
    xs: np.ndarray,
    ys: np.ndarray,
    zs: np.ndarray,
    matrix: np.ndarray | None = None,
    compute_normals: bool = False,
    return_soup: bool = False,
    backend: str = "device",
    weld_backend: str = "host",
) -> PolyData | tuple[np.ndarray, np.ndarray]:
    """Extract the `iso` isosurface of a (nz, ny, nx) point-scalar volume.

    ``xs/ys/zs`` are the per-axis point coordinates (grid frame); ``matrix``
    (4x4) is applied to the output vertices, mirroring the transform filter
    at ``Reconstruction/main.cxx:176-189``.

    ``backend``: ``"device"`` (the default) runs the two-phase extraction on
    the volume's device, in its dtype; ``"native"`` copies the volume to the
    host and walks it in float64 with the native library's table walker
    (``native.marching_cubes_f64``), raising if that library cannot be
    built. ``weld_backend`` (device backend only): ``"host"`` (the default)
    copies the compacted soup to the host and welds it with ``np.unique``;
    ``"device"`` welds it on the device (:func:`weld_soup_device`) so that
    only the final mesh crosses, bit for bit the same mesh.

    ``compute_normals=True`` attaches a ``"Normals"`` point array (gradient
    normals, ``ops/normals.py`` — vtkContourFilter's ComputeNormals default,
    see ``Reconstruction/main.cxx:169-173``), transformed by ``matrix`` like
    the points; it reads the point volume on the host.

    ``return_soup=True`` skips welding and returns the raw triangle soup
    ``(verts (M, 3), keys (M,))`` with volume-local edge keys, for callers
    (the sparse per-block and the sharded extraction) that translate the
    keys to a global domain and weld once at the end.
    """
    if backend not in ("device", "native"):
        raise ValueError(f"backend must be 'device' or 'native', got {backend!r}")
    if weld_backend not in ("host", "device"):
        raise ValueError(f"weld_backend must be 'host' or 'device', got {weld_backend!r}")
    if backend == "native" and weld_backend == "device":
        raise ValueError("weld_backend='device' needs backend='device'")
    pv = torch.as_tensor(point_volume)
    pv_host = None
    if backend == "native":
        from .. import native

        pv_host = pv.cpu().numpy().astype(np.float64)
        verts, keys = native.marching_cubes_f64(pv_host, iso, xs, ys, zs)
        verts, keys = verts.reshape(-1, 3), keys.reshape(-1)
        if return_soup:
            return verts, keys
        mesh, uniq = _weld_triangle_soup(verts, keys, matrix, return_keys=True)
    else:
        soup = _device_soup(pv, iso, xs, ys, zs)
        if soup is None:
            if return_soup:
                return np.zeros((0, 3)), np.zeros((0,), np.int64)
            return _empty_mesh(compute_normals)
        if weld_backend == "device" and not return_soup:
            points, triangles, uniq = weld_soup_device(*soup)
            mesh = PolyData(_transform_points(points, matrix), triangles)
        else:
            verts, keys = (a.cpu().numpy() for a in soup)
            if return_soup:
                return verts, keys
            mesh, uniq = _weld_triangle_soup(verts, keys, matrix, return_keys=True)
    if compute_normals:
        from .normals import normals_for_edge_keys, transform_normals

        if pv_host is None:
            pv_host = pv.cpu().numpy()
        normals = normals_for_edge_keys(pv_host, xs, ys, zs, uniq, iso)
        if matrix is not None:
            normals = transform_normals(normals, matrix)
        mesh.point_data["Normals"] = normals
    return mesh


def extract_isosurface(
    grid: VoxelGrid,
    cell_volume,
    iso: float,
    compute_normals: bool = True,
    backend: str = "device",
    weld_backend: str = "host",
) -> PolyData:
    """Full reference pipeline: cell->point averaging, contour at `iso`
    (with gradient "Normals" — vtkContourFilter's ComputeNormals default),
    grid-matrix transform (``Reconstruction/main.cxx:150-189``).
    ``cell_volume`` is a tensor (cell->point and the device extraction run
    on its device) or an array (on the CPU). ``backend`` and
    ``weld_backend`` pass through to :func:`marching_cubes`."""
    pv = cell_to_point(torch.as_tensor(cell_volume))
    xs, ys, zs = grid.point_axes(numpy_dtype(pv.dtype))
    mesh = marching_cubes(
        pv, iso, xs, ys, zs, matrix=grid.matrix, compute_normals=compute_normals,
        backend=backend, weld_backend=weld_backend,
    )
    # vtkContourFilter's ComputeScalars default is also ON: the output
    # carries the contoured scalars (== iso at every crossing) under the
    # input array's name, marked as the active scalars
    # (vtkCudaReconstructionFilter.cxx:129-135 names the array).
    mesh.point_data["reconstruction_scalar"] = np.full(
        mesh.num_points, iso, np.float64
    )
    mesh.active_scalars = "reconstruction_scalar"
    return mesh
