"""Gradient point normals for extracted isosurfaces.

The reference contours with an unmodified ``vtkContourFilter``
(``Reconstruction/main.cxx:169-173``) whose ``ComputeNormals`` default is
ON, so its output mesh carries a ``"Normals"`` point array computed from
the scalar-field gradient. This module reproduces that: the gradient is
evaluated at the two grid nodes of each vertex's edge by central
differences (one-sided at the volume boundary, divided by the actual
coordinate distance), linearly interpolated to the iso crossing with the
same ``t`` as the vertex position, negated (VTK's convention — normals
point toward DECREASING scalar), and normalized. Vertices whose
interpolated gradient is exactly zero keep a zero normal (VTK's
``vtkMath::Normalize`` leaves zero vectors untouched).

Works from the WELDED canonical edge keys (``axis * N + flat_origin``,
see ``ops/mc_tables.EDGE_CANONICAL``), so it depends only on the welded
mesh and not on how the triangles were extracted.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "geometric_vertex_normals",
    "normals_for_edge_keys",
    "transform_normals",
]


def _node_gradients(flat, shape, xs, ys, zs, kk, jj, ii):
    """Central-difference gradient of the point volume at integer nodes
    (one-sided at boundaries; safe for degenerate single-node axes).

    ``flat`` stays in its storage dtype; only the O(V) gathered node
    values are widened to fp64 (fp32 is exact in fp64, so this is
    bit-identical to widening the whole volume — which at 1024^3 would
    be an ~8.6 GiB host allocation for ~V needed values)."""
    nz, ny, nx = shape
    base = (kk * ny + jj) * nx + ii

    def axis_grad(idx, n, coords, stride):
        hi = np.minimum(idx + 1, n - 1)
        lo = np.maximum(idx - 1, 0)
        num = flat[base + (hi - idx) * stride].astype(np.float64) - flat[
            base + (lo - idx) * stride
        ].astype(np.float64)
        den = coords[hi] - coords[lo]
        return num / np.where(den == 0, 1.0, den)

    gx = axis_grad(ii, nx, xs, 1)
    gy = axis_grad(jj, ny, ys, nx)
    gz = axis_grad(kk, nz, zs, nx * ny)
    return np.stack([gx, gy, gz], axis=-1)


def normals_for_edge_keys(
    point_volume: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    zs: np.ndarray,
    keys: np.ndarray,
    iso: float,
) -> np.ndarray:
    """(V, 3) float32 unit normals for welded vertices given by canonical
    edge keys into ``point_volume`` (grid frame, pre grid-matrix)."""
    pv = np.asarray(point_volume)
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    zs = np.asarray(zs, np.float64)
    nz, ny, nx = pv.shape
    flat = pv.reshape(-1)
    n_total = nx * ny * nz
    keys = np.asarray(keys, np.int64)
    axis = keys // n_total
    rest = keys % n_total
    kk = rest // (ny * nx)
    jj = (rest // nx) % ny
    ii = rest % nx
    # Edge endpoint B = origin + 1 along the edge axis (axis 0/1/2 = x/y/z;
    # in-bounds by construction — the edge belongs to an existing cell).
    ib = ii + (axis == 0)
    jb = jj + (axis == 1)
    kb = kk + (axis == 2)

    shape = (nz, ny, nx)
    ga = _node_gradients(flat, shape, xs, ys, zs, kk, jj, ii)
    gb = _node_gradients(flat, shape, xs, ys, zs, kb, jb, ib)
    fa = flat[(kk * ny + jj) * nx + ii].astype(np.float64)
    fb = flat[(kb * ny + jb) * nx + ib].astype(np.float64)
    denom = fb - fa
    t = np.where(denom != 0, (iso - fa) / np.where(denom == 0, 1.0, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)

    n = -(ga + t[:, None] * (gb - ga))
    norm = np.linalg.norm(n, axis=1)
    n = n / np.where(norm == 0, 1.0, norm)[:, None]
    return n.astype(np.float32)


def geometric_vertex_normals(
    points: np.ndarray, triangles: np.ndarray
) -> np.ndarray:
    """(V, 3) float32 area-weighted vertex normals from triangle winding.

    For the SPARSE extraction path (``SparseTSDFGrid.extract_mesh`` — our
    extension, no reference counterpart): gradient normals would need a
    2-voxel cross-block halo, while marching-cubes winding is already
    consistent with the field orientation (same sign convention as
    ``normals_for_edge_keys``; validated against it in tests), so the
    geometric normal is the robust block-local choice. Zero-area /
    unreferenced vertices keep a zero normal."""
    points = np.asarray(points, np.float64)
    triangles = np.asarray(triangles, np.int64)
    face = np.cross(
        points[triangles[:, 1]] - points[triangles[:, 0]],
        points[triangles[:, 2]] - points[triangles[:, 0]],
    )  # magnitude = 2*area -> area weighting for free
    acc = np.zeros_like(points)
    for c in range(3):
        np.add.at(acc, triangles[:, c], face)
    norm = np.linalg.norm(acc, axis=1)
    acc = acc / np.where(norm == 0, 1.0, norm)[:, None]
    return acc.astype(np.float32)


def transform_normals(normals: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Transform normals by a 4x4 point transform: inverse-transpose of the
    3x3 block, then renormalize (what ``vtkTransformFilter`` does to the
    active normals at ``Reconstruction/main.cxx:176-182``; for the CLI's
    orthogonal grid matrix this reduces to the rotation itself)."""
    m3 = np.asarray(matrix, np.float64)[:3, :3]
    n = np.asarray(normals, np.float64) @ np.linalg.inv(m3)  # rows @ M^-1 = (M^-T n)^T
    norm = np.linalg.norm(n, axis=1)
    n = n / np.where(norm == 0, 1.0, norm)[:, None]
    return n.astype(np.float32)
