"""Voxel-grid geometry for TSDF fusion.

Re-design of the reference's grid model
(``Reconstruction/vtkCudaReconstructionFilter.cxx:129-135``,
``Reconstruction/CudaReconstruction.cu:78-83,126-134``):

* the grid is specified by *point* dimensions ``dims`` (VTK convention), but
  scalars live on **cells**, so the scalar volume has shape
  ``(dims[2]-1, dims[1]-1, dims[0]-1)`` — note we store z-major (z, y, x) which
  matches the reference's linear id ``(k*dimY + j)*dimX + i``
  (``CudaReconstruction.cu:126-134``) under C-order flattening.
* a voxel's center in grid-frame coordinates is
  ``origin + (index + 0.5) * spacing`` (``CudaReconstruction.cu:78-83``),
  then transformed by a 4x4 ``grid_matrix``
  (``CudaReconstruction.cu:168``; built row-wise from the three basis vectors
  by the CLI, ``Reconstruction/main.cxx:345-359``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["VoxelGrid", "grid_matrix_from_axes", "are_vectors_orthogonal"]


def are_vectors_orthogonal(
    vec_x: Sequence[float],
    vec_y: Sequence[float],
    vec_z: Sequence[float],
    epsilon: float = 1e-5,
) -> bool:
    """Pairwise-orthogonality check mirroring ``AreVectorsOrthogonal``
    (``Reconstruction/main.cxx:363-382``; the reference's epsilon is 10e-6)."""
    x = np.asarray(vec_x, dtype=np.float64)
    y = np.asarray(vec_y, dtype=np.float64)
    z = np.asarray(vec_z, dtype=np.float64)
    return bool(
        abs(float(x @ y)) <= epsilon
        and abs(float(y @ z)) <= epsilon
        and abs(float(z @ x)) <= epsilon
    )


def grid_matrix_from_axes(
    vec_x: Sequence[float] = (1.0, 0.0, 0.0),
    vec_y: Sequence[float] = (0.0, 1.0, 0.0),
    vec_z: Sequence[float] = (0.0, 0.0, 1.0),
) -> np.ndarray:
    """Build the 4x4 grid matrix exactly like ``CreateGridMatrixFromInput``
    (``Reconstruction/main.cxx:345-359``): identity with vec_x written into
    row 0, vec_y into row 1, vec_z into row 2."""
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = np.asarray(vec_x, dtype=np.float64)
    m[1, :3] = np.asarray(vec_y, dtype=np.float64)
    m[2, :3] = np.asarray(vec_z, dtype=np.float64)
    return m


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Immutable description of the fusion grid.

    Attributes:
      dims: point dimensions (nx, ny, nz) — cells are (nx-1, ny-1, nz-1).
      origin: grid-frame origin (x, y, z).
      spacing: voxel spacing (sx, sy, sz).
      matrix: 4x4 grid-frame -> world transform (applied to voxel centers).
    """

    dims: tuple[int, int, int]
    origin: tuple[float, float, float]
    spacing: tuple[float, float, float]
    matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )

    def __post_init__(self):
        if len(self.dims) != 3 or any(int(d) < 2 for d in self.dims):
            raise ValueError(f"grid dims must be 3 ints >= 2, got {self.dims}")
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "origin", tuple(float(v) for v in self.origin))
        object.__setattr__(self, "spacing", tuple(float(v) for v in self.spacing))
        m = np.asarray(self.matrix, dtype=np.float64)
        if m.shape != (4, 4):
            raise ValueError(f"grid matrix must be 4x4, got {m.shape}")
        object.__setattr__(self, "matrix", m)

    # -- cell/point bookkeeping ------------------------------------------------

    @property
    def cell_dims(self) -> tuple[int, int, int]:
        """(cx, cy, cz) cell counts; reference's dims-1 rule
        (``CudaReconstruction.cu:126-134``)."""
        return (self.dims[0] - 1, self.dims[1] - 1, self.dims[2] - 1)

    @property
    def num_cells(self) -> int:
        cx, cy, cz = self.cell_dims
        return cx * cy * cz

    @property
    def num_points(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def volume_shape(self) -> tuple[int, int, int]:
        """Shape of the cell-scalar volume in (z, y, x) order. C-order ravel of
        this shape reproduces the reference voxel id ``(k*cy + j)*cx + i``."""
        cx, cy, cz = self.cell_dims
        return (cz, cy, cx)

    @property
    def point_shape(self) -> tuple[int, int, int]:
        """Shape of a point-scalar volume in (z, y, x) order."""
        return (self.dims[2], self.dims[1], self.dims[0])

    # -- geometry --------------------------------------------------------------

    def cell_center_axes(self, dtype=np.float64):
        """Per-axis 1-D arrays of cell-center coordinates in the grid frame.

        Because ``center = origin + (i+0.5)*spacing`` is separable per axis and
        the 4x4 transform is affine, downstream projection math composes these
        1-D arrays instead of materializing an (N,3) point cloud (table adds
        over a 3-D lattice instead of per-voxel mat4 products as in
        ``CudaReconstruction.cu:163-176``).
        """
        t = np.dtype(dtype).type
        cx, cy, cz = self.cell_dims
        ox, oy, oz = self.origin
        sx, sy, sz = self.spacing
        xs = t(ox) + (np.arange(cx, dtype=t) + t(0.5)) * t(sx)
        ys = t(oy) + (np.arange(cy, dtype=t) + t(0.5)) * t(sy)
        zs = t(oz) + (np.arange(cz, dtype=t) + t(0.5)) * t(sz)
        return xs, ys, zs

    def point_axes(self, dtype=np.float64):
        """Per-axis 1-D arrays of grid *point* coordinates in the grid frame."""
        t = np.dtype(dtype).type
        nx, ny, nz = self.dims
        ox, oy, oz = self.origin
        sx, sy, sz = self.spacing
        xs = t(ox) + np.arange(nx, dtype=t) * t(sx)
        ys = t(oy) + np.arange(ny, dtype=t) * t(sy)
        zs = t(oz) + np.arange(nz, dtype=t) * t(sz)
        return xs, ys, zs

    def cell_centers_world(self, dtype=np.float64) -> np.ndarray:
        """Dense (cz, cy, cx, 3) array of cell centers in world coordinates
        (grid matrix applied). Intended for oracles/tests, not the hot path."""
        xs, ys, zs = self.cell_center_axes(dtype)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")  # (cx, cy, cz)
        pts = np.stack([gx, gy, gz], axis=-1).transpose(2, 1, 0, 3)  # (cz,cy,cx,3)
        m = self.matrix.astype(dtype)
        return pts @ m[:3, :3].T + m[:3, 3]

    @staticmethod
    def from_bounds(
        origin: Sequence[float],
        end: Sequence[float],
        dims: Sequence[int] | None = None,
        spacing: Sequence[float] | None = None,
        matrix: np.ndarray | None = None,
        force_cubic_voxel: bool = False,
    ) -> "VoxelGrid":
        """dims<->spacing inference mirroring the CLI
        (``Reconstruction/main.cxx:309-340``): given grid end, either spacing
        is derived as size/dims or dims as int(size/spacing);
        ``force_cubic_voxel`` snaps all spacings to the minimum."""
        if (dims is None) == (spacing is None):
            raise ValueError("exactly one of dims/spacing must be given with bounds")
        origin = np.asarray(origin, dtype=np.float64)
        end = np.asarray(end, dtype=np.float64)
        size = end - origin
        if spacing is None:
            dims = tuple(int(d) for d in dims)
            spacing = tuple(float(size[a]) / dims[a] for a in range(3))
        else:
            spacing = tuple(float(s) for s in spacing)
            dims = tuple(int(size[a] / spacing[a]) for a in range(3))
        if force_cubic_voxel:
            m = min(spacing)
            spacing = (m, m, m)
        return VoxelGrid(
            dims=dims,
            origin=tuple(origin),
            spacing=spacing,
            matrix=np.eye(4) if matrix is None else matrix,
        )
