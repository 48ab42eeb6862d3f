"""Calibrated camera model (K, R, T) for depth-map projection.

Mirrors the reference's semantics:

* KRTD text files hold K (3x3), R (3x3), T (3); the trailing distortion row is
  ignored (``Sources/Helper.h:105-168``).
* The reference pads K to 4x4 with an identity last row/col
  (``Sources/ReconstructionData.cxx:192-212``) and packs [R|T] into a 4x4
  "TR" matrix. Projection of a world point is
  ``hom = K4 @ (RT @ world)``; pixel = round(hom.xy / hom.z)
  (``Reconstruction/CudaReconstruction.cu:166-189``).
* The camera-space depth used against the depth map is ``camera.z`` (not ray
  length) (``CudaReconstruction.cu:207``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Camera", "round_half_away", "compose_projection"]


def round_half_away(x: np.ndarray) -> np.ndarray:
    """C/CUDA ``round()``: halfway cases away from zero. NumPy's ``np.round``
    is half-to-even, which would diverge from the reference on exact .5 hits
    (``CudaReconstruction.cu:187-189`` uses CUDA round())."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view's calibration. ``k`` is 3x3 intrinsics; ``rt`` is the 4x4
    world->camera matrix [R|T; 0 0 0 1]."""

    k: np.ndarray
    rt: np.ndarray

    def __post_init__(self):
        k = np.asarray(self.k, dtype=np.float64)
        rt = np.asarray(self.rt, dtype=np.float64)
        if k.shape != (3, 3):
            raise ValueError(f"K must be 3x3, got {k.shape}")
        if rt.shape != (4, 4):
            raise ValueError(f"RT must be 4x4, got {rt.shape}")
        object.__setattr__(self, "k", k)
        object.__setattr__(self, "rt", rt)

    @property
    def k4(self) -> np.ndarray:
        """K padded to 4x4 (``Sources/ReconstructionData.cxx:192-212``)."""
        k4 = np.eye(4, dtype=np.float64)
        k4[:3, :3] = self.k
        return k4

    def projection(self, grid_matrix: np.ndarray | None = None) -> np.ndarray:
        """Composed 4x4 projection ``K4 @ RT [@ grid_matrix]``.

        The reference applies the three transforms per voxel per thread
        (``CudaReconstruction.cu:166-176``); composing them once on the host in
        float64 is both faster and more accurate.
        """
        p = self.k4 @ self.rt
        if grid_matrix is not None:
            p = p @ np.asarray(grid_matrix, dtype=np.float64)
        return p

    def project_points(self, world_xyz: np.ndarray):
        """Vectorized world->pixel projection (float64, for oracles/tests).

        Returns (u, v, z_cam, z_hom): continuous pixel coords (pre-round),
        camera-space z, and homogeneous z (identical here since K row 2 is
        (0,0,1,0), but kept distinct for clarity).
        """
        w = np.asarray(world_xyz, dtype=np.float64)
        cam = w @ self.rt[:3, :3].T + self.rt[:3, 3]
        hom = cam @ self.k.T
        z = hom[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = hom[..., 0] / z
            v = hom[..., 1] / z
        return u, v, cam[..., 2], z


def compose_projection(
    camera: Camera, grid: "VoxelGrid | None" = None
) -> tuple[np.ndarray, np.ndarray]:
    """Return (P, C) where P = K4 @ RT @ grid_matrix (4x4) and C = RT-row-2
    composed with the grid matrix (length-4), i.e. the affine functional giving
    camera-space z of a grid-frame point. Both float64."""
    if grid is None:
        gm = np.eye(4, dtype=np.float64)
    else:
        gm = np.asarray(grid.matrix, dtype=np.float64)
    p = camera.k4 @ camera.rt @ gm
    c = (camera.rt @ gm)[2, :]
    return p, c
