"""Per-view data object: depth map + calibration (+ optional color / cost).

Equivalent of ``ReconstructionData``
(``Sources/ReconstructionData.{h,cxx}``): holds one view's depth image, the
camera, and the auxiliary "Best Cost Values" / "Color" channels from the VTI
point data (``Sources/ReconstructionData.cxx:92-116,138-167``).

Array conventions:
  * images are stored in row-major screen order ``(height, width)`` with row 0
    at the TOP of the image. The reference stores VTK image data bottom-up and
    y-flips at every access (``CudaReconstruction.cu:141-149``,
    ``ReconstructionData.cxx:107``); we instead flip ONCE at load time so the
    hot path indexes ``img[v, u]`` directly.
  * invalid depth sentinel is exactly ``-1.0``
    (``ReconstructionData.cxx:159-166``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera

__all__ = ["DepthMapView", "apply_best_cost_threshold"]


def apply_best_cost_threshold(
    depth: np.ndarray, best_cost: np.ndarray | None, threshold: float
) -> np.ndarray:
    """Set depth to -1 wherever best_cost > threshold
    (``ReconstructionData::ApplyDepthThresholdFilter``,
    ``Sources/ReconstructionData.cxx:138-167``). No-op when cost is missing or
    shaped differently (the reference silently skips on tuple-count mismatch).
    """
    if best_cost is None or best_cost.shape != depth.shape:
        return depth
    return np.where(best_cost > threshold, np.float64(-1.0), depth)


@dataclasses.dataclass
class DepthMapView:
    """One calibrated view.

    Attributes:
      depth: (H, W) float array, top-down row order; -1 marks invalid pixels.
      camera: the Camera (K 3x3, RT 4x4).
      color: optional (H, W, 3) uint8 image, top-down row order.
      best_cost: optional (H, W) float array (ZNCC matcher cost).
      name: provenance label (source path) for logging.
    """

    depth: np.ndarray
    camera: Camera
    color: np.ndarray | None = None
    best_cost: np.ndarray | None = None
    name: str = ""

    def __post_init__(self):
        self.depth = np.asarray(self.depth)
        if self.depth.ndim != 2:
            raise ValueError(f"depth must be (H, W), got {self.depth.shape}")
        if self.color is not None:
            self.color = np.asarray(self.color)
            if self.color.shape[:2] != self.depth.shape:
                raise ValueError(
                    f"color {self.color.shape} does not match depth {self.depth.shape}"
                )
        if self.best_cost is not None:
            self.best_cost = np.asarray(self.best_cost)

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    def thresholded(self, threshold_best_cost: float) -> "DepthMapView":
        """Return a copy with the best-cost threshold applied to depth."""
        return dataclasses.replace(
            self,
            depth=apply_best_cost_threshold(
                self.depth, self.best_cost, threshold_best_cost
            ),
        )
