"""TUM RGB-D dataset reader (for incremental fusion, BASELINE config 5).

The port of ``cudadepthmapintegration_tpu/io/tum.py``; PIL is imported
only when a frame is decoded.

Reads the standard TUM format (https://vision.in.tum.de/data/datasets/rgbd-dataset):

  dataset/
    depth.txt        # "timestamp filename" lines (# comments)
    rgb.txt          # "timestamp filename"
    groundtruth.txt  # "timestamp tx ty tz qx qy qz qw" (camera pose in world)
    depth/*.png      # 16-bit PNG, depth_meters = value / depth_scale (5000)
    rgb/*.png        # 8-bit RGB

Conventions mapped to this framework:
  * invalid depth (0 in the PNG) becomes the -1.0 sentinel;
  * ground-truth poses are camera->world; we invert to the world->camera RT
    the fusion math uses (``Sources/ReconstructionData.cxx`` convention);
  * depth/rgb/pose streams are associated by nearest timestamp within
    ``max_dt`` (the dataset's own association tooling behavior).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.camera import Camera
from ..core.view import DepthMapView

__all__ = ["TUMIntrinsics", "TUMDataset", "quaternion_to_rotation"]


@dataclasses.dataclass(frozen=True)
class TUMIntrinsics:
    """Pinhole intrinsics; defaults are the TUM freiburg1 calibration."""

    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3

    def k(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )

    @staticmethod
    def freiburg(n: int) -> "TUMIntrinsics":
        return {
            1: TUMIntrinsics(517.3, 516.5, 318.6, 255.3),
            2: TUMIntrinsics(520.9, 521.0, 325.1, 249.7),
            3: TUMIntrinsics(535.4, 539.2, 320.1, 247.6),
        }[n]


def quaternion_to_rotation(qx, qy, qz, qw) -> np.ndarray:
    """Unit quaternion -> 3x3 rotation (camera->world for TUM groundtruth)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def _read_list(path: str) -> list[tuple[float, list[str]]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            out.append((float(tokens[0]), tokens[1:]))
    return out


def _associate(a, b, max_dt):
    """Nearest-timestamp association (greedy, sorted), TUM-tool style."""
    out = []
    j = 0
    for ta, va in a:
        while j + 1 < len(b) and abs(b[j + 1][0] - ta) <= abs(b[j][0] - ta):
            j += 1
        if b and abs(b[j][0] - ta) <= max_dt:
            out.append((ta, va, b[j][0], b[j][1]))
    return out


class TUMDataset:
    """Lazy sequence of DepthMapViews from a TUM RGB-D directory."""

    def __init__(
        self,
        root: str,
        intrinsics: TUMIntrinsics | None = None,
        depth_scale: float = 5000.0,
        max_dt: float = 0.02,
        with_color: bool = True,
    ):
        self.root = root
        self.intrinsics = intrinsics or TUMIntrinsics()
        self.depth_scale = float(depth_scale)
        self.with_color = with_color

        depth_list = _read_list(os.path.join(root, "depth.txt"))
        pose_list = _read_list(os.path.join(root, "groundtruth.txt"))
        rgb_list = (
            _read_list(os.path.join(root, "rgb.txt")) if with_color else []
        )
        assoc = _associate(depth_list, pose_list, max_dt)
        self.frames = []
        rgb_sorted = rgb_list
        j = 0
        for t_depth, depth_v, t_pose, pose_v in assoc:
            rgb_file = None
            if rgb_sorted:
                while (
                    j + 1 < len(rgb_sorted)
                    and abs(rgb_sorted[j + 1][0] - t_depth)
                    <= abs(rgb_sorted[j][0] - t_depth)
                ):
                    j += 1
                if abs(rgb_sorted[j][0] - t_depth) <= max_dt:
                    rgb_file = rgb_sorted[j][1][0]
            self.frames.append(
                dict(
                    timestamp=t_depth,
                    depth_file=depth_v[0],
                    rgb_file=rgb_file,
                    pose=[float(x) for x in pose_v],
                )
            )

    def __len__(self) -> int:
        return len(self.frames)

    def camera(self, i: int) -> Camera:
        """Frame camera from pose + intrinsics alone (no image decode) —
        cheap rig-geometry access."""
        tx, ty, tz, qx, qy, qz, qw = self.frames[i]["pose"]
        r_cw = quaternion_to_rotation(qx, qy, qz, qw)  # camera -> world
        rt = np.eye(4)
        rt[:3, :3] = r_cw.T  # world -> camera
        rt[:3, 3] = -r_cw.T @ np.array([tx, ty, tz])
        return Camera(k=self.intrinsics.k(), rt=rt)

    def cameras(self):
        return [self.camera(i) for i in range(len(self))]

    def __getitem__(self, i: int) -> DepthMapView:
        from PIL import Image

        fr = self.frames[i]
        depth_png = np.asarray(
            Image.open(os.path.join(self.root, fr["depth_file"]))
        )
        depth = depth_png.astype(np.float64) / self.depth_scale
        depth[depth_png == 0] = -1.0
        color = None
        if fr["rgb_file"] is not None:
            color = np.asarray(
                Image.open(os.path.join(self.root, fr["rgb_file"])).convert("RGB")
            )
        return DepthMapView(
            depth=depth,
            camera=self.camera(i),
            color=color,
            name=fr["depth_file"],
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
