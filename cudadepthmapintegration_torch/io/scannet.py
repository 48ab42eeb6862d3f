"""ScanNet ``.sens`` sensor-stream reader (incremental fusion, config 5).

The port of ``cudadepthmapintegration_tpu/io/scannet.py``.

Parses the public ScanNet ``SensorData`` binary layout (one header + N
RGB-D frames, each with a camera-to-world pose and compressed payloads):

  uint32  version (== 4)
  uint64  strlen; char sensor_name[strlen]
  float32[16] x4   intrinsic_color, extrinsic_color,
                   intrinsic_depth, extrinsic_depth   (4x4 row-major)
  int32   color_compression  (-1/0 raw, 1 png, 2 jpeg)
  int32   depth_compression  (-1/0 raw_ushort, 1 zlib_ushort)
  uint32  color_width, color_height, depth_width, depth_height
  float32 depth_shift        (depth_meters = stored_ushort / depth_shift)
  uint64  num_frames
  per frame:
    float32[16] camera_to_world
    uint64 timestamp_color, timestamp_depth
    uint64 color_bytes, depth_bytes
    uint8  color_data[color_bytes], depth_data[depth_bytes]

Conventions mapped to this framework (same as ``io/tum.py``):
  * stored 0 depth becomes the -1.0 invalid sentinel;
  * camera-to-world poses are inverted to the world->camera RT the fusion
    math uses (``Sources/ReconstructionData.cxx`` convention);
  * the file is indexed ONCE (offsets only); frames decode lazily per
    access, so it composes with ``pipeline.streaming.prefetch_views``.

Color is decoded with PIL (jpeg/png); raw color is accepted as packed
RGB8. Depth zlib_ushort/raw_ushort are handled natively.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..core.camera import Camera
from ..core.view import DepthMapView

__all__ = ["ScanNetSensDataset"]

_COLOR_RAW = {-1, 0}
_DEPTH_RAW = {-1, 0}


def _rigid_inverse(m: np.ndarray) -> np.ndarray:
    """Invert a rigid 4x4 (rotation transpose, not a general inverse)."""
    r = m[:3, :3]
    out = np.eye(4)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ m[:3, 3]
    return out


class _SensColorView:
    """A frame seen through the NATIVE color camera.

    Real ScanNet color streams have different resolution/intrinsics than
    depth (``intrinsic_color`` vs ``intrinsic_depth``). Coloration
    (``ops/coloration.py``) projects mesh vertices with ``view.camera`` and
    samples ``view.color`` against ``view.depth.shape`` bounds — so a view
    that carries the color camera + full-resolution image colorizes
    exactly, with no resampling. ``depth`` is a zero-storage broadcast
    placeholder (coloration reads only its shape; the reference does no
    depth/occlusion test either, ``MeshColoration.cxx:150-170``).
    """

    __slots__ = ("_ds", "_i")

    def __init__(self, ds: "ScanNetSensDataset", i: int):
        self._ds = ds
        self._i = i

    @property
    def camera(self) -> Camera:
        ds = self._ds
        pose_cw = ds._frames[self._i][0]
        return Camera(
            k=ds.intrinsic_color[:3, :3],
            rt=_rigid_inverse(pose_cw @ ds.extrinsic_color),
        )

    @property
    def color(self) -> np.ndarray:
        ds = self._ds
        _, c_off, c_len, _, _ = ds._frames[self._i]
        if not c_len:
            return np.zeros((ds.color_height, ds.color_width, 3), np.uint8)
        with open(ds.path, "rb") as f:
            f.seek(c_off)
            return ds._decode_color(f.read(c_len))

    @property
    def depth(self) -> np.ndarray:
        ds = self._ds
        return np.broadcast_to(
            np.float64(-1.0), (ds.color_height, ds.color_width)
        )

    @property
    def name(self) -> str:
        return f"{os.path.basename(self._ds.path)}[color {self._i}]"


class _SensColorViews:
    """Lazy indexable sequence of :class:`_SensColorView`."""

    def __init__(self, ds: "ScanNetSensDataset"):
        self._ds = ds

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, i: int) -> _SensColorView:
        return _SensColorView(self._ds, i)


class ScanNetSensDataset:
    """Lazy sequence of DepthMapViews from a ScanNet ``.sens`` file."""

    def __init__(self, path: str, with_color: bool = True):
        self.path = path
        self.with_color = with_color
        with open(path, "rb") as f:
            (version,) = struct.unpack("<I", f.read(4))
            if version != 4:
                raise ValueError(f"unsupported .sens version {version}")
            (n,) = struct.unpack("<Q", f.read(8))
            self.sensor_name = f.read(n).decode("ascii", "replace")

            def mat4():
                return np.frombuffer(f.read(64), np.float32).reshape(4, 4).astype(
                    np.float64
                )

            self.intrinsic_color = mat4()
            self.extrinsic_color = mat4()
            self.intrinsic_depth = mat4()
            self.extrinsic_depth = mat4()
            self.color_compression, self.depth_compression = struct.unpack(
                "<ii", f.read(8)
            )
            (
                self.color_width,
                self.color_height,
                self.depth_width,
                self.depth_height,
            ) = struct.unpack("<IIII", f.read(16))
            (self.depth_shift,) = struct.unpack("<f", f.read(4))
            (num_frames,) = struct.unpack("<Q", f.read(8))

            # Index pass: record per-frame payload offsets without reading
            # the payloads (seek over them).
            self._frames = []
            for _ in range(num_frames):
                pose = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
                f.read(16)  # timestamps
                color_bytes, depth_bytes = struct.unpack("<QQ", f.read(16))
                color_off = f.tell()
                f.seek(color_bytes, os.SEEK_CUR)
                depth_off = f.tell()
                f.seek(depth_bytes, os.SEEK_CUR)
                self._frames.append(
                    (
                        pose.astype(np.float64),
                        color_off,
                        color_bytes,
                        depth_off,
                        depth_bytes,
                    )
                )

    def __len__(self) -> int:
        return len(self._frames)

    def _decode_depth(self, data: bytes) -> np.ndarray:
        if self.depth_compression == 1:  # zlib_ushort
            data = zlib.decompress(data)
        elif self.depth_compression not in _DEPTH_RAW:
            raise ValueError(
                f"unsupported depth compression {self.depth_compression}"
            )
        raw = np.frombuffer(data, np.uint16).reshape(
            self.depth_height, self.depth_width
        )
        depth = raw.astype(np.float64) / float(self.depth_shift)
        depth[raw == 0] = -1.0
        return depth

    def _decode_color(self, data: bytes) -> np.ndarray:
        if self.color_compression in _COLOR_RAW:
            return np.frombuffer(data, np.uint8).reshape(
                self.color_height, self.color_width, 3
            )
        import io as _io

        from PIL import Image

        return np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))

    def camera(self, i: int) -> Camera:
        """Frame depth-camera from the header pose alone (no payload
        read) — cheap rig-geometry access."""
        pose_cw = self._frames[i][0]
        return Camera(
            k=self.intrinsic_depth[:3, :3],
            rt=_rigid_inverse(pose_cw @ self.extrinsic_depth),
        )

    def cameras(self):
        return [self.camera(i) for i in range(len(self))]

    def __getitem__(self, i: int) -> DepthMapView:
        pose_cw, c_off, c_len, d_off, d_len = self._frames[i]
        with open(self.path, "rb") as f:
            f.seek(d_off)
            depth = self._decode_depth(f.read(d_len))
            color = None
            if self.with_color and c_len:
                f.seek(c_off)
                color = self._decode_color(f.read(c_len))
        if color is not None and color.shape[:2] != depth.shape:
            # ScanNet color is a different resolution than depth; fusion
            # operates in depth geometry, so resample color to depth size
            # (nearest — preserves uchar values for the coloration parity
            # rules).
            ys = (
                np.arange(depth.shape[0]) * color.shape[0] // depth.shape[0]
            )
            xs = (
                np.arange(depth.shape[1]) * color.shape[1] // depth.shape[1]
            )
            color = color[np.ix_(ys, xs)]
        # world -> depth camera; composes extrinsic_depth (identity in
        # released ScanNet scans, kept for format generality).
        return DepthMapView(
            depth=depth,
            camera=self.camera(i),
            color=color,
            name=f"{os.path.basename(self.path)}[{i}]",
        )

    def color_views(self) -> _SensColorViews:
        """Frames as NATIVE-color-camera views for exact coloration.

        Use these (not the depth-geometry views, whose color is
        nearest-resampled to depth resolution) when attaching vertex colors:
        projection uses ``intrinsic_color``/``extrinsic_color`` and samples
        the full-resolution image.
        """
        return _SensColorViews(self)
