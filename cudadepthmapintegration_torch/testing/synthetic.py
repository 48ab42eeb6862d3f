"""Synthetic calibrated scenes (analytic sphere / plane depth maps).

The reference ships no tests or fixtures (SURVEY.md section 4); these renderers
generate exactly-known depth maps + KRT calibrations so integration, meshing
and coloration can be validated end-to-end against closed-form geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ..core.view import DepthMapView

__all__ = [
    "COLOR_COLUMN_KINDS",
    "color_stat_columns",
    "look_at_camera",
    "orbit_cameras",
    "render_sphere_batch",
    "render_sphere_view",
    "sphere_scene",
]


def look_at_camera(
    eye, target, up=(0.0, 0.0, 1.0), focal: float = 300.0, width: int = 128, height: int = 96
) -> Camera:
    """Build a Camera at `eye` looking at `target` (world -> camera RT with
    +z forward, +x right, +y down; K with principal point at the center)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-9:  # forward parallel to up: pick another up
        right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd])  # rows: camera axes in world coords
    t = -r @ eye
    rt = np.eye(4)
    rt[:3, :3] = r
    rt[:3, 3] = t
    k = np.array(
        [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]]
    )
    return Camera(k=k, rt=rt)


def orbit_cameras(
    n: int,
    radius: float,
    center=(0.0, 0.0, 0.0),
    height: float = 0.0,
    focal: float = 300.0,
    width: int = 128,
    image_height: int = 96,
) -> list[Camera]:
    """`n` cameras on a circle of `radius` about `center`, all looking inward."""
    center = np.asarray(center, dtype=np.float64)
    cams = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        eye = center + np.array([radius * np.cos(a), radius * np.sin(a), height])
        cams.append(
            look_at_camera(
                eye, center, focal=focal, width=width, height=image_height
            )
        )
    return cams


def render_sphere_view(
    camera: Camera,
    width: int,
    height: int,
    center=(0.0, 0.0, 0.0),
    radius: float = 1.0,
    background: float = -1.0,
) -> DepthMapView:
    """Ray-cast a sphere: per pixel, depth = camera-space z of the first
    intersection; misses get `background` (-1 = invalid sentinel). Also
    renders a normal-shaded color image and a zero best-cost channel."""
    c_world = np.asarray(center, dtype=np.float64)
    c_cam = camera.rt[:3, :3] @ c_world + camera.rt[:3, 3]
    k_inv = np.linalg.inv(camera.k)
    us, vs = np.meshgrid(np.arange(width), np.arange(height))  # (H, W)
    pix = np.stack([us + 0.0, vs + 0.0, np.ones_like(us, dtype=np.float64)], -1)
    d = pix @ k_inv.T  # ray directions in camera frame, (H, W, 3)
    dd = np.einsum("hwc,hwc->hw", d, d)
    dc = d @ c_cam
    disc = dc * dc - dd * (c_cam @ c_cam - radius * radius)
    hit = disc >= 0
    sq = np.sqrt(np.where(hit, disc, 0.0))
    t = (dc - sq) / dd  # nearest root
    hit &= t > 0
    depth = np.where(hit, t * d[..., 2], background)
    # Color: Lambertian shading of the sphere normal toward the camera.
    p = t[..., None] * d  # camera-frame hit points
    n_vec = p - c_cam
    norm = np.linalg.norm(n_vec, axis=-1, keepdims=True)
    n_vec = np.where(norm > 0, n_vec / np.maximum(norm, 1e-12), 0.0)
    view_dir = d / np.sqrt(dd)[..., None]
    shade = np.clip(-np.einsum("hwc,hwc->hw", n_vec, view_dir), 0.0, 1.0)
    color = np.zeros((height, width, 3), dtype=np.uint8)
    color[..., 0] = np.where(hit, (64 + 191 * shade), 0).astype(np.uint8)
    color[..., 1] = np.where(hit, (32 + 127 * shade), 0).astype(np.uint8)
    color[..., 2] = np.where(hit, (16 + 63 * shade), 0).astype(np.uint8)
    best_cost = np.where(hit, 0.0, 1.0)
    return DepthMapView(
        depth=depth, camera=camera, color=color, best_cost=best_cost, name="sphere"
    )


def render_sphere_batch(
    k_inv: torch.Tensor,
    c_cam: torch.Tensor,
    width: int,
    height: int,
    radius: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`render_sphere_view` for a batch of cameras, on their device, in
    their float dtype: ``k_inv`` (B, 3, 3) inverse intrinsics and ``c_cam``
    (B, 3) the sphere's centre in each camera frame (``rt[:3, 3]`` for a
    sphere at the origin).

    Returns depth (B, H, W), the camera-space z of the first hit or -1 on a
    miss, and colour (B, H, W, 3) uint8, the same Lambertian shading as
    :func:`render_sphere_view` (0 on a miss). In float32 against that
    function's float64, depths agree to float32 rounding, the hit mask can
    differ on silhouette pixels, and a colour channel by one level (the
    truncation to uint8)."""
    dtype, dev = k_inv.dtype, k_inv.device
    us = torch.arange(width, dtype=dtype, device=dev)[None, None, :]
    vs = torch.arange(height, dtype=dtype, device=dev)[None, :, None]
    ki = k_inv[:, :, :, None, None]
    # Ray directions in the camera frame: k_inv @ (u, v, 1), (B, H, W) each.
    d = [ki[:, r, 0] * us + ki[:, r, 1] * vs + ki[:, r, 2] for r in range(3)]
    c = [c_cam[:, r, None, None] for r in range(3)]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    dc = d[0] * c[0] + d[1] * c[1] + d[2] * c[2]
    cc = (c_cam * c_cam).sum(dim=1)[:, None, None]
    disc = dc * dc - dd * (cc - radius * radius)
    hit = disc >= 0
    t = (dc - torch.sqrt(torch.where(hit, disc, 0.0))) / dd  # nearest root
    hit &= t > 0
    depth = torch.where(hit, t * d[2], -1.0)
    # Shading: the unit normal at the hit against the unit view ray.
    n = [t * d[r] - c[r] for r in range(3)]
    norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    inv = torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-12), 0.0)
    cos = (n[0] * d[0] + n[1] * d[1] + n[2] * d[2]) * inv / torch.sqrt(dd)
    shade = torch.clamp(-cos, 0.0, 1.0)
    color = torch.stack(
        [torch.where(hit, base + span * shade, 0.0) for base, span in ((64, 191), (32, 127), (16, 63))],
        dim=-1,
    ).to(torch.uint8)
    return depth, color


def sphere_scene(
    n_views: int = 4,
    width: int = 128,
    height: int = 96,
    radius: float = 1.0,
    cam_radius: float = 4.0,
    focal: float = 120.0,
) -> list[DepthMapView]:
    """A ring of `n_views` cameras around a unit-ish sphere at the origin."""
    cams = orbit_cameras(
        n_views, cam_radius, focal=focal, width=width, image_height=height
    )
    return [
        render_sphere_view(c, width, height, radius=radius) for c in cams
    ]


# Kinds of crafted sample columns (see color_stat_columns).
COLOR_COLUMN_KINDS = ("uniform", "edges", "split", "none", "one", "full", "constant")
# Values on either side of the high-nibble edges the median's selection uses.
_EDGE_VALUES = np.array([0, 15, 16, 239, 240, 255], np.uint8)


def color_stat_columns(
    n_views: int, n: int, kinds=COLOR_COLUMN_KINDS, seed: int = 0
) -> np.ndarray:
    """(V, N) int32 packed sample words (``r | g << 8 | b << 16 | 1 << 24``
    when valid, 0 when not) whose columns cycle through ``kinds``, crafted
    for the colour statistics' exact median:

    * ``uniform``: random values, each sample valid with probability 1/2;
    * ``edges``: the same with values from 0, 15, 16, 239, 240, 255;
    * ``split``: an even count 2k of valid samples, k in one high nibble and
      k in a higher one per channel, so that the two middle ranks fall in
      different high-nibble bins (no valid sample when V < 2);
    * ``none``: no valid sample; ``one``: exactly one;
    * ``full``: every sample valid, random values (bins past 255 samples
      once V > 255);
    * ``constant``: every sample valid and equal per channel (one bin holds
      all V samples).
    """
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 256, (n_views, n, 3), dtype=np.uint8)
    valid = rng.random((n_views, n), dtype=np.float32) < 0.5
    kind = np.arange(n) % len(kinds)
    for k, name in enumerate(kinds):
        cols = np.flatnonzero(kind == k)
        m = cols.size
        if name == "edges":
            vals[:, cols] = _EDGE_VALUES[rng.integers(0, 6, (n_views, m, 3))]
        elif name == "split":
            half = rng.integers(1, n_views // 2 + 1, m) if n_views >= 2 else np.zeros(m, int)
            # A random order of the views in each column.
            rank = np.argsort(rng.random((n_views, m), dtype=np.float32), axis=0)
            lower = rng.integers(0, 15, (m, 3))
            upper = rng.integers(lower + 1, 16)
            bins = np.where((rank >= half)[..., None], upper, lower)
            vals[:, cols] = bins * 16 + rng.integers(0, 16, (n_views, m, 3))
            valid[:, cols] = rank < 2 * half
        elif name == "none":
            valid[:, cols] = False
        elif name == "one":
            valid[:, cols] = np.arange(n_views)[:, None] == rng.integers(0, n_views, m)
        elif name == "full":
            valid[:, cols] = True
        elif name == "constant":
            valid[:, cols] = True
            vals[:, cols] = _EDGE_VALUES[rng.integers(0, 6, (m, 3))]
        elif name != "uniform":
            raise ValueError(f"unknown column kind {name!r}")
    words = np.full((n_views, n), 1 << 24, np.int32)
    for c in range(3):
        words |= vals[..., c].astype(np.int32) << (8 * c)
    words[~valid] = 0
    return words
