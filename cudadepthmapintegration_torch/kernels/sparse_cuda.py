"""Sparse RGB-D update kernel (``csrc/sparse_fuse.cu``) and its plain versions.

:func:`sparse_fuse` adds one frame into the touched blocks of a sparse
block pool, in place: the ray potential into ``pool`` and, with colour, the
proximity-weighted RGB into ``color_pool`` and the weight into
``weight_pool``. It replaces the Pallas point gather ``_gather_kernel`` of
``cudadepthmapintegration_tpu/kernels/gather_points.py`` together with the
per-frame device work around it (``_sparse_integrate`` and
``_sparse_accumulate_color`` of ``ops/sparse_grid.py``): on Hopper the gather
is fused into the update.

Dispatch: CPU tensors go to the plain PyTorch versions
:func:`sparse_fuse_torch` and :func:`sparse_accumulate_color_torch`, which
read pixels through :func:`gather_pixels_torch` (the counterpart of the
Pallas gather itself); CUDA tensors launch the kernel or raise. Nothing
falls back from one to the other.

Both follow the JAX order of operations, so on the same inputs they agree
bit for bit:

* per block, ``base_r = ((P[r,0]*ox + P[r,1]*oy) + P[r,2]*oz) + P[r,3]``;
  per voxel, ``h_r = ((base_r + P[r,2]*az[k]) + P[r,1]*ay[j]) + P[r,0]*ax[i]``,
  every product and sum rounded once (no fused multiply-add);
* ``u, v = round_half_away(h0 / h2, h1 / h2)`` with IEEE division; a sample
  is valid when ``h2 >= 0``, ``0 <= u < w``, ``0 <= v < h`` and
  ``depth[v, u] != -1``; an invalid sample adds ``+0.0``;
* colour: ``wadd = valid ? max(0, 1 - |zcam - d| / band) : 0``, and the pools
  add ``rgb * wadd`` and ``wadd``.
"""

from __future__ import annotations

import torch

from ..core.ray_potential import RayPotential, ray_potential_torch
from .integrate_cuda import round_half_away

__all__ = [
    "gather_pixels_torch",
    "launches",
    "sparse_accumulate_color_torch",
    "sparse_fuse",
    "sparse_fuse_torch",
]

# Kernel launches by sparse_fuse since the counter was last set to 0.
launches = 0


def gather_pixels_torch(
    planes: tuple[torch.Tensor, ...], ui: torch.Tensor, vi: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """``plane[vi, ui]`` for every (h, w) plane at shared (N,) indices, and
    ``-1.0`` where ``ui < 0`` (the contract of ``gather_pixels_pallas``).
    Valid entries must satisfy ``0 <= vi < h`` and ``0 <= ui < w``."""
    w = planes[0].shape[1]
    valid = ui >= 0
    idx = torch.where(valid, vi, 0).long() * w + torch.where(valid, ui, 0).long()
    return tuple(torch.where(valid, p.reshape(-1)[idx], -1.0) for p in planes)


def _project(origins, proj_rows, axes, block_shape, h, w):
    """Pixel indices and camera z of every voxel of the (B,) blocks.

    Returns ui, vi (B, bz, by, bx) int32 (``ui = -1`` where the projection
    misses the image, ``vi = 0`` there) and zcam (B, bz, by, bx)."""
    bz, by, bx = block_shape

    def lattice(r):
        p = proj_rows[r]
        base = ((p[0] * origins[:, 0] + p[1] * origins[:, 1])
                + p[2] * origins[:, 2]) + p[3]
        return (
            (base[:, None, None, None] + (p[2] * axes[2, :bz])[None, :, None, None])
            + (p[1] * axes[1, :by])[None, None, :, None]
        ) + (p[0] * axes[0, :bx])[None, None, None, :]

    h0, h1, h2, zcam = (lattice(r) for r in range(4))
    u = round_half_away(h0 / h2)
    v = round_half_away(h1 / h2)
    valid = (h2 >= 0) & (u >= 0) & (v >= 0) & (u < w) & (v < h)
    ui = torch.where(valid, u, -1.0).to(torch.int32)
    vi = torch.where(valid, v, 0.0).to(torch.int32)
    return ui, vi, zcam


def _block_shape(pool: torch.Tensor) -> tuple[int, int, int]:
    return tuple(pool.shape[1:4])


def sparse_fuse_torch(
    pool: torch.Tensor,
    slots: torch.Tensor,
    origins: torch.Tensor,
    proj_rows: torch.Tensor,
    axes: torch.Tensor,
    depth: torch.Tensor,
    params: RayPotential,
) -> torch.Tensor:
    """Plain version of the TSDF part: ``pool[slots] +=`` the masked ray
    potential of every voxel of the blocks. ``pool`` (cap, bz, by, bx),
    ``slots`` (B,) unique, ``origins`` (B, 3) world xyz of the blocks,
    ``proj_rows`` (4, 4) rows 0..2 of ``K4 @ RT`` and the camera-z row,
    ``axes`` (3, bmax) voxel-centre offsets along x, y, z, ``depth`` (h, w).
    Updates ``pool`` in place and returns it."""
    h, w = depth.shape
    ui, vi, zcam = _project(origins, proj_rows, axes, _block_shape(pool), h, w)
    (d,) = gather_pixels_torch((depth,), ui.reshape(-1), vi.reshape(-1))
    d = d.reshape(zcam.shape)
    valid = (ui >= 0) & (d != -1.0)
    zero = torch.zeros((), dtype=pool.dtype, device=pool.device)
    idx = slots.long()
    pool[idx] = pool[idx] + torch.where(valid, ray_potential_torch(zcam, d, params), zero)
    return pool


def sparse_accumulate_color_torch(
    color_pool: torch.Tensor,
    weight_pool: torch.Tensor,
    slots: torch.Tensor,
    origins: torch.Tensor,
    proj_rows: torch.Tensor,
    axes: torch.Tensor,
    depth: torch.Tensor,
    rgb: torch.Tensor,
    band: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the colour part: voxels within ``band`` of this
    frame's surface add the pixel's RGB weighted by the linear falloff
    ``1 - |zcam - depth| / band`` into ``color_pool`` (cap, bz, by, bx, 3),
    and the weight into ``weight_pool`` (cap, bz, by, bx). ``rgb`` is the
    (h, w, 3) uint8 image; the other arguments as :func:`sparse_fuse_torch`.
    Updates both pools in place and returns them."""
    h, w = depth.shape
    ui, vi, zcam = _project(origins, proj_rows, axes, _block_shape(weight_pool), h, w)
    channels = tuple(rgb[..., c].to(torch.float32) for c in range(3))
    d, *cols = gather_pixels_torch((depth, *channels), ui.reshape(-1), vi.reshape(-1))
    d = d.reshape(zcam.shape)
    rgb_s = torch.stack([torch.clamp_min(c.reshape(zcam.shape), 0.0) for c in cols], dim=-1)
    near = (ui >= 0) & (d != -1.0)
    band_t = torch.tensor(band, dtype=zcam.dtype, device=zcam.device)
    falloff = torch.clamp_min(1.0 - torch.abs(zcam - d) / band_t, 0.0)
    wadd = torch.where(near, falloff, torch.zeros((), dtype=zcam.dtype, device=zcam.device))
    idx = slots.long()
    color_pool[idx] = color_pool[idx] + rgb_s * wadd[..., None]
    weight_pool[idx] = weight_pool[idx] + wadd
    return color_pool, weight_pool


def _check_args(pool, slots, origins, proj_rows, axes, depth, color):
    if pool.dim() != 4:
        raise ValueError(f"pool must be (capacity, bz, by, bx), got {tuple(pool.shape)}")
    bz, by, bx = _block_shape(pool)
    n = slots.shape[0]
    for name, t, shape in (("slots", slots, (n,)), ("origins", origins, (n, 3)),
                           ("proj_rows", proj_rows, (4, 4))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if axes.dim() != 2 or axes.shape[0] != 3 or axes.shape[1] < max(bz, by, bx):
        raise ValueError(f"axes must be (3, >= {max(bz, by, bx)}), got {tuple(axes.shape)}")
    if depth.dim() != 2:
        raise ValueError(f"depth must be (h, w), got {tuple(depth.shape)}")
    tensors = {"slots": slots, "origins": origins, "proj_rows": proj_rows,
               "axes": axes, "depth": depth}
    if color is not None:
        color_pool, weight_pool, rgb = color
        if tuple(weight_pool.shape) != tuple(pool.shape):
            raise ValueError(f"weight_pool has shape {tuple(weight_pool.shape)}, "
                             f"expected {tuple(pool.shape)}")
        if tuple(color_pool.shape) != (*pool.shape, 3):
            raise ValueError(f"color_pool has shape {tuple(color_pool.shape)}, "
                             f"expected {(*pool.shape, 3)}")
        if tuple(rgb.shape) != (*depth.shape, 3) or rgb.dtype != torch.uint8:
            raise ValueError(f"rgb must be (h, w, 3) uint8, got {tuple(rgb.shape)} {rgb.dtype}")
        tensors.update(color_pool=color_pool, weight_pool=weight_pool, rgb=rgb)
    for name, t in tensors.items():
        if t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {pool.device}")
    return tensors


def sparse_fuse(
    pool: torch.Tensor,
    slots: torch.Tensor,
    origins: torch.Tensor,
    proj_rows: torch.Tensor,
    axes: torch.Tensor,
    depth: torch.Tensor,
    params: RayPotential,
    color_pool: torch.Tensor | None = None,
    weight_pool: torch.Tensor | None = None,
    rgb: torch.Tensor | None = None,
    band: float = 0.0,
) -> None:
    """Fuse one frame into the blocks at ``slots``, in place.

    With ``rgb`` (h, w, 3) uint8, ``color_pool`` and ``weight_pool`` also
    accumulate colour within ``band`` of the surface. CPU tensors run
    :func:`sparse_fuse_torch` (and :func:`sparse_accumulate_color_torch`).
    CUDA tensors launch the kernel of ``csrc/sparse_fuse.cu`` once on the
    current stream and count it in :data:`launches`; they must be float32
    (``slots`` int32, ``rgb`` uint8), contiguous and on one device, and the
    slots unique.
    """
    global launches
    color = None if rgb is None else (color_pool, weight_pool, rgb)
    if rgb is not None and (color_pool is None or weight_pool is None):
        raise ValueError("rgb needs color_pool and weight_pool")
    if pool.device.type == "cpu":
        _check_args(pool, slots, origins, proj_rows, axes, depth, color)
        sparse_fuse_torch(pool, slots, origins, proj_rows, axes, depth, params)
        if color is not None:
            sparse_accumulate_color_torch(color_pool, weight_pool, slots, origins,
                                          proj_rows, axes, depth, rgb, band)
        return
    if pool.device.type != "cuda":
        raise ValueError(f"no sparse fuse kernel for device {pool.device}")
    tensors = _check_args(pool, slots, origins, proj_rows, axes, depth, color)
    tensors["pool"] = pool
    for name, t in tensors.items():
        want = {"slots": torch.int32, "rgb": torch.uint8}.get(name, torch.float32)
        if t.dtype != want:
            raise ValueError(f"the sparse fuse kernel takes {name} as {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the sparse fuse kernel needs a contiguous {name}")
    from ._build import check, load_library

    lib = load_library()
    bz, by, bx = _block_shape(pool)
    h, w = depth.shape
    s = params.scalars()
    dev = pool.device.index  # always set on a CUDA tensor

    def ptr(name):
        return tensors[name].data_ptr() if name in tensors else None

    # The library sets the device it launches on; the guard restores the
    # caller's current device afterwards.
    with torch.cuda.device(dev):
        err = lib.cdmi_sparse_fuse(
            pool.data_ptr(), slots.data_ptr(), origins.data_ptr(), proj_rows.data_ptr(),
            axes.data_ptr(), depth.data_ptr(), ptr("rgb"), ptr("color_pool"),
            ptr("weight_pool"), slots.shape[0], bz, by, bx, axes.shape[1], h, w,
            s["thick"], s["rho"], s["delta"], s["rho_over_thick"], s["neg_eta_rho"],
            float(band), dev, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "cdmi_sparse_fuse")
    launches += 1
