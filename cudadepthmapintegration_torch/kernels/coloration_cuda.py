"""Coloration gather kernel (``csrc/coloration.cu``) and its plain version.

:func:`gather_colors` projects every vertex into every view and samples the
view's colour image there. It replaces the Pallas kernel
``_colorize_kernel`` of
``cudadepthmapintegration_tpu/kernels/coloration_pallas.py`` and keeps the
contract of ``gather_colors_pallas``: samples (V, N, 3) uint8 and valid
(V, N) bool, with 0 in every channel of an invalid sample.

Dispatch: CPU tensors go to :func:`gather_colors_torch`, the plain PyTorch
version; CUDA tensors launch the kernel or raise. Nothing falls back.

Both versions compute, per (vertex, view), bit for bit alike:

* ``hom_r = ((p_r0 * x + p_r1 * y) + p_r2 * z) + p_r3`` with no fused
  multiply-add;
* ``u, v = round_half_away(h0 / h2, h1 / h2)`` with IEEE division;
* valid when ``0 <= u < w`` and ``0 <= v < h`` (view 0's size) and, only
  under ``z_test``, ``h2 > 0``. The reference has no z test.
"""

from __future__ import annotations

import torch

from .integrate_cuda import round_half_away

__all__ = ["gather_colors", "gather_colors_torch", "launches", "project_points"]

# Kernel launches by gather_colors since the counter was last set to 0.
launches = 0


def _check_args(points, proj, colors):
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(points.shape)}")
    if colors.dim() != 4 or colors.shape[3] != 3 or colors.dtype != torch.uint8:
        raise ValueError(
            f"colors must be (V, h, w, 3) uint8, got {tuple(colors.shape)} {colors.dtype}"
        )
    if tuple(proj.shape) != (colors.shape[0], 3, 4):
        raise ValueError(
            f"proj has shape {tuple(proj.shape)}, expected {(colors.shape[0], 3, 4)}"
        )
    if proj.dtype != points.dtype:
        raise ValueError(f"proj is {proj.dtype}, the points {points.dtype}")
    for name, t in (("proj", proj), ("colors", colors)):
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, the points on {points.device}")


def project_points(
    points: torch.Tensor, proj: torch.Tensor, h: int, w: int, z_test: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project (N, 3) points through (V, 3, 4) rows of ``K4 @ RT``.

    Returns the pixel index ``v * w + u`` (V, N) int64 (0 where invalid),
    the validity mask (V, N) and the homogeneous z (V, N)."""
    x, y, z = (points[None, :, c] for c in range(3))  # (1, N)
    p = proj[:, :, :, None]  # (V, 3, 4, 1)
    hom = [((p[:, r, 0] * x + p[:, r, 1] * y) + p[:, r, 2] * z) + p[:, r, 3]
           for r in range(3)]  # each (V, N)
    u = round_half_away(hom[0] / hom[2])
    v = round_half_away(hom[1] / hom[2])
    valid = (u >= 0) & (v >= 0) & (u < w) & (v < h)
    if z_test:
        valid &= hom[2] > 0
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    ui = torch.where(valid, u, zero).to(torch.int64)
    vi = torch.where(valid, v, zero).to(torch.int64)
    return vi * w + ui, valid, hom[2]


def gather_colors_torch(
    points: torch.Tensor,
    proj: torch.Tensor,
    colors: torch.Tensor,
    z_test: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, any float dtype and device.

    ``points`` (N, 3), ``proj`` (V, 3, 4) rows of ``K4 @ RT``, ``colors``
    (V, h, w, 3) uint8. Returns samples (V, N, 3) uint8 and valid (V, N)."""
    _check_args(points, proj, colors)
    n_views, h, w, _ = colors.shape
    idx, valid, _ = project_points(points, proj, h, w, z_test)
    samples = torch.take_along_dim(colors.reshape(n_views, h * w, 3), idx[..., None], dim=1)
    samples *= valid[..., None]
    return samples, valid


def gather_colors(
    points: torch.Tensor,
    proj: torch.Tensor,
    colors: torch.Tensor,
    z_test: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Samples (V, N, 3) uint8 and valid (V, N) bool of every (vertex, view).

    CPU tensors run :func:`gather_colors_torch`. CUDA tensors launch the
    kernel of ``csrc/coloration.cu`` on the current stream and count it in
    :data:`launches`; points and proj must be float32, and every input
    contiguous and on one device."""
    global launches
    if points.device.type == "cpu":
        return gather_colors_torch(points, proj, colors, z_test)
    if points.device.type != "cuda":
        raise ValueError(f"no coloration kernel for device {points.device}")
    _check_args(points, proj, colors)
    if points.dtype != torch.float32:
        raise ValueError(f"the coloration kernel takes float32, got {points.dtype}")
    for name, t in (("points", points), ("proj", proj), ("colors", colors)):
        if not t.is_contiguous():
            raise ValueError(f"the coloration kernel needs a contiguous {name}")
    n_views, h, w, _ = colors.shape
    n = points.shape[0]
    if n_views > 65535:
        raise ValueError(f"{n_views} views exceed the launch grid")
    samples = torch.empty((n_views, n, 3), dtype=torch.uint8, device=points.device)
    valid = torch.empty((n_views, n), dtype=torch.bool, device=points.device)
    from ._build import check, load_library

    lib = load_library()
    dev = points.device.index  # always set on a CUDA tensor
    # The library sets the device it launches on; the guard restores the
    # caller's current device afterwards.
    with torch.cuda.device(dev):
        err = lib.cdmi_gather_colors(
            points.data_ptr(), proj.data_ptr(), colors.data_ptr(),
            samples.data_ptr(), valid.data_ptr(), n, n_views, h, w, int(z_test),
            dev, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "cdmi_gather_colors")
    launches += 1
    return samples, valid
