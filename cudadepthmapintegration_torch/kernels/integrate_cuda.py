"""TSDF integration kernel (``csrc/integrate.cu``) and its plain version.

:func:`integrate_views` adds the ray-potential contributions of a batch of
views into a cell volume, in place. It replaces the Pallas kernels
``_integrate_kernel_v2`` and ``_integrate_kernel_hbm`` of
``cudadepthmapintegration_tpu/kernels/integrate_pallas.py``.

Dispatch: a CPU volume goes to :func:`integrate_views_torch`, the plain
PyTorch version of the same function; a CUDA volume launches the kernel or
raises. Nothing falls back from one to the other.

Both versions follow the Pallas order of operations at ``view_block=1``,
so on the same inputs they agree bit for bit:

* ``hom_r = ty_r + (tx_r + (tz_r + tc_r))`` for the four table rows;
* ``u, v = round_half_away(h0 / h2, h1 / h2)`` with IEEE division;
* a sample is valid when ``h2 >= 0``, ``0 <= u < w``, ``0 <= v < h`` and
  ``depth[v, u] != -1``;
* views are added into each voxel one at a time, in the order given, and an
  invalid sample adds ``+0.0``.
"""

from __future__ import annotations

import torch

from ..core.ray_potential import RayPotential, ray_potential_torch

__all__ = ["integrate_views", "integrate_views_torch", "launches"]

# Kernel launches by integrate_views since the counter was last set to 0.
launches = 0

# Voxels per slab of the plain version: bounds its temporaries (a dozen
# volume-sized arrays) without changing a single value.
_PLAIN_SLAB_VOXELS = 1 << 24


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C ``round()``: halfway cases away from zero, as
    ``sign(x) * floor(|x| + 0.5)`` (``integrate_pallas.py:207``)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _check_args(volume, tx, ty, tz, tc, depths):
    if volume.dim() != 3:
        raise ValueError(f"volume must be (cz, cy, cx), got {tuple(volume.shape)}")
    if depths.dim() != 3:
        raise ValueError(f"depths must be (V, h, w), got {tuple(depths.shape)}")
    n_views = depths.shape[0]
    cz, cy, cx = volume.shape
    want = {
        "tx": (n_views, 4, cx), "ty": (n_views, 4, cy),
        "tz": (n_views, 4, cz), "tc": (n_views, 4),
    }
    for (name, shape), t in zip(want.items(), (tx, ty, tz, tc)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in zip(("tx", "ty", "tz", "tc", "depths"), (tx, ty, tz, tc, depths)):
        if t.device != volume.device:
            raise ValueError(f"{name} is on {t.device}, the volume on {volume.device}")
        if t.dtype != volume.dtype:
            raise ValueError(f"{name} is {t.dtype}, the volume {volume.dtype}")


def integrate_views_torch(
    volume: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    tz: torch.Tensor,
    tc: torch.Tensor,
    depths: torch.Tensor,
    params: RayPotential,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, any float dtype and device.

    ``volume`` (cz, cy, cx) is updated in place and returned; ``tx`` (V,4,cx),
    ``ty`` (V,4,cy), ``tz`` (V,4,cz), ``tc`` (V,4) are the projection tables
    of ``ops.integrate.projection_tables`` and ``depths`` (V,h,w) the maps.
    """
    _check_args(volume, tx, ty, tz, tc, depths)
    n_views, h, w = depths.shape
    _, cy, cx = volume.shape
    flat_depths = depths.reshape(n_views, h * w)
    zero = torch.zeros((), dtype=volume.dtype, device=volume.device)
    kz = max(1, _PLAIN_SLAB_VOXELS // (cy * cx))
    for k0 in range(0, volume.shape[0], kz):
        acc = volume[k0 : k0 + kz]
        for view in range(n_views):
            zc = tz[view, :, k0 : k0 + kz] + tc[view][:, None]  # (4, kz)
            hom = [
                ty[view, r][None, :, None]
                + (tx[view, r][None, None, :] + zc[r][:, None, None])
                for r in range(4)
            ]
            u = round_half_away(hom[0] / hom[2])
            v = round_half_away(hom[1] / hom[2])
            valid = (hom[2] >= 0) & (u >= 0) & (v >= 0) & (u < w) & (v < h)
            ui = torch.where(valid, u, zero).to(torch.int64)
            vi = torch.where(valid, v, zero).to(torch.int64)
            d = flat_depths[view][vi * w + ui]
            valid &= d != -1.0
            acc += torch.where(valid, ray_potential_torch(hom[3], d, params), zero)
    return volume


def integrate_views(
    volume: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    tz: torch.Tensor,
    tc: torch.Tensor,
    depths: torch.Tensor,
    params: RayPotential,
) -> torch.Tensor:
    """Add the views' contributions into ``volume`` in place and return it.

    A CPU volume runs :func:`integrate_views_torch`. A CUDA volume launches
    the kernel of ``csrc/integrate.cu`` on the current stream (one launch
    for all views of the call) and counts it in :data:`launches`; it must be
    float32 and contiguous, with every input on the same device.
    """
    global launches
    if volume.device.type == "cpu":
        return integrate_views_torch(volume, tx, ty, tz, tc, depths, params)
    if volume.device.type != "cuda":
        raise ValueError(f"no integrate kernel for device {volume.device}")
    _check_args(volume, tx, ty, tz, tc, depths)
    if volume.dtype != torch.float32:
        raise ValueError(f"the integrate kernel takes float32, got {volume.dtype}")
    for name, t in zip(("volume", "tx", "ty", "tz", "tc", "depths"),
                       (volume, tx, ty, tz, tc, depths)):
        if not t.is_contiguous():
            raise ValueError(f"the integrate kernel needs a contiguous {name}")
    n_views, h, w = depths.shape
    cz, cy, cx = volume.shape
    if cz > 65535 or -(-cy // 8) > 65535:
        raise ValueError(f"volume {tuple(volume.shape)} exceeds the launch grid")
    from ._build import check, load_library

    lib = load_library()
    s = params.scalars()
    dev = volume.device.index  # always set on a CUDA tensor
    # The library sets the device it launches on; the guard restores the
    # caller's current device afterwards.
    with torch.cuda.device(dev):
        err = lib.cdmi_integrate(
            volume.data_ptr(), tx.data_ptr(), ty.data_ptr(), tz.data_ptr(),
            tc.data_ptr(), depths.data_ptr(), n_views, cz, cy, cx, h, w,
            s["thick"], s["rho"], s["delta"], s["rho_over_thick"],
            s["neg_eta_rho"], dev, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "cdmi_integrate")
    launches += 1
    return volume
