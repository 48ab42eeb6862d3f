"""Device mesh for multi-device fusion in one process.

The reference is strictly single-GPU (one CUDA kernel, sequential view loop —
``Reconstruction/CudaReconstruction.cu:330-331,343``). The JAX package scales
out over a named ``jax.sharding.Mesh`` driven by one controller; this is its
counterpart: a :class:`DeviceMesh` of ``torch.device`` entries with the same
two axes, driven by one process. A sharded volume is a list of per-shard
slabs, each on its shard's device, and the collectives become explicit
copies (a halo plane ``.to()`` the neighbour's device; a sum of partials in
``v`` order). Across processes, :mod:`.distributed` runs on
``torch.distributed``.

Axes:
  * ``z`` — spatial parallelism: the voxel grid is cut into z-slabs; each
    device integrates EVERY view against only its own slab, so fusion needs
    no volume collectives at all.
  * ``v`` — view parallelism: views are split and partial volumes summed;
    useful when the grid is small and views are many.

A device may appear more than once: ``make_mesh(n_z=4, devices=["cuda:0"] *
4)`` runs four z-slabs on one card, and ``devices=["cpu"] * 8`` stands in
for the JAX package's eight virtual CPU devices.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DeviceMesh", "make_mesh"]


def _device(d) -> torch.device:
    """``d`` as a torch.device, with a CUDA index always set (the kernels
    launch on ``device.index``)."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """An (n_z, n_v) grid of torch devices with axes ``("z", "v")``."""

    axis_names = ("z", "v")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be 2-D, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return {"z": self.devices.shape[0], "v": self.devices.shape[1]}

    def distinct_devices(self) -> list[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices.reshape(-1)))


def make_mesh(n_z: int | None = None, n_v: int = 1, devices=None) -> DeviceMesh:
    """Build a (z, v) mesh. Defaults to every CUDA device on the z axis.

    ``devices`` is any list of ``torch.device`` or device strings; entries
    may repeat. With no CUDA device and no ``devices`` this raises: there is
    no fallback to the CPU.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() needs a CUDA device, and none is available; "
                "pass devices= (e.g. ['cpu'] * 8) to build a mesh elsewhere"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_z is None:
        n_z = len(devices) // n_v
    if n_z < 1 or n_v < 1 or n_z * n_v > len(devices):
        raise ValueError(
            f"mesh {n_z}x{n_v} needs {n_z * n_v} devices, have {len(devices)}"
        )
    arr = np.empty(n_z * n_v, dtype=object)
    arr[:] = devices[: n_z * n_v]
    return DeviceMesh(arr.reshape(n_z, n_v))
