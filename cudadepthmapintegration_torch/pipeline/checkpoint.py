"""Checkpoint / resume for (sharded) fusion runs.

The reference has no in-process checkpointing, but its design is resumable by
construction: the accumulated grid is a pure sum and ``d_outScalar`` is
seeded from the input scalars (``CudaReconstruction.cu:324-327``), so
"resume" = re-feed a prior grid and keep adding views. This module makes
that a first-class artifact: the volume, the fused-view count, and the full
grid/ray-potential configuration are saved together so a resumed run can
(a) verify it is continuing the same reconstruction and (b) know which
views remain.

The file is the JAX package's format, version 1 (an ``.npz`` holding
``volume``, ``grid_matrix`` and ``meta``, JSON as uint8): a checkpoint
written by either package loads in the other. Host-side numpy only.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential

__all__ = ["FusionCheckpoint", "save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 1


@dataclasses.dataclass
class FusionCheckpoint:
    volume: np.ndarray  # (cz, cy, cx) fused scalars
    views_fused: int
    grid: VoxelGrid
    params: RayPotential
    fused_view_names: list[str] = dataclasses.field(default_factory=list)
    # Free-form JSON-serializable bookkeeping saved ATOMICALLY with the
    # volume (e.g. the runner's completed-unit set — keeping it inside the
    # .npz removes the crash window a separate manifest file would have).
    extra: dict = dataclasses.field(default_factory=dict)

    def matches(self, grid: VoxelGrid, params: RayPotential) -> bool:
        return (
            self.grid.dims == grid.dims
            and np.allclose(self.grid.origin, grid.origin)
            and np.allclose(self.grid.spacing, grid.spacing)
            and np.allclose(self.grid.matrix, grid.matrix)
            and self.params.astuple() == params.astuple()
        )


def save_checkpoint(path: str, ckpt: FusionCheckpoint) -> None:
    """Atomic save: write to a temp file then rename."""
    meta = {
        "format_version": _FORMAT_VERSION,
        "views_fused": int(ckpt.views_fused),
        "grid": {
            "dims": list(ckpt.grid.dims),
            "origin": list(ckpt.grid.origin),
            "spacing": list(ckpt.grid.spacing),
        },
        "params": {
            "thick": ckpt.params.thick,
            "rho": ckpt.params.rho,
            "eta": ckpt.params.eta,
            "delta": ckpt.params.delta,
        },
        "fused_view_names": ckpt.fused_view_names,
        "extra": ckpt.extra,
    }
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        volume=ckpt.volume,
        grid_matrix=ckpt.grid.matrix,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )
    # np.savez appends .npz when missing.
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def load_checkpoint(path: str) -> FusionCheckpoint:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('format_version')}"
            )
        grid = VoxelGrid(
            dims=tuple(meta["grid"]["dims"]),
            origin=tuple(meta["grid"]["origin"]),
            spacing=tuple(meta["grid"]["spacing"]),
            matrix=z["grid_matrix"],
        )
        params = RayPotential(**meta["params"])
        return FusionCheckpoint(
            volume=z["volume"].copy(),
            views_fused=meta["views_fused"],
            grid=grid,
            params=params,
            fused_view_names=list(meta.get("fused_view_names", [])),
            extra=dict(meta.get("extra", {})),
        )
