"""Halo exchange + sharded cell->point conversion.

Marching cubes needs point-scalar values, and a grid point's value averages
the up-to-8 cells around it (``vtkCellDataToPointData`` semantics, used at
``Reconstruction/main.cxx:150-155``). Under z-slab sharding each shard needs
its z-neighbours' boundary cell plane — a 1-deep halo exchange. The JAX
package does it with ``ppermute`` over the ``z`` mesh axis; here it is one
``.to(device)`` copy of one (cy, cx) plane per shard per direction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cell_to_point import _axis_counts, _shifted_sum
from .mesh import DeviceMesh

__all__ = ["sharded_cell_to_point", "exchange_z_halo"]


def exchange_z_halo(
    slabs: list[torch.Tensor],
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per shard, ``(below, above)``: the neighbour shards' boundary cell
    planes, (1, cy, cx) on this shard's device (zeros at the global ends)."""
    out = []
    for i, local in enumerate(slabs):
        zero = torch.zeros_like(local[:1])
        below = slabs[i - 1][-1:].to(local.device) if i > 0 else zero
        above = slabs[i + 1][:1].to(local.device) if i + 1 < len(slabs) else zero
        out.append((below, above))
    return out


def sharded_cell_to_point(
    slabs: list[torch.Tensor], mesh: DeviceMesh | None = None
) -> list[torch.Tensor]:
    """z-sharded (cz, cy, cx) cell scalars -> z-sharded (cz+1, cy+1, cx+1)
    point scalars, without gathering the volume.

    ``slabs`` are the z-slabs in order (e.g. ``ShardedTSDFIntegrator.slabs``
    of a contiguous layout); ``mesh`` is accepted for the JAX package's
    signature and not needed. Returns one block per shard on its device:
    shard ``s`` holds point planes ``[z0, z0 + bz)``, and the last shard
    also the final plane. ``torch.cat`` of the blocks equals
    ``ops.cell_to_point.cell_to_point`` of the gathered volume bit for bit:
    each point sums the same cells in the same order and divides by the
    same count.
    """
    del mesh
    cz = sum(s.shape[0] for s in slabs)
    blocks, z0 = [], 0
    for s, ((below, above), cells) in enumerate(zip(exchange_z_halo(slabs), slabs)):
        bz, cy, cx = cells.shape
        ext = torch.cat([below, cells, above])  # (bz+2, cy, cx)
        total = _shifted_sum(F.pad(ext, (1, 1, 1, 1)))  # points z0..z0+bz
        count = (
            _axis_counts(cz, total)[z0 : z0 + bz + 1, None, None]
            * _axis_counts(cy, total)[None, :, None]
            * _axis_counts(cx, total)[None, None, :]
        )
        block = total / count
        # Non-overlapping blocks: plane z0+bz belongs to the next shard,
        # except after the last one.
        blocks.append(block if s == len(slabs) - 1 else block[:bz])
        z0 += bz
    return blocks
