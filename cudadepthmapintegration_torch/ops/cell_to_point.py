"""Cell-data -> point-data averaging.

Equivalent of ``vtkCellDataToPointData`` as used at
``Reconstruction/main.cxx:150-155``: each grid point receives the arithmetic
mean of the values of the (1..8) cells incident to it. Eight shifted
slice-adds of a zero-padded volume, on the volume's device, in the same
order as the JAX version, so the two agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cell_to_point"]


def _axis_counts(n: int, like: torch.Tensor) -> torch.Tensor:
    """Incident cells per point along one axis of n cells: 1, 2, ..., 2, 1."""
    c = torch.full((n + 1,), 2, dtype=like.dtype, device=like.device)
    c[0] = c[-1] = 1
    return c


def cell_to_point(cell_volume: torch.Tensor) -> torch.Tensor:
    """(cz, cy, cx) cell scalars -> (cz+1, cy+1, cx+1) point scalars."""
    cz, cy, cx = cell_volume.shape
    v = F.pad(cell_volume, (1, 1, 1, 1, 1, 1))
    total = torch.zeros((cz + 1, cy + 1, cx + 1), dtype=v.dtype, device=v.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                total += v[dz : dz + cz + 1, dy : dy + cy + 1, dx : dx + cx + 1]
    # The count is a product of per-axis counts (exact small integers), the
    # same values the JAX version sums from a padded ones volume.
    count = (
        _axis_counts(cz, v)[:, None, None]
        * _axis_counts(cy, v)[None, :, None]
        * _axis_counts(cx, v)[None, None, :]
    )
    return total / count
