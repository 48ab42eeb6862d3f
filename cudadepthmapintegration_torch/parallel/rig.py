"""Rig-aware shard-axis selection.

Counterpart of the JAX package's ``parallel/rig.py``, host numpy math
ported as it is. The z-slab decomposition (``ShardedTSDFIntegrator``)
cuts the volume along its z axis. The JAX package measured on its TPU
kernel that a rig looking ALONG the sharded axis runs slower than one
looking across it; ``shard_axis="auto"`` relabels the grid's axes so
grid-z becomes the axis the cameras look along LEAST, fuses on the
relabeled grid, and transposes the fused volume back. The relabeling is
an exact permutation (the grid matrix absorbs a 0/1 column permutation;
origins and spacings are reordered), so the fused volume holds the same
values — only the memory layout (and therefore the shard axis) changes.

**Knife-edge caveat.** "Exact permutation" holds for every table VALUE,
but the integrators sum the separable projection in LAYOUT-axis order,
and fp addition is not associative — relabeling regroups the sum. The
regrouped ``hom`` can differ by ~1 ulp, which flips
``round(hom.xy/hom.z)`` ONLY when a projection lands exactly on a
half-pixel boundary. Real rigs essentially never do; synthetic scenes
built on exact decimal lattices can (the JAX package measured 37 of 1.5M
projected pixels for origin (-1.6,)*3, spacing 0.2 and a top-down orbit,
and zero with the origin offset to (-1.63, -1.61, -1.59)). Tests pin
bit-identity on non-knife-edge geometry.

Replaces nothing in the reference (`Reconstruction/CudaReconstruction.cu`
is single-GPU and layout-fixed); this is scale-out machinery.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import VoxelGrid

__all__ = [
    "best_shard_grid_axis",
    "permute_grid_axes",
    "permute_volume",
    "unpermute_volume",
    "grid_for_sharding",
    "rig_cameras",
]


def _axis_scores(grid: VoxelGrid, cameras) -> np.ndarray:
    """Summed |view-direction| component per grid axis over the rig
    (row 2 of ``RT @ grid_matrix`` is the camera's viewing direction in
    grid coordinates)."""
    score = np.zeros(3, dtype=np.float64)
    for cam in cameras:
        rot = (cam.rt @ grid.matrix)[:3, :3]
        score += np.abs(rot[2])
    return score


def rig_cameras(views, max_samples: int | None = 64):
    """Cameras of a rig WITHOUT decoding depth frames where avoidable.

    - objects with a ``cameras()`` method (``DepthMapDataset`` and the
      TUM/ScanNet readers) return Camera objects from pose/calibration
      data alone;
    - other sequences are stride-sampled to at most ``max_samples``
      frame decodes (the axis choice is a rig-level heuristic; an even
      subsample scores it identically for any coherent trajectory).
      Pass ``max_samples=None`` to score EVERY frame — frame-order
      independent, at the cost of decoding each one (useful for rigs
      with non-uniform trajectories, e.g. a long top-down segment
      followed by orbit frames);
    - bare iterables are consumed (callers wanting streaming must pass a
      sequence or dataset).
    """
    if hasattr(views, "cameras"):
        return list(views.cameras())
    if hasattr(views, "__getitem__") and hasattr(views, "__len__"):
        n = len(views)
        step = 1 if max_samples is None else max(1, -(-n // max_samples))
        return [views[i].camera for i in range(0, n, step)]
    return [v.camera for v in views]


def best_shard_grid_axis(
    grid: VoxelGrid, views, max_samples: int | None = 64
) -> int:
    """Grid axis (0=x, 1=y, 2=z) the cameras look along LEAST — the axis
    whose pinning to the kernel's k step hurts least. ``max_samples``
    bounds frame decodes for plain sequences (see :func:`rig_cameras`)."""
    return int(
        np.argmin(_axis_scores(grid, rig_cameras(views, max_samples)))
    )


def permute_grid_axes(grid: VoxelGrid, perm: tuple[int, int, int]) -> VoxelGrid:
    """Relabel grid axes: new grid axis ``i`` is old grid axis ``perm[i]``.

    Voxel-center world positions are preserved EXACTLY: the new matrix is
    ``matrix @ P`` where ``P`` is the 0/1 permutation taking new-frame
    coordinates to old-frame coordinates, and dims/origin/spacing are
    reordered — no floating-point arithmetic is introduced, so fusion on
    the permuted grid is bit-identical to the original modulo layout.
    """
    if sorted(perm) != [0, 1, 2]:
        raise ValueError(f"perm must be a permutation of (0, 1, 2), got {perm}")
    p4 = np.zeros((4, 4), dtype=np.float64)
    for new_ax, old_ax in enumerate(perm):
        p4[old_ax, new_ax] = 1.0
    p4[3, 3] = 1.0
    return VoxelGrid(
        dims=tuple(grid.dims[a] for a in perm),
        origin=tuple(grid.origin[a] for a in perm),
        spacing=tuple(grid.spacing[a] for a in perm),
        matrix=grid.matrix @ p4,
    )


def _transpose(volume, order):
    """Axis permutation of a numpy array or a torch tensor (a view)."""
    if isinstance(volume, torch.Tensor):
        return volume.permute(order)
    return volume.transpose(order)


def permute_volume(volume, perm: tuple[int, int, int]):
    """Transpose a canonical (z, y, x) volume into the layout of the grid
    permuted by ``perm`` (inverse of :func:`unpermute_volume`) — e.g. to
    seed a resume volume into a permuted-grid integrator. Works on numpy
    arrays and torch tensors."""
    # New volume axis i holds old grid axis perm[2-i]; the original volume
    # keeps old grid axis a on volume axis 2-a.
    order = tuple(2 - perm[2 - i] for i in range(3))
    return _transpose(volume, order)


def unpermute_volume(volume, perm: tuple[int, int, int]):
    """Transpose a (z', y', x') volume fused on the permuted grid back to
    the original grid's canonical (z, y, x) layout.

    Works on numpy arrays and torch tensors (a transposed view; on a
    device it stays there).
    """
    # Volume axis v holds grid axis 2-v; new volume axis i holds old grid
    # axis perm[2-i]. Original volume axis j needs old grid axis 2-j.
    inv = [0, 0, 0]
    for new_ax, old_ax in enumerate(perm):
        inv[old_ax] = new_ax
    order = tuple(2 - inv[2 - j] for j in range(3))
    return _transpose(volume, order)


def grid_for_sharding(
    grid: VoxelGrid,
    views,
    n_shards: int | None = None,
    max_samples: int | None = 64,
) -> tuple[VoxelGrid, tuple[int, int, int]]:
    """Relabeled grid whose z axis is the rig's least-looked-along axis.

    Returns ``(permuted_grid, perm)``; fuse/shard on ``permuted_grid``
    (z-slab sharding now cuts the friendly axis) and map results back
    with ``unpermute_volume(vol, perm)``. If z is already optimal the
    grid is returned unchanged with the identity perm.

    ``n_shards`` (the z mesh-axis size) restricts the choice to axes
    whose CELL count divides it — the slab decomposition's hard
    requirement — falling back to the next-best axis, so 'auto' never
    turns a shardable grid into a ``ValueError`` purely on rig geometry.
    With no divisible axis the grid is returned unchanged (the caller
    fails exactly as an explicit ``shard_axis='z'`` would).

    ``max_samples``: frame-decode cap for plain sequences; ``None``
    scores every frame (see :func:`rig_cameras`).
    """
    scores = _axis_scores(grid, rig_cameras(views, max_samples))
    # cells per GRID axis (volume_shape is (cz, cy, cx) z-major).
    cells = (grid.volume_shape[2], grid.volume_shape[1], grid.volume_shape[0])
    for axis in np.argsort(scores, kind="stable"):
        axis = int(axis)
        if n_shards is not None and cells[axis] % n_shards:
            continue
        if axis == 2:
            return grid, (0, 1, 2)
        # Swap the chosen axis with z; keep the other two in order.
        perm = [0, 1, 2]
        perm[axis], perm[2] = perm[2], perm[axis]
        perm = tuple(perm)
        return permute_grid_axes(grid, perm), perm
    return grid, (0, 1, 2)
