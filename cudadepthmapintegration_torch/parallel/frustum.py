"""Per-(view, z-slab) frustum tests for sharded fusion scheduling.

Under z-slab sharding every device integrates EVERY view against its
slab, even when the view's frustum misses the slab entirely — each such
view costs the shard an all-invalid pass of the kernel's view loop. The
test here is host-computable from the cameras alone (no depth data):
project the slab's axis-aligned bounding box corners through the view's
composed projection and reject views whose image-plane footprint cannot
intersect the image.

Conservativeness: a view is culled ONLY when provably invisible from the
slab — any corner at non-positive homogeneous z keeps the view (the
perspective image of the box is then unbounded), and the bbox test uses
the half-pixel rounding margins of the kernel's bounds test
(``CudaReconstruction.cu:183-197``: ``round(hom.xy/hom.z)`` in
``[0, w) x [0, h)``). Culled fusion is therefore EXACTLY unculled fusion
(pinned bitwise by the tests): a culled view contributes only zeros to
that slab.

The reference has no equivalent (single GPU, whole grid resident,
``CudaReconstruction.cu:326``). Host numpy math, ported from the JAX
package's ``parallel/frustum.py`` as it is.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import compose_projection
from ..core.grid import VoxelGrid

__all__ = ["slab_view_mask", "view_intersects_slab"]


def _slab_corners_grid_frame(grid: VoxelGrid, z0: int, z1: int) -> np.ndarray:
    """(8, 3) grid-frame corners of the OUTER bounds of cell-z range
    [z0, z1) — a superset of every cell center's position (centers sit at
    ``origin + (i+0.5)*spacing``), so the test stays conservative."""
    ox, oy, oz = grid.origin
    sx, sy, sz = grid.spacing
    cx, cy, _ = grid.cell_dims
    xs = (ox, ox + cx * sx)
    ys = (oy, oy + cy * sy)
    zs = (oz + z0 * sz, oz + z1 * sz)
    return np.array(
        [(x, y, z) for z in zs for y in ys for x in xs], np.float64
    )


def view_intersects_slab(
    camera, grid: VoxelGrid, z0: int, z1: int, h: int, w: int
) -> bool:
    """True unless the view provably cannot see any voxel of cell-z range
    [z0, z1): all 8 slab corners project (a) behind the camera, or (b) to
    an image bbox strictly outside ``[0, w) x [0, h)`` after the kernel's
    half-away rounding. Conservative in every degenerate case."""
    p_full, _ = compose_projection(camera, grid)
    corners = _slab_corners_grid_frame(grid, z0, z1)
    hom = corners @ p_full[:3, :3].T + p_full[:3, 3]
    z = hom[:, 2]
    if np.all(z < 0):
        return False  # entire slab behind the camera (hom.z < 0 rejection)
    if np.any(z <= 0):
        return True  # frustum plane crosses the slab: footprint unbounded
    u = hom[:, 0] / z
    v = hom[:, 1] / z
    # round-half-away(u) lands in [0, w) only for u in (-0.5, w - 0.5);
    # the interior of the box projects inside the corner convex hull.
    if u.max() <= -0.5 or u.min() >= w - 0.5:
        return False
    if v.max() <= -0.5 or v.min() >= h - 0.5:
        return False
    return True


def slab_view_mask(
    grid: VoxelGrid, views, n_shards: int, h: int | None = None,
    w: int | None = None,
) -> np.ndarray:
    """(n_shards, V) bool: ``mask[s, i]`` iff view i's frustum can touch
    shard s's contiguous z slab. ``h``/``w`` default to each view's own
    depth-map shape."""
    cz = grid.volume_shape[0]
    if cz % n_shards:
        raise ValueError(
            f"n_shards ({n_shards}) must divide the z cell count ({cz});"
            " pad the grid dims"
        )
    m = cz // n_shards
    mask = np.zeros((n_shards, len(views)), bool)
    for i, view in enumerate(views):
        vh, vw = (
            (h, w) if h is not None else
            (int(view.depth.shape[0]), int(view.depth.shape[1]))
        )
        for s in range(n_shards):
            mask[s, i] = view_intersects_slab(
                view.camera, grid, s * m, (s + 1) * m, vh, vw
            )
    return mask
