"""State carried across from the JAX package.

Each function takes an object of ``cudadepthmapintegration_tpu`` by duck
typing, reads only its numpy attributes (never importing that package, so
never JAX) and returns the port's counterpart, so that both packages can
compute on identical state. A fused volume needs no conversion: any
(cz, cy, cx) array, e.g. the JAX ``TSDFIntegrator.result()``, is taken by
``ops.integrate.TSDFIntegrator.reset(initial=...)``; a sparse grid is
carried across whole by :func:`sparse_grid_from`.
"""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np
import torch

from .core.camera import Camera
from .core.grid import VoxelGrid
from .core.ray_potential import RayPotential
from .core.view import DepthMapView
from .ops.sparse_grid import SparseTSDFGrid

__all__ = [
    "camera_from",
    "grid_from",
    "params_from",
    "sparse_grid_from",
    "view_from",
    "views_from",
]


def grid_from(grid) -> VoxelGrid:
    """A ``VoxelGrid`` (dims, origin, spacing, matrix)."""
    return VoxelGrid(
        dims=tuple(grid.dims),
        origin=tuple(grid.origin),
        spacing=tuple(grid.spacing),
        matrix=np.array(grid.matrix, dtype=np.float64),
    )


def params_from(params) -> RayPotential:
    """A ``RayPotential`` (thick, rho, eta, delta)."""
    return RayPotential(
        thick=params.thick, rho=params.rho, eta=params.eta, delta=params.delta
    )


def camera_from(camera) -> Camera:
    """A ``Camera`` (k 3x3, rt 4x4)."""
    return Camera(k=np.array(camera.k), rt=np.array(camera.rt))


def view_from(view) -> DepthMapView:
    """A ``DepthMapView``: depth, camera, color, best_cost and name; the
    arrays are copied, so neither side sees the other's edits."""

    def copy(a):
        return None if a is None else np.array(a)

    return DepthMapView(
        depth=np.array(view.depth),
        camera=camera_from(view.camera),
        color=copy(view.color),
        best_cost=copy(view.best_cost),
        name=view.name,
    )


def views_from(views: Iterable) -> list[DepthMapView]:
    return [view_from(v) for v in views]


def sparse_grid_from(grid, device: str | torch.device = "cuda") -> SparseTSDFGrid:
    """A ``SparseTSDFGrid`` on ``device`` with the same configuration, block
    map, free list, slot cursor, frame count and pools (copied)."""
    out = SparseTSDFGrid(
        voxel_size=grid.voxel_size,
        params=params_from(grid.params),
        block_shape=tuple(grid.block_shape),
        capacity=grid.capacity,
        pixel_stride=grid.pixel_stride,
        with_color=grid.with_color,
        device=device,
    )
    out.block_map = {tuple(int(x) for x in c): int(s) for c, s in grid.block_map.items()}
    out._free_slots = [int(s) for s in grid._free_slots]
    out._next_slot = int(grid._next_slot)
    out.frames_fused = int(grid.frames_fused)
    pools = ["pool"] + (["color_pool", "weight_pool"] if grid.with_color else [])
    for name in pools:
        host = torch.from_numpy(np.array(getattr(grid, name), np.float32))
        setattr(out, name, host.to(out.device))
    return out
