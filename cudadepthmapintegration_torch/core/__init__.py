"""Core geometry and data model: grid, camera, ray potential, views."""

from .camera import Camera, compose_projection, round_half_away
from .grid import VoxelGrid, are_vectors_orthogonal, grid_matrix_from_axes
from .ray_potential import RayPotential, ray_potential_np, ray_potential_torch
from .view import DepthMapView, apply_best_cost_threshold

__all__ = [
    "Camera",
    "DepthMapView",
    "RayPotential",
    "VoxelGrid",
    "apply_best_cost_threshold",
    "are_vectors_orthogonal",
    "compose_projection",
    "grid_matrix_from_axes",
    "ray_potential_np",
    "ray_potential_torch",
    "round_half_away",
]
