"""Test fixtures: synthetic calibrated scenes with closed-form geometry."""

from .synthetic import (
    COLOR_COLUMN_KINDS,
    color_stat_columns,
    look_at_camera,
    orbit_cameras,
    render_sphere_batch,
    render_sphere_view,
    sphere_scene,
)

__all__ = [
    "COLOR_COLUMN_KINDS",
    "color_stat_columns",
    "look_at_camera",
    "orbit_cameras",
    "render_sphere_batch",
    "render_sphere_view",
    "sphere_scene",
]
