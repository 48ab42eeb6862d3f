"""Test fixtures: synthetic calibrated scenes with closed-form geometry."""

from .synthetic import look_at_camera, orbit_cameras, render_sphere_view, sphere_scene

__all__ = ["look_at_camera", "orbit_cameras", "render_sphere_view", "sphere_scene"]
