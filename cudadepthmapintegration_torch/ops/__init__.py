"""Compute ops: TSDF integration, cell->point, marching cubes, coloration,
sparse grids."""

from .cell_to_point import cell_to_point
from .coloration import colorize_mesh, colorize_points
from .integrate import ProjectionTables, TSDFIntegrator, projection_tables
from .marching_cubes import extract_isosurface, marching_cubes
from .normals import normals_for_edge_keys, transform_normals
from .oracle import integrate_views_oracle
from .sparse_grid import SparseTSDFGrid

__all__ = [
    "ProjectionTables",
    "SparseTSDFGrid",
    "TSDFIntegrator",
    "cell_to_point",
    "colorize_mesh",
    "colorize_points",
    "extract_isosurface",
    "integrate_views_oracle",
    "marching_cubes",
    "normals_for_edge_keys",
    "projection_tables",
    "transform_normals",
]
