"""The port's cell->point, marching cubes and normals against the JAX package.

Both sides get the same float32 volume (made with numpy from a seed, or
fused by the JAX oracle); the JAX side runs its two-phase device extractor
(``backend="jax"``). Tolerances, and why:

* cell->point: **bitwise**. The same eight adds in the same order and one
  IEEE division.
* marching cubes: equal vertex and triangle counts and **equal triangles**
  (configurations and edge keys are exact integer work). Vertex positions
  within **1e-6 of the grid extent**: XLA on the CPU contracts
  ``pa + t * (pb - pa)`` into a fused multiply-add, the port does not, so a
  coordinate may differ in its last bit.
* normals: **bitwise**. They are central differences of the same point
  volume at the same edge keys, in numpy on both sides.
"""

import importlib

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.ops import cell_to_point as t_c2p
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.ops import cell_to_point as j_c2p
from cudadepthmapintegration_tpu.ops import integrate_views_oracle
from cudadepthmapintegration_tpu.testing import sphere_scene

# The ops packages re-export the functions under the module names.
TMC = importlib.import_module("cudadepthmapintegration_torch.ops.marching_cubes")
JMC = importlib.import_module("cudadepthmapintegration_tpu.ops.marching_cubes")

GRID = VoxelGrid(dims=(29, 23, 17), origin=(-1.6, -1.5, -1.4),
                 spacing=(3.2 / 28, 3.0 / 22, 2.8 / 16))
EXTENT = 3.2


def sdf_volume(grid=GRID, r=1.0, seed=0):
    """Signed distance to a sphere at the cell centers, plus seeded noise."""
    c = grid.cell_centers_world(np.float64)
    vals = np.linalg.norm(c, axis=-1) - r
    rng = np.random.default_rng(seed)
    return (vals + 0.01 * rng.standard_normal(vals.shape)).astype(np.float32)


def fused_volume():
    views = sphere_scene(n_views=6, width=96, height=72, focal=90.0)
    params = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)
    return integrate_views_oracle(GRID, views, params).astype(np.float32)


VOLUMES = {"sdf": sdf_volume, "fused": fused_volume}
ISO = {"sdf": 0.0, "fused": 0.5}


@pytest.mark.parametrize("shape", [(13, 17, 11), (1, 5, 2), (8, 8, 8)])
def test_cell_to_point_bitwise(shape):
    vol = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    exp = np.asarray(j_c2p(vol))
    got = t_c2p(torch.from_numpy(vol)).numpy()
    assert got.shape == tuple(s + 1 for s in shape)
    np.testing.assert_array_equal(got, exp)


def _assert_meshes_match(got, exp):
    assert got.num_points == exp.num_points > 0
    assert got.num_triangles == exp.num_triangles > 0
    np.testing.assert_array_equal(got.triangles, exp.triangles)
    np.testing.assert_allclose(got.points, exp.points, rtol=0, atol=1e-6 * EXTENT)
    np.testing.assert_array_equal(got.point_data["Normals"], exp.point_data["Normals"])


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_cubes_matches_jax(name):
    cells = VOLUMES[name]()
    pv = np.array(j_c2p(cells))
    xs, ys, zs = GRID.point_axes(np.float32)
    m = np.eye(4)
    m[:3, :3] = [[0, 1, 0], [-1, 0, 0], [0, 0, 1]]
    m[:3, 3] = [0.5, -0.25, 2.0]
    exp = JMC.marching_cubes(pv, ISO[name], xs, ys, zs, matrix=m,
                             backend="jax", compute_normals=True)
    got = TMC.marching_cubes(torch.from_numpy(pv), ISO[name], xs, ys, zs,
                             matrix=m, compute_normals=True)
    _assert_meshes_match(got, exp)


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_extract_isosurface_matches_jax(name):
    cells = VOLUMES[name]()
    exp = JMC.extract_isosurface(GRID, cells, ISO[name], backend="jax")
    got = TMC.extract_isosurface(interop.grid_from(GRID), torch.from_numpy(cells), ISO[name])
    _assert_meshes_match(got, exp)
    np.testing.assert_array_equal(
        got.point_data["reconstruction_scalar"], exp.point_data["reconstruction_scalar"]
    )
    assert got.active_scalars == exp.active_scalars == "reconstruction_scalar"


def test_chunked_emission_is_bit_identical(monkeypatch):
    cells = sdf_volume()
    grid = interop.grid_from(GRID)
    ref = TMC.extract_isosurface(grid, torch.from_numpy(cells), 0.0)
    monkeypatch.setattr(TMC, "CELL_CHUNK", 37)
    got = TMC.extract_isosurface(grid, torch.from_numpy(cells), 0.0)
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.triangles, ref.triangles)
    np.testing.assert_array_equal(got.point_data["Normals"], ref.point_data["Normals"])


def test_no_crossing_gives_an_empty_mesh_with_normals():
    cells = np.full(GRID.volume_shape, 2.0, np.float32)
    exp = JMC.extract_isosurface(GRID, cells, 0.0, backend="jax")
    got = TMC.extract_isosurface(interop.grid_from(GRID), torch.from_numpy(cells), 0.0)
    assert got.num_points == exp.num_points == 0
    assert got.num_triangles == exp.num_triangles == 0
    assert got.point_data["Normals"].shape == (0, 3)


def test_float64_volume_matches_jax():
    cells = sdf_volume().astype(np.float64)
    exp = JMC.extract_isosurface(GRID, cells, 0.0, backend="jax")
    got = TMC.extract_isosurface(interop.grid_from(GRID), torch.from_numpy(cells), 0.0)
    _assert_meshes_match(got, exp)
