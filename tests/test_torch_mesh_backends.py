"""The port's meshing routes against each other and against the JAX package.

Routes: ``backend="device"`` (float32 two-phase extraction on the volume's
device) with ``weld_backend="host"`` (the default) or ``"device"``;
``backend="native"`` (the float64 host walker of the native library). Also
the sharded isosurface with the native walker, and the VTK XML reader with
the native codec. Tolerances, and why:

* device weld against host weld: **bit for bit** (points, triangles,
  normals, dtype): the same soup, and of each run of equal keys both keep
  the last original occurrence;
* device weld against the JAX package's device weld: equal triangles and
  normals, points within **1e-6 of the extent** (XLA on the CPU contracts
  the vertex interpolation into a fused multiply-add; the port does not,
  see tests/test_torch_mesh.py);
* native against the JAX package's native: **bit for bit** (the same
  library walks the same float64 values);
* device against native: equal triangles, points within **1e-6 of the
  extent** (float32 against float64 interpolation);
* sharded native against dense native: **bit for bit**;
* decoded arrays: **equal**, native codec or Python ``zlib``.
"""

import importlib

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch import interop, native
from _native_guard import native_libraries  # noqa: F401  (module fixture)
from cudadepthmapintegration_torch.io import read_vti, read_vts, write_vti, write_vts
from cudadepthmapintegration_torch.io import ImageData
from cudadepthmapintegration_torch.parallel import make_mesh, sharded_extract_isosurface
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.io import read_vti as j_read_vti
from cudadepthmapintegration_tpu.io import read_vts as j_read_vts
from cudadepthmapintegration_tpu.ops import integrate_views_oracle
from cudadepthmapintegration_tpu.testing import sphere_scene

TMC = importlib.import_module("cudadepthmapintegration_torch.ops.marching_cubes")
JMC = importlib.import_module("cudadepthmapintegration_tpu.ops.marching_cubes")

# The rotation-and-shift grid matrix of tests/test_marching_cubes.py.
MAT = np.eye(4)
MAT[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
MAT[:3, 3] = [0.1, -0.2, 0.3]
GRID = VoxelGrid(dims=(17, 17, 17), origin=(-1.63, -1.61, -1.59), spacing=(0.2, 0.2, 0.2))
EXTENT = 3.2


def sphere_points(dim=24):
    """The point volume of tests/test_marching_cubes.py's weld test."""
    ax = np.linspace(-1.2, 1.2, dim, dtype=np.float32)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    return (1.0 - np.sqrt(xx * xx + yy * yy + zz * zz)).astype(np.float32), ax


@pytest.fixture(scope="module")
def fused():
    views = sphere_scene(n_views=6, width=64, height=48)
    params = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)
    return integrate_views_oracle(GRID, views, params).astype(np.float32)


def assert_meshes_equal(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    assert a.points.dtype == b.points.dtype
    np.testing.assert_array_equal(a.triangles, b.triangles)
    assert a.triangles.dtype == b.triangles.dtype
    assert sorted(a.point_data) == sorted(b.point_data)
    for name in a.point_data:
        np.testing.assert_array_equal(a.point_data[name], b.point_data[name], err_msg=name)
        assert a.point_data[name].dtype == b.point_data[name].dtype


@pytest.mark.parametrize("matrix", [None, MAT], ids=["no_matrix", "matrix"])
def test_device_weld_equals_host_weld(matrix):
    vol, ax = sphere_points()
    kw = dict(matrix=matrix, compute_normals=True)
    host = TMC.marching_cubes(torch.from_numpy(vol), 0.0, ax, ax, ax, **kw)
    dev = TMC.marching_cubes(torch.from_numpy(vol), 0.0, ax, ax, ax, weld_backend="device", **kw)
    assert host.num_triangles > 100
    assert_meshes_equal(dev, host)


@pytest.mark.parametrize("matrix", [None, MAT], ids=["no_matrix", "matrix"])
def test_device_weld_matches_jax_device_weld(matrix):
    vol, ax = sphere_points()
    kw = dict(matrix=matrix, compute_normals=True, weld_backend="device")
    got = TMC.marching_cubes(torch.from_numpy(vol), 0.0, ax, ax, ax, **kw)
    exp = JMC.marching_cubes(vol, 0.0, ax, ax, ax, backend="jax", **kw)
    np.testing.assert_array_equal(got.triangles, exp.triangles)
    np.testing.assert_allclose(got.points, exp.points, rtol=0, atol=1e-6 * 2.4)
    np.testing.assert_array_equal(got.point_data["Normals"], exp.point_data["Normals"])


def test_device_weld_keeps_the_last_duplicate():
    # Two copies of key 7 whose positions differ: the host weld's scatter
    # keeps the later one, and so must the device weld.
    verts = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0],
                          [0, 1, 0], [1, 1, 1], [5, 5, 5]], dtype=torch.float32)
    keys = torch.tensor([7, 3, 9, 3, 7, 8])
    points, tris, uniq = TMC.weld_soup_device(verts, keys)
    host, host_keys = TMC._weld_triangle_soup(verts.numpy(), keys.numpy(), None, return_keys=True)
    np.testing.assert_array_equal(uniq, [3, 7, 8, 9])
    np.testing.assert_array_equal(points, host.points)
    np.testing.assert_array_equal(points[1], [1, 1, 1])
    np.testing.assert_array_equal(tris, host.triangles)
    np.testing.assert_array_equal(uniq, host_keys)


def test_degenerate_triangles_are_dropped_by_both_welds():
    verts = torch.arange(18, dtype=torch.float32).reshape(6, 3)
    keys = torch.tensor([1, 1, 2, 3, 4, 5])  # the first triangle is degenerate
    points, tris, _ = TMC.weld_soup_device(verts, keys)
    host = TMC._weld_triangle_soup(verts.numpy(), keys.numpy(), None)
    np.testing.assert_array_equal(tris, [[2, 3, 4]])  # keys 3, 4, 5 of 1..5
    np.testing.assert_array_equal(tris, host.triangles)
    np.testing.assert_array_equal(points, host.points)


@pytest.mark.parametrize("weld", ["host", "device"])
def test_extract_isosurface_routes_on_fused_volume(fused, weld):
    grid = interop.grid_from(GRID)
    host = TMC.extract_isosurface(grid, torch.from_numpy(fused), 1.0)
    got = TMC.extract_isosurface(grid, torch.from_numpy(fused), 1.0, weld_backend=weld)
    assert_meshes_equal(got, host)


def test_native_equals_jax_native(fused):
    got = TMC.extract_isosurface(interop.grid_from(GRID), torch.from_numpy(fused), 1.0,
                                 backend="native")
    exp = JMC.extract_isosurface(GRID, fused, 1.0, backend="native")
    assert got.num_triangles > 100
    assert got.points.dtype == np.float64
    assert_meshes_equal(got, exp)


@pytest.mark.parametrize("matrix", [None, MAT], ids=["no_matrix", "matrix"])
def test_native_marching_cubes_equals_jax_native(matrix):
    vol, ax = sphere_points(21)
    kw = dict(matrix=matrix, compute_normals=True, backend="native")
    got = TMC.marching_cubes(torch.from_numpy(vol), 0.0, ax, ax, ax, **kw)
    exp = JMC.marching_cubes(vol, 0.0, ax, ax, ax, **kw)
    assert_meshes_equal(got, exp)
    soup = TMC.marching_cubes(torch.from_numpy(vol), 0.0, ax, ax, ax, backend="native",
                              return_soup=True)
    jsoup = JMC.marching_cubes(vol, 0.0, ax, ax, ax, backend="native", _return_soup=True)
    for a, b in zip(soup, jsoup):
        np.testing.assert_array_equal(a, b)


def test_device_against_native(fused):
    grid = interop.grid_from(GRID)
    dev = TMC.extract_isosurface(grid, torch.from_numpy(fused), 1.0)
    nat = TMC.extract_isosurface(grid, torch.from_numpy(fused), 1.0, backend="native")
    assert dev.num_points == nat.num_points
    np.testing.assert_array_equal(dev.triangles, nat.triangles)
    np.testing.assert_allclose(dev.points, nat.points, rtol=0, atol=1e-6 * EXTENT)


@pytest.mark.parametrize("n_z", [2, 4])
def test_sharded_native_equals_dense_native(fused, n_z):
    grid = interop.grid_from(GRID)
    dense = TMC.extract_isosurface(grid, torch.from_numpy(fused), 1.0, backend="native")
    slabs = list(torch.from_numpy(fused).chunk(n_z))
    dist = sharded_extract_isosurface(slabs, grid, 1.0, make_mesh(n_z=n_z, devices=["cpu"] * n_z),
                                      backend="native")
    assert_meshes_equal(dist, dense)


def test_empty_volume_routes():
    vol, ax = np.zeros((5, 4, 3), np.float32), np.arange(5, dtype=np.float32)
    for kw in (dict(), dict(weld_backend="device"), dict(backend="native")):
        mesh = TMC.marching_cubes(torch.from_numpy(vol), 0.5, ax[:3], ax[:4], ax, compute_normals=True,
                                  **kw)
        assert mesh.num_points == mesh.num_triangles == 0
        assert mesh.point_data["Normals"].shape == (0, 3)


@pytest.mark.parametrize("kw, msg", [
    (dict(backend="jax"), "backend must be"),
    (dict(weld_backend="numpy"), "weld_backend must be"),
    (dict(backend="native", weld_backend="device"), "needs backend='device'"),
])
def test_unknown_routes_are_refused(kw, msg):
    vol, ax = sphere_points(6)
    with pytest.raises(ValueError, match=msg):
        TMC.marching_cubes(torch.from_numpy(vol), 0.0, ax, ax, ax, **kw)


def compressed_files(tmp_path):
    rng = np.random.default_rng(5)
    image = ImageData((40, 30, 1), origin=(0.5, -1.0, 0.0), spacing=(0.1, 0.2, 1.0))
    image.point_data["Depths"] = rng.standard_normal(1200)
    image.point_data["Color"] = rng.integers(0, 256, (1200, 3), dtype=np.uint8)
    # 1.2 MB of doubles: 37 blocks of 32 KiB, the last one short.
    image.cell_data["reconstruction_scalar"] = np.repeat(rng.standard_normal(39 * 29), 130)[:39 * 29]
    vti = str(tmp_path / "a.vti")
    write_vti(vti, image, compress=True)
    pts = rng.standard_normal((9, 8, 7, 3))
    vts = str(tmp_path / "a.vts")
    write_vts(vts, pts, point_arrays={"p": rng.standard_normal(9 * 8 * 7)},
              cell_arrays={"c": np.linspace(0, 1, 8 * 7 * 6 * 400)[: 8 * 7 * 6]}, compress=True)
    return vti, vts


def test_readers_decode_with_the_native_codec(tmp_path, monkeypatch):
    vti, vts = compressed_files(tmp_path)
    calls = []
    decode = native.zlib_decode_blocks
    monkeypatch.setattr(native, "zlib_decode_blocks",
                        lambda *a: calls.append(1) or decode(*a))
    image, grid = read_vti(vti), read_vts(vts)
    assert len(calls) == 3 + 3  # every compressed array of both files
    jimage, jgrid = j_read_vti(vti), j_read_vts(vts)
    for name in ("Depths", "Color"):
        np.testing.assert_array_equal(image.point_data[name], jimage.point_data[name])
    np.testing.assert_array_equal(image.cell_data["reconstruction_scalar"],
                                  jimage.cell_data["reconstruction_scalar"])
    for a, b in zip(grid, jgrid):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)


def test_native_codec_equals_python_zlib(tmp_path, monkeypatch):
    vti, vts = compressed_files(tmp_path)
    image, grid = read_vti(vti), read_vts(vts)
    monkeypatch.setattr(native, "available", lambda: False)
    z_image, z_grid = read_vti(vti), read_vts(vts)
    for store, z_store in ((image.point_data, z_image.point_data),
                           (image.cell_data, z_image.cell_data)):
        assert sorted(store) == sorted(z_store)
        for k in store:
            np.testing.assert_array_equal(store[k], z_store[k])
            assert store[k].dtype == z_store[k].dtype
    np.testing.assert_array_equal(grid[0], z_grid[0])
    for a, b in zip(grid[1:], z_grid[1:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
