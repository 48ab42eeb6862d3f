"""The port's multi-device fusion (``parallel/``) on the CPU.

A mesh of repeated CPU devices (``make_mesh(devices=["cpu"] * n)``) stands
in for the JAX package's eight virtual CPU devices; every slab runs the
integrate kernel's plain PyTorch version. Tolerances, and why:

* **Bitwise** against the port's own single-device ``TSDFIntegrator`` on
  the z-slab, frustum-culled and interleaved paths and in every accepted
  mode: they change which launches happen, never a voxel's add order.
* **1e-5** for view-parallel fusion at float32: the sum of ``v`` partials
  regroups each voxel's additions, an ulp or two of values below 16.
* **1e-9** at float64 against the JAX ``ShardedTSDFIntegrator`` (XLA
  path) on its 8-device CPU mesh: the JAX package's own tolerance against
  the oracle (tests/test_sharded.py).
* **Bitwise** for sharded cell->point, the sharded mesh (points,
  triangles, normals) and sharded coloration against the port's dense
  versions; against the JAX sharded versions the JAX package's own
  tolerances (tests/test_sharded.py, tests/test_sharded_mesh.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.ops.cell_to_point import cell_to_point
from cudadepthmapintegration_torch.ops.coloration import colorize_points
from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator as TorchIntegrator
from cudadepthmapintegration_torch.ops.marching_cubes import extract_isosurface
from cudadepthmapintegration_torch.parallel import (
    DeviceMesh,
    ShardedTSDFIntegrator,
    distributed,
    exchange_z_halo,
    make_mesh,
    sharded_cell_to_point,
    sharded_colorize_points,
    sharded_extract_isosurface,
)
from cudadepthmapintegration_torch.parallel import frustum as t_frustum
from cudadepthmapintegration_torch.parallel import rig as t_rig
from cudadepthmapintegration_torch.pipeline import (
    ReconstructionConfig as TorchConfig,
    ReconstructionPipeline as TorchPipeline,
)
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.parallel import frustum as j_frustum
from cudadepthmapintegration_tpu.parallel import rig as j_rig
from cudadepthmapintegration_tpu.testing import (
    look_at_camera,
    orbit_cameras,
    render_sphere_view,
    sphere_scene,
)

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)
T_PARAMS = interop.params_from(PARAMS)
W, H = 64, 48


def grid16(origin=(-1.6,) * 3):
    # 16 z-cells: divides 2, 4, 8 shards.
    return VoxelGrid(dims=(17, 17, 17), origin=origin, spacing=(0.2,) * 3)


def cpu_mesh(n_z, n_v=1):
    return make_mesh(n_z=n_z, n_v=n_v, devices=["cpu"] * (n_z * n_v))


def topdown_views(n=4):
    return [render_sphere_view(c, W, H, radius=1.0, background=-1.0)
            for c in orbit_cameras(n, 0.5, height=4.0, focal=60.0,
                                   width=W, image_height=H)]


def narrow_views():
    """A distant orbit with a narrow vertical field of view: each view sees
    only the central z-slabs, so culling really culls (the rig of
    tests/test_sharded_pallas.py)."""
    return [render_sphere_view(c, 144, 64, radius=1.0, background=-1.0)
            for c in orbit_cameras(4, 4.0, focal=300.0, width=144, image_height=64)]


def single(grid, views, dtype=torch.float32, threshold=None):
    return (TorchIntegrator(interop.grid_from(grid), T_PARAMS, dtype=dtype).reset()
            .integrate(interop.views_from(views), threshold).result())


def sharded(grid, views, mesh, dtype=torch.float32, method="integrate", **kw):
    integ = ShardedTSDFIntegrator(interop.grid_from(grid), T_PARAMS, mesh, dtype=dtype,
                                  slab_interleave=kw.pop("slab_interleave", False))
    getattr(integ.reset(), method)(interop.views_from(views), **kw)
    return integ


# -- mesh ----------------------------------------------------------------------


def test_make_mesh_repeated_devices_and_shape():
    mesh = make_mesh(n_z=4, n_v=2, devices=["cpu"] * 8)
    assert isinstance(mesh, DeviceMesh)
    assert mesh.shape == {"z": 4, "v": 2}
    assert mesh.axis_names == ("z", "v")
    assert mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert make_mesh(devices=["cpu"] * 3).shape == {"z": 3, "v": 1}
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(n_z=4, n_v=2, devices=["cpu"] * 4)


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make_mesh()


# -- rig and frustum math ---------------------------------------------------------


@pytest.mark.parametrize("rig", ["equatorial", "topdown"])
def test_rig_functions_match_jax(rig):
    views = (topdown_views() if rig == "topdown" else
             [render_sphere_view(c, W, H) for c in orbit_cameras(
                 6, 4.0, focal=60.0, width=W, image_height=H)])
    grid = VoxelGrid(dims=(17, 13, 9), origin=(-1.6,) * 3,
                     spacing=(0.2, 3.2 / 12, 0.4))
    t_grid, t_views = interop.grid_from(grid), interop.views_from(views)
    assert (t_rig.best_shard_grid_axis(t_grid, t_views)
            == j_rig.best_shard_grid_axis(grid, views))
    for n in (None, 2, 4):
        tg, tp = t_rig.grid_for_sharding(t_grid, t_views, n_shards=n)
        jg, jp = j_rig.grid_for_sharding(grid, views, n_shards=n)
        assert tp == jp and tg.dims == jg.dims
        assert tg.origin == jg.origin and tg.spacing == jg.spacing
        np.testing.assert_array_equal(tg.matrix, jg.matrix)
    vol = np.arange(2 * 3 * 4, dtype=np.float64).reshape(2, 3, 4)
    for perm in [(1, 0, 2), (2, 1, 0), (1, 2, 0), (2, 0, 1)]:
        exp = j_rig.permute_volume(vol, perm)
        np.testing.assert_array_equal(t_rig.permute_volume(vol, perm), exp)
        got_t = t_rig.permute_volume(torch.from_numpy(vol), perm)
        np.testing.assert_array_equal(got_t.numpy(), exp)
        np.testing.assert_array_equal(
            t_rig.unpermute_volume(got_t, perm).numpy(), vol)


def test_frustum_functions_match_jax():
    grid = grid16()
    views = narrow_views()
    for n in (2, 4, 8):
        exp = j_frustum.slab_view_mask(grid, views, n)
        got = t_frustum.slab_view_mask(interop.grid_from(grid), interop.views_from(views), n)
        np.testing.assert_array_equal(got, exp)
    assert not exp.all()  # the close-up rig culls something
    cam = views[0].camera
    for z0, z1 in ((0, 2), (6, 10), (14, 16)):
        assert (t_frustum.view_intersects_slab(interop.camera_from(cam), interop.grid_from(grid),
                                               z0, z1, 64, 144)
                == j_frustum.view_intersects_slab(cam, grid, z0, z1, 64, 144))


# -- sharded integration ---------------------------------------------------------------


@pytest.mark.parametrize("n_z", [2, 4, 8])
def test_z_slab_bitwise_vs_single_device(n_z):
    views = sphere_scene(n_views=4, width=W, height=H)
    grid = grid16()
    integ = sharded(grid, views, cpu_mesh(n_z), threshold_best_cost=0.5)
    assert [s.shape for s in integ.slabs] == [(16 // n_z, 16, 16)] * n_z
    assert integ.views_fused == 4 and integ.volume_sweeps == 1
    exp = single(grid, views, threshold=0.5)
    assert np.abs(exp).max() > 0.5
    np.testing.assert_array_equal(integ.result(), exp)


@pytest.mark.parametrize("mode", ["rowsel", "rowsel3", "rowselh", "rowsel3h", "windows"])
def test_every_accepted_mode_bitwise(mode):
    views = sphere_scene(n_views=4, width=W, height=H)
    grid = grid16()
    integ = sharded(grid, views, cpu_mesh(4), method="integrate_pallas", mode=mode)
    np.testing.assert_array_equal(integ.result(), single(grid, views))


@pytest.mark.parametrize("mode", ["rowselm", "rowsel3m", "rowselw", "rowseld", "bogus"])
def test_other_modes_raise_the_jax_error(mode):
    integ = ShardedTSDFIntegrator(interop.grid_from(grid16()), T_PARAMS, cpu_mesh(2))
    with pytest.raises(ValueError, match="sharded integrate supports mode"):
        integ.stage_pallas_views(interop.views_from(sphere_scene(n_views=1)), mode=mode)


def test_staged_batch_reruns_and_shares_uploads():
    views = interop.views_from(sphere_scene(n_views=3, width=W, height=H))
    integ = ShardedTSDFIntegrator(interop.grid_from(grid16()), T_PARAMS, cpu_mesh(4)).reset()
    staged = integ.stage_pallas_views(views, mode="windows")
    # One upload of the maps per distinct device: four shards, one tensor.
    assert len({a[4].data_ptr() for a in staged}) == 1
    assert all(a[2].is_contiguous() and a[2].shape == (3, 4, 4) for a in staged)
    integ.run_staged_pallas(staged).run_staged_pallas(staged)
    twice = TorchIntegrator(interop.grid_from(grid16()), T_PARAMS).reset()
    twice.integrate(views).integrate(views)
    np.testing.assert_array_equal(integ.result(), twice.result())


def test_frustum_cull_and_interleave_bitwise():
    views = narrow_views()
    grid = grid16(origin=(-1.63, -1.61, -1.59))
    exp = single(grid, views)
    mask = t_frustum.slab_view_mask(interop.grid_from(grid), interop.views_from(views), 4)
    assert not mask.all() and mask.any(axis=0).all()
    culled = sharded(grid, views, cpu_mesh(4), method="integrate_pallas", frustum_cull=True)
    np.testing.assert_array_equal(culled.result(), exp)
    # Eight shards of 2 slices: the end shards see no view at all.
    mask8 = t_frustum.slab_view_mask(interop.grid_from(grid), interop.views_from(views), 8)
    assert not mask8.any(axis=1).all()
    culled8 = sharded(grid, views, cpu_mesh(8), method="integrate_pallas", frustum_cull=True)
    np.testing.assert_array_equal(culled8.result(), exp)
    inter = sharded(grid, views, cpu_mesh(4), slab_interleave=True)
    np.testing.assert_array_equal(inter.result(), exp)
    with pytest.raises(ValueError, match="slab_interleave"):
        sharded(grid, views, cpu_mesh(4), method="integrate_pallas",
                slab_interleave=True, frustum_cull=True)


def test_interleave_resume_and_incremental():
    views = sphere_scene(n_views=4, width=W, height=H)
    grid = grid16()
    first = single(grid, views[:2])
    integ = ShardedTSDFIntegrator(interop.grid_from(grid), T_PARAMS, cpu_mesh(4),
                                  slab_interleave=True).reset(first)
    integ.integrate(interop.views_from(views[2:3])).integrate(interop.views_from(views[3:]))
    np.testing.assert_array_equal(integ.result(), single(grid, views))
    with pytest.raises(ValueError, match="initial volume has shape"):
        integ.reset(np.zeros((2, 2, 2), np.float32))
    with pytest.raises(ValueError, match="must divide"):
        ShardedTSDFIntegrator(interop.grid_from(grid), T_PARAMS, cpu_mesh(3))


def test_view_parallel_within_tolerance_and_divisibility():
    views = sphere_scene(n_views=8, width=W, height=H)
    grid = grid16()
    integ = sharded(grid, views, cpu_mesh(2, 2), method="integrate_view_parallel")
    exp = single(grid, views)
    np.testing.assert_allclose(integ.result(), exp, rtol=0, atol=1e-5)
    f64 = sharded(grid, views, cpu_mesh(2, 4), dtype=torch.float64,
                  method="integrate_view_parallel")
    np.testing.assert_allclose(f64.result(), single(grid, views, torch.float64),
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="multiple"):
        sharded(grid, views[:3], cpu_mesh(2, 2), method="integrate_view_parallel")


@pytest.mark.parametrize("view_parallel", [False, True])
def test_float64_matches_jax_sharded_on_eight_devices(view_parallel):
    from cudadepthmapintegration_tpu.parallel import ShardedTSDFIntegrator as JaxSharded
    from cudadepthmapintegration_tpu.parallel import make_mesh as jax_make_mesh

    assert jax.device_count() >= 8
    views = sphere_scene(n_views=8, width=W, height=H)
    grid = grid16()
    jmesh = jax_make_mesh(n_z=4, n_v=2) if view_parallel else jax_make_mesh(n_z=8)
    method = "integrate_view_parallel" if view_parallel else "integrate"
    jax_integ = JaxSharded(grid, PARAMS, jmesh, dtype=np.float64).reset()
    getattr(jax_integ, method)(views)
    n_z, n_v = jmesh.shape["z"], jmesh.shape["v"]
    got = sharded(grid, views, cpu_mesh(n_z, n_v), dtype=torch.float64, method=method)
    np.testing.assert_allclose(got.result(), jax_integ.result(), rtol=0, atol=1e-9)


# -- halo, mesh and coloration ---------------------------------------------------------


def test_exchange_z_halo():
    slabs = [torch.full((2, 3, 4), float(i + 1)) for i in range(3)]
    halos = exchange_z_halo(slabs)
    assert [(b[0, 0, 0].item(), a[0, 0, 0].item()) for b, a in halos] == [
        (0.0, 2.0), (1.0, 3.0), (2.0, 0.0)]
    assert all(b.shape == (1, 3, 4) and a.shape == (1, 3, 4) for b, a in halos)


@pytest.mark.parametrize("n_z", [2, 4, 8])
def test_sharded_cell_to_point_bitwise(n_z):
    from cudadepthmapintegration_tpu.ops.cell_to_point import cell_to_point as jax_c2p

    rng = np.random.default_rng(3)
    cells = rng.normal(size=(16, 12, 10))
    blocks = sharded_cell_to_point(list(torch.from_numpy(cells).chunk(n_z)), cpu_mesh(n_z))
    assert [b.shape[0] for b in blocks] == [16 // n_z] * (n_z - 1) + [16 // n_z + 1]
    got = torch.cat(blocks)
    assert torch.equal(got, cell_to_point(torch.from_numpy(cells)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_c2p(cells)), atol=1e-12)


def fused_slabs(n_z, dtype=torch.float32):
    grid = grid16(origin=(-1.63, -1.61, -1.59))
    views = sphere_scene(n_views=6, width=W, height=H)
    return grid, sharded(grid, views, cpu_mesh(n_z), dtype=dtype)


@pytest.mark.parametrize("n_z", [2, 4, 8])
def test_sharded_mesh_identical_to_dense(n_z):
    grid, integ = fused_slabs(n_z)
    t_grid = interop.grid_from(grid)
    dense = extract_isosurface(t_grid, torch.from_numpy(integ.result()), 1.0)
    got = sharded_extract_isosurface(integ.slabs, t_grid, 1.0, integ.mesh)
    assert got.num_triangles == dense.num_triangles > 0
    np.testing.assert_array_equal(got.points, dense.points)
    np.testing.assert_array_equal(got.triangles, dense.triangles)
    assert sorted(got.point_data) == sorted(dense.point_data)
    for name in dense.point_data:
        np.testing.assert_array_equal(got.point_data[name], dense.point_data[name])
    assert got.active_scalars == dense.active_scalars


def test_sharded_mesh_matches_jax_sharded():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cudadepthmapintegration_tpu.parallel import make_mesh as jax_make_mesh
    from cudadepthmapintegration_tpu.parallel import (
        sharded_extract_isosurface as jax_sharded_extract,
    )

    grid, integ = fused_slabs(4, torch.float64)
    jmesh = jax_make_mesh(n_z=4)
    vol = jax.device_put(integ.result(), NamedSharding(jmesh, P("z", None, None)))
    exp = jax_sharded_extract(vol, grid, 1.0, jmesh, backend="jax")
    got = sharded_extract_isosurface(integ.slabs, interop.grid_from(grid), 1.0, integ.mesh)
    assert got.num_points == exp.num_points and got.num_triangles == exp.num_triangles
    np.testing.assert_allclose(got.points, exp.points, atol=1e-9)
    np.testing.assert_array_equal(got.triangles, exp.triangles)
    np.testing.assert_array_equal(got.point_data["Normals"], exp.point_data["Normals"])


def test_sharded_mesh_empty_volume():
    grid = interop.grid_from(grid16())
    mesh = cpu_mesh(4)
    out = sharded_extract_isosurface(list(torch.zeros(grid.volume_shape).chunk(4)),
                                     grid, 1.0, mesh)
    assert out.num_triangles == 0 and out.point_data["Normals"].shape == (0, 3)


@pytest.mark.parametrize("n_z,n_v", [(4, 1), (2, 3)])
def test_sharded_coloration_equals_dense_and_jax(n_z, n_v):
    from cudadepthmapintegration_tpu.parallel import make_mesh as jax_make_mesh
    from cudadepthmapintegration_tpu.parallel import (
        sharded_colorize_points as jax_sharded_colorize,
    )

    views = sphere_scene(n_views=5, width=W, height=H)
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(101, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    t_views = interop.views_from(views)
    got = sharded_colorize_points(pts, t_views, cpu_mesh(n_z, n_v), view_chunk=2)
    exp = colorize_points(pts, t_views, view_chunk=2)
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2].max() > 0
    jax_out = jax_sharded_colorize(pts, views, jax_make_mesh(n_z=n_z, n_v=n_v), view_chunk=2)
    for a, b in zip(got, jax_out):
        np.testing.assert_array_equal(a, b)


# -- the pipeline ------------------------------------------------------------------


def pipeline_config(**kw):
    base = dict(grid_dims=(17, 17, 17), grid_spacing=(0.2, 0.2, 0.2),
                grid_origin=(-1.6, -1.6, -1.6), ray_thick=0.1, ray_rho=0.8,
                ray_eta=0.03, ray_delta=0.3, contour_value=1.0, device="cpu",
                write_mha_path=None)
    return TorchConfig(**{**base, **kw})


def equatorial_views(n=4):
    return [render_sphere_view(c, W, H, radius=1.0, background=-1.0)
            for c in orbit_cameras(n, 4.0, focal=60.0, width=W, image_height=H)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pipeline_sharded_auto_axis_z_bitwise(dtype):
    """An equatorial rig looks along z least: 'auto' keeps the grid, and the
    sharded pipeline equals the plain one bit for bit, mesh included."""
    cfg = pipeline_config(dtype=dtype, contour_value=0.5)
    views = interop.views_from(equatorial_views())
    base = TorchPipeline(cfg).run(views)
    auto = TorchPipeline(cfg, mesh=cpu_mesh(8), shard_axis="auto").run(views)
    assert auto.volume.shape == base.volume.shape
    np.testing.assert_array_equal(auto.volume, base.volume)
    assert auto.views_fused == base.views_fused == 4
    assert auto.volume_sweeps == base.volume_sweeps == 1
    assert auto.mesh.num_triangles == base.mesh.num_triangles > 0
    np.testing.assert_array_equal(auto.mesh.points, base.mesh.points)
    with pytest.raises(ValueError, match="shard_axis"):
        TorchPipeline(cfg, shard_axis="x")


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("float64", 1e-12)])
def test_pipeline_sharded_auto_axis_relabel(dtype, atol):
    """A top-down rig: 'auto' relabels an in-plane axis to z and returns the
    canonical layout. The relabeled tables enter the kernel's sum
    ``ty + (tx + (tz + tc))`` in another grouping, so values move by an ulp
    (and a projection on an exact half pixel may flip, hence the offset
    origin, see parallel/rig.py): equal within ``atol``, not bit for bit."""
    cfg = pipeline_config(dtype=dtype, grid_origin=(-1.63, -1.61, -1.59))
    views = interop.views_from(topdown_views())
    grid = cfg.make_grid()
    assert t_rig.grid_for_sharding(grid, views, n_shards=4)[1] != (0, 1, 2)
    base = TorchPipeline(cfg).run(views)
    pipe = TorchPipeline(cfg, mesh=cpu_mesh(4), shard_axis="auto")
    integ, _ = pipe.fuse(iter(views))  # a bare generator materializes
    assert integ.result().shape == base.volume.shape
    np.testing.assert_allclose(integ.result(), base.volume, rtol=0, atol=atol)


def test_pipeline_auto_axis_composes_with_checkpoint(tmp_path):
    """A canonical-layout run crashes after one unit; an auto-axis sharded
    pipeline resumes it. Poisoning the completed unit's views proves the
    resume skipped them (mirrors tests/test_rig_sharding.py)."""
    from cudadepthmapintegration_torch.pipeline.runner import (
        FaultTolerantRunner,
        FusionUnitError,
    )

    cfg = pipeline_config(grid_origin=(-1.63, -1.61, -1.59), dtype="float64",
                          stream_batch=2, checkpoint_path=str(tmp_path / "auto.ckpt"))
    views = interop.views_from(topdown_views(8))
    grid, params = cfg.make_grid(), cfg.ray_potential()
    calls = {"n": 0}

    def crashy(volume, batch):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("host died")
        integ = TorchIntegrator(grid, params, dtype=torch.float64).reset(volume)
        return integ.integrate(batch, cfg.threshold_best_cost).result()

    r1 = FaultTolerantRunner(grid, params, crashy, unit_size=2, max_retries=1,
                             checkpoint_path=cfg.checkpoint_path)
    with pytest.raises(FusionUnitError):
        r1.run(views)
    assert len(r1.completed_units) == 1

    base = TorchPipeline(dataclasses.replace(cfg, checkpoint_path=None)).run(views)
    resumed_views = [views[4], views[5]] + views[2:]
    auto = TorchPipeline(cfg, mesh=cpu_mesh(8), shard_axis="auto").run(resumed_views)
    # The tolerance of the relabel (test above): the resumed units fused on
    # the relabeled grid.
    np.testing.assert_allclose(auto.volume, base.volume, rtol=0, atol=1e-12)
    assert auto.views_fused == 8 and auto.volume_sweeps == 3


# -- distributed helpers (single process) -------------------------------------------


def test_distributed_helpers_single_process(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize()
    assert not distributed.is_multihost()
    assert distributed.host_view_slice(10) == range(0, 10)
    vol = np.ones((2, 2, 2), np.float32)
    np.testing.assert_array_equal(distributed.all_sum_volume(vol), vol)
    topo = distributed.topology_summary()
    assert topo["process_index"] == 0 and topo["process_count"] == 1
    assert topo["platform"] == "cpu" and topo["global_devices"] == topo["local_devices"]
    distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0)
    assert not distributed.is_multihost()
    with pytest.raises(ValueError, match="world size"):
        distributed.initialize(coordinator_address="127.0.0.1:1")
