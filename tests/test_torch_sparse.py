"""The port's sparse RGB-D fusion against the JAX package, on the CPU.

The port's ``SparseTSDFGrid(device="cpu")`` runs the plain PyTorch versions
of the sparse fuse kernel (``kernels/sparse_cuda.py``); the JAX grid runs
either its XLA gather or its Pallas point gather in interpreter mode. Both
get the same views, made with numpy from the synthetic sphere scene.
Tolerances, and why:

* the point gather: **bitwise** (both read the same pixels);
* ``block_map``: **equal** (the host bookkeeping is the same numpy code);
  slot for slot against the XLA backend, by block coordinate against the
  Pallas backend, which allocates in Morton order;
* pools per block coordinate: within **2e-5** on all but **2e-4** of the
  voxels. The allowance is for pixel flips: XLA on the CPU contracts the
  lattice's multiply-adds into fused multiply-adds and the port does not
  (ROADMAP §3), so a voxel projecting onto a half-pixel boundary may read a
  neighbouring pixel;
* ``weight_pool`` within **2e-5** and ``color_pool`` within **5e-3**: the
  JAX package's own cross-program tolerances (tests/test_gather_points.py);
* meshes from identical state: equal triangles, vertices within **1e-6 of
  the extent** (the contraction again, in ``pa + t * (pb - pa)``);
* online vertex colours from identical pools and points: **equal**.
"""

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.kernels.sparse_cuda import gather_pixels_torch, sparse_fuse
from cudadepthmapintegration_torch.ops.oracle import integrate_views_oracle
from cudadepthmapintegration_torch.ops.sparse_grid import SparseTSDFGrid
from cudadepthmapintegration_tpu.core import RayPotential
from cudadepthmapintegration_tpu.kernels.gather_points import gather_pixels_pallas
from cudadepthmapintegration_tpu.ops.sparse_grid import SparseTSDFGrid as JaxGrid
from cudadepthmapintegration_tpu.testing import sphere_scene
from cudadepthmapintegration_tpu.testing.synthetic import look_at_camera

KP.INTERPRET = True

PARAMS = RayPotential(thick=0.06, rho=0.8, eta=0.03, delta=0.2)
T_PARAMS = interop.params_from(PARAMS)
FLIP_ALLOWANCE = 2e-4


def grids(views, jax_backend="xla", **kw):
    """A JAX grid and the port's grid, both fed ``views``."""
    kw = dict(voxel_size=0.08, params=PARAMS, pixel_stride=2, **kw)
    jgrid = JaxGrid(gather_backend=jax_backend, **kw)
    tgrid = SparseTSDFGrid(**{**kw, "params": T_PARAMS}, device="cpu")
    for v in views:
        jgrid.integrate_frame(v)
        tgrid.integrate_frame(interop.view_from(v))
    return jgrid, tgrid


def as_numpy(pool):
    return pool.numpy() if isinstance(pool, torch.Tensor) else np.asarray(pool)


def allocated_mask(grid, shape):
    mask = np.zeros(shape, bool)
    bz, by, bx = grid.block_shape
    lo, _ = grid.allocated_bounds()
    for cx_, cy_, cz_ in grid.block_map:
        iz, iy, ix = (cz_ - lo[2]) * bz, (cy_ - lo[1]) * by, (cx_ - lo[0]) * bx
        mask[iz : iz + bz, iy : iy + by, ix : ix + bx] = True
    return mask


def wall_view(eye, wall_depth=8.0, width=96, height=72, focal=80.0):
    """A view whose every pixel sees a wall at constant camera-space depth:
    everything nearer is free space (the dense kernel carves it)."""
    from cudadepthmapintegration_tpu.core import DepthMapView

    cam = look_at_camera(eye, (0.0, 0.0, 0.0), focal=focal, width=width, height=height)
    return DepthMapView(depth=np.full((height, width), wall_depth), camera=cam, name="wall")


def gather_case_coherent():
    rng = np.random.default_rng(3)
    h, w = 37, 150  # deliberately unaligned
    planes = [rng.standard_normal((h, w)).astype(np.float32) for _ in range(2)]
    n = 1500
    base_v = np.clip((np.arange(n) // 64) % h, 0, h - 1)
    vi = np.clip(base_v + rng.integers(-2, 3, n), 0, h - 1).astype(np.int32)
    ui = rng.integers(0, w, n).astype(np.int32)
    ui[::97] = -1  # invalid sentinel
    return planes, ui, vi, dict(window_rows=16, n_wc=1, n_k=2)


def gather_case_random():
    rng = np.random.default_rng(11)
    h, w = 64, 128
    planes = [rng.standard_normal((h, w)).astype(np.float32)]
    vi = rng.integers(0, h, 1024).astype(np.int32)
    ui = rng.integers(0, w, 1024).astype(np.int32)
    return planes, ui, vi, {}


@pytest.mark.parametrize("case", [gather_case_coherent, gather_case_random])
def test_gather_pixels_bitwise_with_pallas(case):
    planes, ui, vi, tunables = case()
    exp = gather_pixels_pallas(tuple(planes), ui, vi, **tunables)
    got = gather_pixels_torch(tuple(torch.from_numpy(p) for p in planes),
                              torch.from_numpy(ui), torch.from_numpy(vi))
    assert len(got) == len(exp) == len(planes)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    assert (got[0].numpy()[ui < 0] == -1.0).all()


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_grid_matches_jax(jax_backend):
    views = sphere_scene(n_views=3, width=96, height=72, focal=90.0)
    jgrid, tgrid = grids(views, jax_backend, with_color=True)
    assert tgrid.frames_fused == jgrid.frames_fused == 3
    assert tgrid.num_allocated == jgrid.num_allocated > 10
    if jax_backend == "xla":
        assert tgrid.block_map == jgrid.block_map
        assert (tgrid._next_slot, tgrid._free_slots) == (jgrid._next_slot, jgrid._free_slots)
    assert set(tgrid.block_map) == set(jgrid.block_map)
    pools = {}
    for name in ("pool", "weight_pool", "color_pool"):
        j, t = np.asarray(getattr(jgrid, name)), getattr(tgrid, name).numpy()
        pools[name] = [(j[js], t[tgrid.block_map[c]]) for c, js in jgrid.block_map.items()]
    err = np.concatenate([np.abs(j - t).ravel() for j, t in pools["pool"]])
    assert (err > 2e-5).mean() <= FLIP_ALLOWANCE
    assert np.abs(np.concatenate([t.ravel() for _, t in pools["pool"]])).max() > 0.5
    for j, t in pools["weight_pool"]:
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-5)
    for j, t in pools["color_pool"]:
        np.testing.assert_allclose(t, j, rtol=0, atol=5e-3)
    assert tgrid.weight_pool.sum() > 0


def test_dense_matches_float64_oracle():
    views = sphere_scene(n_views=4, width=96, height=72, focal=80.0)
    sparse = SparseTSDFGrid(voxel_size=0.1, params=T_PARAMS, pixel_stride=2, device="cpu")
    for v in interop.views_from(views):
        sparse.integrate_frame(v)
    assert sparse.num_allocated > 10 and sparse.frames_fused == 4
    dense, grid = sparse.to_dense()
    expected = integrate_views_oracle(grid, interop.views_from(views), T_PARAMS)
    mask = allocated_mask(sparse, dense.shape)
    err = np.abs(dense[mask] - expected.astype(np.float32)[mask])
    assert (err > 1e-3).mean() < 1e-6
    # Every surface cell is allocated: the band walk misses no crossing.
    assert (np.abs(expected) > T_PARAMS.rho * 0.5)[~mask].sum() == 0


def test_carving_applies_empty_space_votes_to_earlier_blocks():
    """Blocks allocated by the sphere frame lie in the wall frame's free
    space: carving gives them the wall's -eta*rho vote (dense parity), which
    band-only fusion (carve=False) misses (CudaReconstruction.cu:114-115)."""
    sphere = interop.view_from(sphere_scene(n_views=1, width=96, height=72, focal=80.0)[0])
    wall = interop.view_from(wall_view((0.0, -4.0, 0.0)))
    dense = {}
    for carve in (True, False):
        g = SparseTSDFGrid(voxel_size=0.1, params=T_PARAMS, pixel_stride=2, device="cpu")
        g.preallocate([sphere])  # the wall's band (far plane) stays unallocated
        g.integrate_frame(sphere, carve=carve)
        g.integrate_frame(wall, carve=carve)
        dense[carve], grid = g.to_dense()
    expected = integrate_views_oracle(grid, [sphere, wall], T_PARAMS).astype(np.float32)
    mask = allocated_mask(g, expected.shape)
    np.testing.assert_allclose(dense[True][mask], expected[mask], rtol=0, atol=2e-5)
    vote = T_PARAMS.eta * T_PARAMS.rho
    assert (expected[mask] < -vote * 0.9).any()
    assert np.abs(dense[False][mask] - expected[mask]).max() > vote * 0.5


def test_capacity_exhaustion_raises():
    view = interop.view_from(sphere_scene(n_views=1, width=64, height=48)[0])
    sparse = SparseTSDFGrid(voxel_size=0.05, params=T_PARAMS, capacity=4, device="cpu")
    with pytest.raises(RuntimeError, match="capacity"):
        sparse.integrate_frame(view)


def test_empty_frame_is_noop():
    view = interop.view_from(sphere_scene(n_views=1, width=64, height=48)[0])
    view.depth[:] = -1.0
    sparse = SparseTSDFGrid(voxel_size=0.1, params=T_PARAMS, device="cpu")
    sparse.integrate_frame(view)
    assert sparse.num_allocated == 0 and sparse.frames_fused == 0
    assert not sparse.pool.any()


EVICTIONS = {
    "deep_free_space": lambda g: g.evict_deep_free_space(),
    "far_from_radius": lambda g: g.evict_far_from((0.0, 0.0, 0.0), radius=0.9),
    "far_from_budget": lambda g: g.evict_far_from((0.0, 0.0, 0.0), radius=float("inf"),
                                                  keep_at_most=20),
    "everything": lambda g: g.evict_far_from((0.0, 0.0, 0.0), radius=0.0),
}


@pytest.mark.parametrize("kind", sorted(EVICTIONS))
def test_eviction_matches_jax_and_recycles_slots(kind):
    """Both packages evict the same blocks, zero every pool of the freed
    slots (the online-colour pools included) and recycle the slots the same
    way when the views are fused again."""
    views = sphere_scene(n_views=4, width=96, height=72, focal=80.0)
    jgrid, tgrid = grids(views, with_color=True)
    planted = [(2, -1, -1), (2, 0, -1), (2, -1, 0), (2, 0, 0)]
    walls = [wall_view((0.0, -5.0, 0.0)), wall_view((-5.0, 0.0, 0.0))]
    for g, wrap in ((jgrid, lambda v: v), (tgrid, interop.view_from)):
        # Planted free-space blocks that two wall views drive to -2*eta*rho,
        # the default floor of evict_deep_free_space.
        g._allocate(planted)
        for w in walls:
            g.integrate_frame(wrap(w))
    n0 = tgrid.num_allocated
    evicted = EVICTIONS[kind](tgrid)
    assert evicted == EVICTIONS[kind](jgrid) > 0
    assert tgrid.block_map == jgrid.block_map and tgrid._free_slots == jgrid._free_slots
    assert tgrid.num_allocated == n0 - evicted and len(tgrid._free_slots) == evicted
    if kind == "deep_free_space":
        assert not set(planted) & set(tgrid.block_map)
    if kind == "far_from_budget":
        assert tgrid.num_allocated == 20
    freed = torch.as_tensor(tgrid._free_slots)
    for pool in (tgrid.pool, tgrid.color_pool, tgrid.weight_pool):
        assert not pool[freed].any()
    for v in views:
        jgrid.integrate_frame(v)
        tgrid.integrate_frame(interop.view_from(v))
    assert tgrid.block_map == jgrid.block_map
    assert tgrid._next_slot == jgrid._next_slot <= n0 + 1


def test_extract_mesh_matches_jax_on_identical_state():
    views = sphere_scene(n_views=8, width=96, height=72, focal=80.0)
    jgrid = JaxGrid(voxel_size=0.08, params=PARAMS, pixel_stride=2, with_color=True,
                    gather_backend="xla")
    for v in views:
        jgrid.integrate_frame(v)
    tgrid = interop.sparse_grid_from(jgrid, device="cpu")
    exp = jgrid.extract_mesh(iso=1.0, backend="jax")
    got = tgrid.extract_mesh(iso=1.0)
    assert got.num_triangles == exp.num_triangles > 100
    assert got.num_points == exp.num_points
    np.testing.assert_array_equal(got.triangles, exp.triangles)
    extent = np.ptp(exp.points, axis=0).max()
    np.testing.assert_allclose(got.points, exp.points, rtol=0, atol=1e-6 * extent)
    np.testing.assert_allclose(got.point_data["Normals"], exp.point_data["Normals"], atol=1e-4)
    radii = np.linalg.norm(got.points, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.08
    # Online colours from the same pools at the same points are equal.
    for g, e in zip(tgrid.vertex_colors(exp.points), jgrid.vertex_colors(exp.points)):
        np.testing.assert_array_equal(g, e)
    coloured = tgrid.extract_colored_mesh(iso=1.0)
    assert (coloured.point_data["ColorWeight"] > 0).mean() > 0.98


def test_per_block_mesh_has_no_allocation_boundary_junk():
    """A carved (all-negative) block next to unallocated space emits
    nothing at iso=0: the fabricated 0.0 of unallocated cells is not data."""
    sparse = SparseTSDFGrid(voxel_size=0.1, params=T_PARAMS, device="cpu")
    sparse._allocate([(0, 0, 0), (2, 2, 2)])
    sparse.pool[:2] = -1.0
    mesh = sparse.extract_mesh(iso=0.0)
    assert mesh.num_triangles == 0
    assert mesh.point_data["Normals"].shape == (0, 3)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    views = sphere_scene(n_views=3, width=64, height=48, focal=60.0)
    kw = dict(voxel_size=0.1, pixel_stride=2, with_color=True)
    path = str(tmp_path / "g.npz")
    if writer == "jax":
        src = JaxGrid(params=PARAMS, gather_backend="xla", **kw)
        for v in views:
            src.integrate_frame(v)
        src._free_slots.append(src.block_map.pop(sorted(src.block_map)[0]))
        src.save(path, extra={"next_index": 7})
        dst, extra = SparseTSDFGrid.load(path, device="cpu")
    else:
        src = SparseTSDFGrid(params=T_PARAMS, **kw, device="cpu")
        for v in interop.views_from(views):
            src.integrate_frame(v)
        src.evict_blocks([sorted(src.block_map)[0]])
        src.save(path, extra={"next_index": 7})
        dst, extra = JaxGrid.load(path, gather_backend="xla")
    assert extra == {"next_index": 7}
    assert dst.block_map == src.block_map and dst.frames_fused == src.frames_fused == 3
    assert (dst._free_slots, dst._next_slot) == (src._free_slots, src._next_slot)
    assert (dst.voxel_size, dst.block_shape, dst.capacity) == (src.voxel_size, src.block_shape,
                                                               src.capacity)
    assert dst.params.astuple() == src.params.astuple()
    used = slice(0, src._next_slot)
    for name in ("pool", "color_pool", "weight_pool"):
        got, exp = (as_numpy(getattr(g, name))[used] for g in (dst, src))
        np.testing.assert_array_equal(got, exp)


def test_vertex_colors_requires_with_color():
    sparse = SparseTSDFGrid(voxel_size=0.1, params=T_PARAMS, device="cpu")
    with pytest.raises(ValueError, match="with_color"):
        sparse.vertex_colors(np.zeros((1, 3)))


def test_sparse_fuse_raises_for_a_device_without_a_kernel():
    meta = torch.device("meta")
    args = [torch.zeros(s, device=meta) for s in ((4, 8, 8, 8), (2,), (2, 3), (4, 4), (3, 8),
                                                   (6, 5))]
    args[1] = args[1].int()
    with pytest.raises(ValueError, match="no sparse fuse kernel for device meta"):
        sparse_fuse(*args, T_PARAMS)
    with pytest.raises(ValueError, match="rgb needs color_pool"):
        sparse_fuse(*args, T_PARAMS, rgb=torch.zeros((6, 5, 3), dtype=torch.uint8))
