"""The port's TSDF integration against the JAX package, on the CPU.

The port runs its plain PyTorch version here (CPU tensors); the JAX side
runs the Pallas kernel in interpreter mode, as the JAX package's own tests
do, or the float64 oracle. Inputs come from the JAX package's synthetic
scenes and cross to the port through ``interop``.

Tolerances, and why:

* **Bitwise** against ``TSDFIntegrator(backend="pallas")`` on a rig whose
  views all choose the identity axis permutation: both evaluate
  ``ty + (tx + (tz + tc))``, IEEE division and the same where-chain in
  float32, and add views into each voxel one at a time in the given order.
* **1e-3** on a mixed orbit rig: the Pallas plan relabels the grid axes per
  orientation group (so its table sum associates differently, by an ulp)
  and adds the groups in sorted order. 1e-3 is the bound the JAX package
  holds its own kernel to against the oracle (tests/test_pallas_kernel.py).
* **1e-9** at float64 against the oracle, which projects each voxel center
  through the matrices in another order: the JAX package's own tolerance
  (tests/test_integrate.py).
* **Bitwise, in int32 view**, between the CUDA kernel's order of evaluation
  (float4 rows from ``stage_tables``, columns of ``KZ`` voxels along z with a
  masked tail) written in plain torch and ``integrate_views_torch``: both
  make the same float32 operations on the same values. The int32 view tells
  ``-0.0`` from ``+0.0``, which ``torch.equal`` does not.
"""

import re

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch import interop
import cudadepthmapintegration_torch.kernels.integrate_cuda as IC
from cudadepthmapintegration_torch.core.ray_potential import ray_potential_torch
from cudadepthmapintegration_torch.kernels._build import CSRC
from cudadepthmapintegration_torch.kernels.integrate_cuda import (
    integrate_views,
    integrate_views_torch,
    round_half_away,
    stage_tables,
)
from cudadepthmapintegration_torch.ops.integrate import (
    TSDFIntegrator as TorchIntegrator,
)
from cudadepthmapintegration_torch.ops.integrate import projection_tables
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.ops import TSDFIntegrator, integrate_views_oracle
from cudadepthmapintegration_tpu.testing import (
    look_at_camera,
    render_sphere_view,
    sphere_scene,
)

KP.INTERPRET = True

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)

GRIDS = {
    "cubic": dict(dims=(17, 17, 17), origin=(-1.6,) * 3, spacing=(0.2,) * 3),
    "odd": dict(dims=(23, 19, 13), origin=(-1.6, -1.5, -1.4),
                spacing=(0.15, 0.17, 0.24)),
}


def make_grid(name="cubic"):
    return VoxelGrid(**GRIDS[name])


def identity_rig(n, width=96, height=48, seed=11):
    """n views with eyes on the -y side (small jitter): every one chooses
    the identity axis permutation, so the Pallas plan keeps the grid's own
    axes and the given view order."""
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(n):
        eye = (float(rng.uniform(-0.5, 0.5)), -4.0 + float(rng.uniform(-0.3, 0.3)),
               float(rng.uniform(-0.5, 0.5)))
        cam = look_at_camera(eye, (0.0, 0.0, 0.0), focal=55.0,
                             width=width, height=height)
        views.append(render_sphere_view(cam, width, height))
    perms = {KP.best_axis_permutation(v.camera.rt[:3, :3]) for v in views}
    assert perms == {(2, 1, 0)}, f"fixture broke: {perms}"
    return views


def pallas_fuse(grid, views, threshold=None):
    return (
        TSDFIntegrator(grid, PARAMS, backend="pallas").reset()
        .integrate(views, threshold).result()
    )


def port_fuse(grid, views, threshold=None, dtype=torch.float32, initial=None):
    return (
        TorchIntegrator(interop.grid_from(grid), interop.params_from(PARAMS),
                        dtype=dtype, device="cpu")
        .reset(initial)
        .integrate(interop.views_from(views), threshold)
        .result()
    )


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_identity_rig_bitwise_vs_pallas(grid_name):
    grid = make_grid(grid_name)
    views = identity_rig(6)
    exp = pallas_fuse(grid, views)
    got = port_fuse(grid, views)
    assert got.dtype == np.float32 and got.shape == grid.volume_shape
    assert np.abs(exp).max() > 0.5  # the scene reaches the grid
    np.testing.assert_array_equal(got, exp)


def test_mixed_rig_vs_pallas_and_oracle():
    views = sphere_scene(n_views=4, width=144, height=64, focal=60.0)
    grid = make_grid()
    got = port_fuse(grid, views)
    np.testing.assert_allclose(got, pallas_fuse(grid, views), rtol=0, atol=1e-3)
    oracle = integrate_views_oracle(grid, views, PARAMS)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-3)
    assert oracle.max() > 0.5


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_float64_matches_oracle(grid_name):
    views = sphere_scene(n_views=3, width=96, height=72, focal=90.0)
    grid = make_grid(grid_name)
    got = port_fuse(grid, views, dtype=torch.float64)
    assert got.dtype == np.float64
    exp = integrate_views_oracle(grid, views, PARAMS)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-9)


def test_best_cost_threshold():
    views = identity_rig(4)
    rng = np.random.default_rng(3)
    for v in views:
        v.best_cost = rng.uniform(0.0, 1.0, v.depth.shape)
    grid = make_grid()
    got = port_fuse(grid, views, threshold=0.5)
    np.testing.assert_array_equal(got, pallas_fuse(grid, views, threshold=0.5))
    # The threshold changed the result, so it was applied.
    assert not np.array_equal(got, port_fuse(grid, views))
    exp = integrate_views_oracle(grid, views, PARAMS, threshold_best_cost=0.5)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-3)


def test_shape_check_raises_within_and_across_calls():
    grid = interop.grid_from(make_grid())
    params = interop.params_from(PARAMS)
    small = interop.views_from(sphere_scene(n_views=2, width=64, height=48))
    large = interop.views_from(sphere_scene(n_views=1, width=80, height=48))
    with pytest.raises(ValueError, match="has shape"):
        TorchIntegrator(grid, params, device="cpu").reset().integrate(small + large)
    integ = TorchIntegrator(grid, params, device="cpu").reset().integrate(small)
    with pytest.raises(ValueError, match="expected \\(48, 64\\)"):
        integ.integrate(large)
    # A reset starts a new run, which may use other maps.
    integ.reset().integrate(large)
    assert integ.views_fused == 1


def test_reset_resumes_from_jax_volume():
    """Half the views fused by the JAX Pallas integrator, the other half by
    the port on top of that volume: the same bits as one straight run."""
    grid = make_grid("odd")
    views = identity_rig(6)
    first = pallas_fuse(grid, views[:3])
    resumed = port_fuse(grid, views[3:], initial=first)
    np.testing.assert_array_equal(resumed, port_fuse(grid, views))


def test_reset_copies_initial_and_result_is_a_copy():
    grid = interop.grid_from(make_grid())
    initial = np.ones(grid.volume_shape, np.float32)
    integ = TorchIntegrator(grid, interop.params_from(PARAMS), device="cpu").reset(initial)
    out = integ.result()
    integ.integrate(interop.views_from(identity_rig(2)))
    assert (initial == 1).all() and (out == 1).all()
    with pytest.raises(ValueError, match="initial volume has shape"):
        integ.reset(np.zeros((2, 2, 2), np.float32))


def test_batches_equal_one_call():
    """Streamed batches add views in the same per-voxel order as one call."""
    grid = interop.grid_from(make_grid("odd"))
    views = interop.views_from(sphere_scene(n_views=5, width=96, height=72))
    params = interop.params_from(PARAMS)
    one = TorchIntegrator(grid, params, device="cpu").reset().integrate(views).result()
    integ = TorchIntegrator(grid, params, device="cpu").reset()
    for s in range(0, 5, 2):
        integ.integrate(views[s : s + 2])
    np.testing.assert_array_equal(integ.result(), one)
    assert integ.views_fused == 5


def test_plain_slabs_do_not_change_values(monkeypatch):
    grid = interop.grid_from(make_grid("odd"))
    views = interop.views_from(sphere_scene(n_views=3, width=96, height=72))
    params = interop.params_from(PARAMS)
    ref = TorchIntegrator(grid, params, device="cpu").reset().integrate(views).result()
    monkeypatch.setattr(IC, "_PLAIN_SLAB_VOXELS", 7)  # one z slice per slab
    got = TorchIntegrator(grid, params, device="cpu").reset().integrate(views).result()
    np.testing.assert_array_equal(got, ref)


def test_wrapper_on_cpu_is_the_plain_version():
    grid = interop.grid_from(make_grid())
    views = interop.views_from(sphere_scene(n_views=2, width=96, height=72))
    t = projection_tables(grid, views, np.float32)
    args = [torch.from_numpy(a) for a in (t.tx, t.ty, t.tz, t.tc)]
    depths = torch.from_numpy(np.stack([v.depth for v in views]).astype(np.float32))
    params = interop.params_from(PARAMS)
    a = integrate_views(torch.zeros(grid.volume_shape), *args, depths, params)
    b = integrate_views_torch(torch.zeros(grid.volume_shape), *args, depths, params)
    assert torch.equal(a, b)


def test_projection_tables_match_jax():
    from cudadepthmapintegration_tpu.ops.integrate import (
        projection_tables as jax_tables,
    )

    grid = make_grid("odd")
    views = sphere_scene(n_views=3)
    exp = jax_tables(grid, views, np.float32)
    got = projection_tables(interop.grid_from(grid), interop.views_from(views))
    for name in ("tx", "ty", "tz", "tc"):
        np.testing.assert_array_equal(getattr(got, name), getattr(exp, name))


def test_oracle_copy_matches_jax_oracle():
    from cudadepthmapintegration_torch.ops.oracle import (
        integrate_views_oracle as port_oracle,
    )

    grid = make_grid("odd")
    views = sphere_scene(n_views=3)
    exp = integrate_views_oracle(grid, views, PARAMS, threshold_best_cost=0.5)
    got = port_oracle(interop.grid_from(grid), interop.views_from(views),
                      interop.params_from(PARAMS), threshold_best_cost=0.5)
    np.testing.assert_array_equal(got, exp)


# The column height csrc/integrate.cu is built with.
KZ = int(re.search(r"#define CDMI_INTEGRATE_KZ (\d+)",
                   (CSRC / "integrate.cu").read_text()).group(1))
# The kernel's columns: cz = 44 leaves a masked tail for every KZ > 4.
STAGED_GRIDS = {
    **GRIDS,
    "cz44": dict(dims=(6, 5, 45), origin=(-1.6, -1.5, -1.63),
                 spacing=(0.6, 0.7, 3.2 / 44)),
    "cz128": dict(dims=(4, 3, 129), origin=(-0.9, -0.8, -1.6),
                  spacing=(0.6, 0.7, 3.2 / 128)),
}
NEG_ZERO = -(1 << 31)  # the int32 bits of -0.0


def kernel_order_fuse(volume, tab_x, tab_y, tab_zc, depths, params, kz):
    """``csrc/integrate.cu``'s evaluation in plain torch: columns of ``kz``
    voxels along z, the last one masked (it repeats its last row, and those
    sums are not stored); per view the float4 rows ``tab_x[i]``, ``tab_y[j]``
    and ``tab_zc[k]``; an off-map sample reads depth -1; every sample adds
    its potential or ``+0.0``."""
    n_views, h, w = depths.shape
    flat = depths.reshape(n_views, h * w)
    zero = torch.zeros((), dtype=volume.dtype)
    for k0 in range(0, volume.shape[0], kz):
        nk = min(kz, volume.shape[0] - k0)
        ks = [k0 + min(kk, nk - 1) for kk in range(kz)]
        acc = volume[ks].clone()  # (kz, cy, cx)
        for view in range(n_views):
            zc = tab_zc[view, ks]  # (kz, 4)
            hom = [tab_y[view, :, r][None, :, None]
                   + (tab_x[view, :, r][None, None, :] + zc[:, r][:, None, None])
                   for r in range(4)]
            u = round_half_away(hom[0] / hom[2])
            v = round_half_away(hom[1] / hom[2])
            in_map = (hom[2] >= 0) & (u >= 0) & (v >= 0) & (u < w) & (v < h)
            pix = torch.where(in_map, v * w + u, zero).to(torch.int64)
            d = torch.where(in_map, flat[view][pix], -1.0)
            pot = ray_potential_torch(hom[3], d, params)
            acc += torch.where(d != -1.0, pot, zero)
        volume[k0 : k0 + nk] = acc[:nk]
    return volume


def staged_case(grid_name, initial=0.0):
    grid = interop.grid_from(VoxelGrid(**STAGED_GRIDS[grid_name]))
    views = interop.views_from(sphere_scene(n_views=3, width=96, height=72, focal=90.0))
    t = projection_tables(grid, views, np.float32)
    tables = [torch.from_numpy(a) for a in (t.tx, t.ty, t.tz, t.tc)]
    depths = torch.from_numpy(np.stack([v.depth for v in views]).astype(np.float32))
    return torch.full(grid.volume_shape, initial), tables, depths


def test_stage_tables_layout():
    _, (tx, ty, tz, tc), _ = staged_case("odd")
    tab_x, tab_y, tab_zc = stage_tables(tx, ty, tz, tc)
    for tab, t in ((tab_x, tx), (tab_y, ty), (tab_zc, tz)):
        assert tab.shape == (t.shape[0], t.shape[2], 4) and tab.is_contiguous()
    assert torch.equal(tab_x, tx.transpose(1, 2))
    assert torch.equal(tab_y, ty.transpose(1, 2))
    # One float32 add per (view, k), the first add of ty + (tx + (tz + tc)).
    exp = (tz.numpy() + tc.numpy()[:, :, None]).transpose(0, 2, 1)
    np.testing.assert_array_equal(tab_zc.numpy().view(np.int32), exp.view(np.int32))


@pytest.mark.parametrize("grid_name", sorted(STAGED_GRIDS))
def test_kernel_order_from_staged_tables_bitwise(grid_name):
    volume, tables, depths = staged_case(grid_name)
    params = interop.params_from(PARAMS)
    exp = integrate_views_torch(volume.clone(), *tables, depths, params)
    got = kernel_order_fuse(volume.clone(), *stage_tables(*tables), depths, params, KZ)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    assert float(exp.abs().max()) > 0.5  # the scene reaches the grid


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_negative_zero_voxels_come_out_positive_zero(grid_name):
    """An invalid or far sample adds +0.0, which turns a -0.0 voxel into
    +0.0: the kernel may not skip that add."""
    volume, tables, depths = staged_case(grid_name, initial=-0.0)
    assert (volume.view(torch.int32) == NEG_ZERO).all()
    params = interop.params_from(PARAMS)
    exp = integrate_views_torch(volume.clone(), *tables, depths, params)
    got = kernel_order_fuse(volume.clone(), *stage_tables(*tables), depths, params, KZ)
    bits = got.view(torch.int32)
    assert torch.equal(bits, exp.view(torch.int32))
    assert not (bits == NEG_ZERO).any()
    assert (bits == 0).any()  # some voxels ended exactly +0.0
