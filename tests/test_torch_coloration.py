"""The port's coloration against the JAX package, on the CPU.

The port runs its plain gather here (CPU tensors); the JAX side runs the
Pallas coloration kernel in interpreter mode, as the JAX package's own
tests do, and its XLA gather. Inputs are the JAX package's synthetic views
with seeded random colours, crossing to the port through ``interop``.

Tolerance: none. Mean, median and count must be **equal**: every statistic
is integer work on uint8 samples, and the samples are equal as long as every
vertex lands on the same pixel. On the CPU, XLA contracts the projection's
multiply-adds into fused ones and the port does not, so a pixel could flip
on an exact half-pixel boundary; none does on these inputs, and the test
would show one.
"""

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.kernels.coloration_cuda import (
    gather_colors,
    gather_colors_torch,
)
from cudadepthmapintegration_torch.ops.coloration import (
    colorize_mesh as t_colorize_mesh,
)
from cudadepthmapintegration_torch.ops.coloration import (
    colorize_points as t_colorize_points,
)
from cudadepthmapintegration_tpu.io import PolyData
from cudadepthmapintegration_tpu.kernels.coloration_pallas import (
    gather_colors_pallas,
)
from cudadepthmapintegration_tpu.ops.coloration import colorize_points
from cudadepthmapintegration_tpu.testing import sphere_scene

KP.INTERPRET = True


def scene(n_views=4):
    views = sphere_scene(n_views=n_views, width=144, height=64, focal=60.0)
    rng = np.random.default_rng(7)
    for v in views:
        v.color[:] = rng.integers(0, 256, v.color.shape, dtype=np.uint8)
    return views


def points(n=600, spread=7.0, seed=1):
    """Points in and around the views' frusta, some behind cameras; sorted
    by (z, y, x) like a mesh's raster order."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) - 0.5) * spread
    return pts[np.lexsort(pts.T)]


def _assert_stats_equal(got, exp):
    for name, a, b in zip(("mean", "median", "count"), got, exp):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name


@pytest.mark.parametrize("z_test", [False, True])
def test_statistics_equal_pallas(z_test):
    views, pts = scene(), points()
    exp = colorize_points(pts, views, z_test=z_test, backend="pallas")
    got = t_colorize_points(pts, interop.views_from(views), z_test=z_test, device="cpu")
    assert (exp[2] > 0).any() and (exp[2] == 0).any()
    _assert_stats_equal(got, exp)


@pytest.mark.parametrize("z_test", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_statistics_equal_xla(z_test, dtype):
    views, pts = scene(), points(seed=2)
    exp = colorize_points(pts, views, z_test=z_test, backend="xla", dtype=np.dtype(dtype))
    got = t_colorize_points(pts, interop.views_from(views), z_test=z_test, dtype=dtype, device="cpu")
    _assert_stats_equal(got, exp)


def test_occlusion_tol_equals_xla():
    views = scene()
    pts = points(seed=3, spread=3.0)
    exp = colorize_points(pts, views, backend="xla", occlusion_tol=0.2)
    got = t_colorize_points(pts, interop.views_from(views), occlusion_tol=0.2, device="cpu")
    _assert_stats_equal(got, exp)
    # The test rejected some samples, so it ran.
    assert (got[2] < t_colorize_points(pts, interop.views_from(views), device="cpu")[2]).any()


def test_chunks_do_not_change_values():
    views = interop.views_from(scene(5))
    pts = points(seed=4)
    ref = t_colorize_points(pts, views, device="cpu")
    got = t_colorize_points(pts, views, chunk=97, view_chunk=2, device="cpu")
    _assert_stats_equal(got, ref)


@pytest.mark.parametrize("z_test", [False, True])
def test_gather_equals_pallas_gather(z_test):
    views, pts = scene(3), points(seed=5).astype(np.float32)
    proj = np.stack([(v.camera.k4 @ v.camera.rt)[:3, :] for v in views])
    colors = np.stack([v.color for v in views])
    exp_s, exp_v = (np.asarray(a) for a in gather_colors_pallas(pts, proj, colors, z_test=z_test))
    args = (torch.from_numpy(pts), torch.from_numpy(proj.astype(np.float32)),
            torch.from_numpy(colors))
    got_s, got_v = gather_colors_torch(*args, z_test=z_test)
    assert exp_v.any() and (~exp_v).any()
    np.testing.assert_array_equal(got_v.numpy(), exp_v)
    np.testing.assert_array_equal(got_s.numpy(), exp_s)  # 0 where invalid
    # On CPU tensors the wrapper is the plain version.
    wrap_s, wrap_v = gather_colors(*args, z_test=z_test)
    assert torch.equal(wrap_s, got_s) and torch.equal(wrap_v, got_v)


def test_colorize_mesh_attaches_arrays():
    views = scene(3)
    mesh = PolyData(points(seed=6, spread=2.5), np.zeros((0, 3), np.int64))
    mesh.point_data["Normals"] = np.ones((mesh.num_points, 3), np.float32)
    out = t_colorize_mesh(mesh, interop.views_from(views), device="cpu")
    exp = colorize_points(mesh.points, views, backend="pallas")
    for name, arr in zip(("MeanColoration", "MedianColoration", "NbProjectedDepthMap"), exp):
        np.testing.assert_array_equal(out.point_data[name], arr)
    assert "Normals" in out.point_data and "Normals" in mesh.point_data
    assert "MeanColoration" not in mesh.point_data


def test_no_views_raises():
    with pytest.raises(ValueError, match="no views"):
        t_colorize_points(points(), [], device="cpu")
