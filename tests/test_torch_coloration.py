"""The port's coloration against the JAX package, on the CPU.

The port runs its plain versions here (CPU tensors): the packed-word gather
and the statistics of ``kernels/coloration_cuda``. The JAX side runs the
Pallas coloration kernel in interpreter mode, as the JAX package's own
tests do, its XLA gather and its XLA reductions. Inputs are the JAX
package's synthetic views with seeded random colours, crossing to the port
through ``interop``, and crafted sample columns
(``testing.color_stat_columns``).

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
import cudadepthmapintegration_torch.ops.coloration as t_coloration
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.kernels.coloration_cuda import (
    color_stats,
    color_stats_torch,
    gather_colors,
    gather_colors_torch,
    split_stats,
    stage_texels,
    unpack_samples,
)
from cudadepthmapintegration_torch.ops.coloration import (
    colorize_mesh as t_colorize_mesh,
)
from cudadepthmapintegration_torch.ops.coloration import (
    colorize_points as t_colorize_points,
)
from cudadepthmapintegration_torch.testing import COLOR_COLUMN_KINDS, color_stat_columns
from cudadepthmapintegration_tpu.io import PolyData
from cudadepthmapintegration_tpu.kernels.coloration_pallas import (
    gather_colors_pallas,
)
from cudadepthmapintegration_tpu.ops.coloration import (
    _batch_sum_count,
    _gather_chunk,
    _median_from_samples,
    colorize_points,
)
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


def _gather_inputs(views, pts):
    proj = np.stack([(v.camera.k4 @ v.camera.rt)[:3, :] for v in views]).astype(np.float32)
    colors = np.stack([v.color for v in views])
    depths = np.stack([v.depth for v in views]).astype(np.float32)
    return proj, colors, depths


@pytest.mark.parametrize("z_test", [False, True])
def test_gather_equals_pallas_gather(z_test):
    views, pts = scene(3), points(seed=5).astype(np.float32)
    proj, colors, _ = _gather_inputs(views, pts)
    exp_s, exp_v = (np.asarray(a) for a in gather_colors_pallas(pts, proj, colors, z_test=z_test))
    h, w = colors.shape[1:3]
    xla_s, xla_v = (np.asarray(a) for a in _gather_chunk(
        pts, proj, colors.reshape(len(views), h * w, 3), h=h, w=w, z_test=z_test))
    args = (torch.from_numpy(pts), torch.from_numpy(proj), stage_texels(torch.from_numpy(colors)))
    words = gather_colors_torch(*args, z_test=z_test)
    assert words.shape == (len(views), len(pts)) and words.dtype == torch.int32
    got_s, got_v = (t.numpy() for t in unpack_samples(words))
    assert exp_v.any() and (~exp_v).any()
    np.testing.assert_array_equal(got_v, exp_v)
    np.testing.assert_array_equal(got_s, exp_s)  # 0 where invalid
    np.testing.assert_array_equal(got_v, xla_v)
    np.testing.assert_array_equal(got_s, xla_s * xla_v[..., None])
    # On CPU tensors the wrapper is the plain version; with out= it writes
    # its rows of a wider buffer and no other.
    assert torch.equal(gather_colors(*args, z_test=z_test), words)
    out = torch.full((len(views) + 3, len(pts)), -7, dtype=torch.int32)
    assert gather_colors(*args, z_test=z_test, out=out, view_offset=2).data_ptr() == out[2].data_ptr()
    assert torch.equal(out[2:-1], words)
    assert (out[:2] == -7).all() and (out[-1] == -7).all()


def test_occluded_gather_equals_xla():
    views, pts = scene(3), points(seed=3, spread=3.0).astype(np.float32)
    proj, colors, depths = _gather_inputs(views, pts)
    n_views, h, w = depths.shape
    exp_s, exp_v = (np.asarray(a) for a in _gather_chunk(
        pts, proj, colors.reshape(n_views, h * w, 3), h=h, w=w, z_test=False, occlusion=True,
        depths_flat=depths.reshape(n_views, h * w), occlusion_tol=np.float32(0.2)))
    args = (torch.from_numpy(pts), torch.from_numpy(proj), stage_texels(torch.from_numpy(colors)))
    got_s, got_v = (t.numpy() for t in unpack_samples(
        gather_colors(*args, depths=torch.from_numpy(depths), occlusion_tol=0.2)))
    plain_v = unpack_samples(gather_colors(*args))[1].numpy()
    assert (got_v < plain_v).any()  # the test rejected some samples
    np.testing.assert_array_equal(got_v, exp_v)
    np.testing.assert_array_equal(got_s, exp_s * exp_v[..., None])


def test_gather_rejects_bad_arguments():
    pts = torch.zeros((4, 3))
    proj = torch.zeros((2, 3, 4))
    texels = torch.zeros((2, 5, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="texels must be"):
        gather_colors(pts, proj, torch.zeros((2, 5, 6, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="do not fit"):
        gather_colors(pts, proj, texels, out=torch.zeros((3, 4), dtype=torch.int32),
                      view_offset=2)
    with pytest.raises(ValueError, match="out must be"):
        gather_colors(pts, proj, texels, out=torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="depths must be"):
        gather_colors(pts, proj, texels, depths=torch.zeros((2, 5, 5)))


def test_stage_texels_gives_back_rgb():
    colors = np.random.default_rng(3).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    texels = stage_texels(torch.from_numpy(colors))
    assert texels.shape == (2, 5, 7) and texels.dtype == torch.int32
    t = texels.numpy()
    for c in range(3):
        np.testing.assert_array_equal((t >> (8 * c)) & 0xFF, colors[..., c])
    assert (t >> 24 == 0).all()


def _jax_stats(words):
    """The JAX package's reductions on unpacked words, then colorize_points'
    truncation to uchar."""
    samples, valid = (t.numpy() for t in unpack_samples(torch.from_numpy(words)))
    sums, cnt = (np.asarray(a) for a in _batch_sum_count(samples, valid))
    mean = sums.astype(np.float64) / np.maximum(cnt[:, None], 1)
    med = np.asarray(_median_from_samples(samples, valid))
    return (np.clip(mean, 0, 255).astype(np.uint8), np.clip(med, 0, 255).astype(np.uint8),
            cnt.astype(np.int32))


@pytest.mark.parametrize("kind", COLOR_COLUMN_KINDS)
@pytest.mark.parametrize("n_views", [1, 2, 17, 300])
def test_color_stats_equals_jax_reductions(n_views, kind):
    words = color_stat_columns(n_views, 96, kinds=(kind,), seed=n_views)
    got = split_stats(color_stats_torch(torch.from_numpy(words)))
    exp = _jax_stats(words)
    _assert_stats_equal([t.numpy() for t in got], exp)
    if kind == "split" and n_views >= 2:
        # The two middle samples lie in different high nibbles.
        assert (np.asarray(got[2]) % 2 == 0).all() and (got[2] >= 2).all()
    if kind in ("none", "one"):
        assert (got[2] == (kind == "one")).all()
    # On a CPU buffer the wrapper is the plain version.
    assert torch.equal(color_stats(torch.from_numpy(words)), color_stats_torch(torch.from_numpy(words)))


def test_color_stats_of_a_column_slice():
    words = torch.from_numpy(color_stat_columns(33, 120, seed=4))
    part = words[:, 17:90]
    assert not part.is_contiguous()
    assert torch.equal(color_stats(part), color_stats(part.contiguous()))
    mean, median, count = split_stats(color_stats(words))
    assert torch.equal(count[17:90], split_stats(color_stats(part))[2])
    assert mean.shape == median.shape == (120, 3) and count.dtype == torch.int32


def test_streaming_regime_equals_default(monkeypatch):
    views = interop.views_from(scene(5))
    pts = points(seed=8)
    ref = t_colorize_points(pts, views, view_chunk=2, device="cpu")
    # No batch fits the budget: every batch is staged again per chunk.
    monkeypatch.setattr(t_coloration, "_STAGED_BUDGET", 0)
    got = t_colorize_points(pts, views, chunk=150, view_chunk=2, device="cpu")
    _assert_stats_equal(got, ref)
    got = t_colorize_points(pts, views, chunk=150, view_chunk=2, occlusion_tol=0.2, device="cpu")
    monkeypatch.undo()
    _assert_stats_equal(got, t_colorize_points(pts, views, view_chunk=2, occlusion_tol=0.2,
                                               device="cpu"))


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


@pytest.mark.parametrize("occlusion_tol", [None, 0.2])
def test_float64_on_cuda_is_refused(occlusion_tol):
    # Refused before anything reaches the device, so it raises on any host.
    with pytest.raises(ValueError, match="float32 only"):
        t_colorize_points(points(), interop.views_from(scene(1)), dtype="float64",
                          occlusion_tol=occlusion_tol, device="cuda")


def test_no_views_raises():
    with pytest.raises(ValueError, match="no views"):
        t_colorize_points(points(), [], device="cpu")
