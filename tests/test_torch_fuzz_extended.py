"""The port's extended fuzz (``cudadepthmapintegration_torch.scripts.
fuzz_extended``) against the JAX package, on the CPU. Tolerances, and why:

* ``random_scene``: **equal**, draw for draw, to the JAX package's
  ``tests/test_fuzz_parity.py::random_scene`` (grid, ray potential, every
  map and camera) over the parametrised seeds;
* the coloured scenes: the port's ``colorize_points`` on the script's
  random colours and points **equal** to the JAX ``colorize_points``
  (integer statistics of the same samples), with and without the
  occlusion test;
* the script's own thresholds, as the JAX script's: the plain float64
  version within **1e-9** of the oracle, the native float64 fusion within
  **1e-12**, every float32 route **bit for bit** with the plain version and
  fewer than **5e-3** of the voxels off the oracle by more than 1e-3, the
  colour arrays **equal**, the device contour against the native walker with
  points to **1e-12** and triangles and normals **bit for bit**.

A few seeds pass every check on the CPU; a route that flips one bit of the
volume, or a coloration that shifts one colour, fails its check and the
script exits 1. The module imports neither JAX nor the JAX package (checked
in a subprocess), and ``--device cuda`` with no card raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch.scripts import fuzz_extended as fz
from cudadepthmapintegration_tpu.core import Camera, DepthMapView
from cudadepthmapintegration_tpu.ops.coloration import colorize_points
from test_fuzz_parity import random_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSING_SEEDS = [1000, 1001, 1002]


@pytest.mark.parametrize("seed", [1, 2, 5, 11, 21, 1000, 1042, 1099])
def test_random_scene_equals_the_jax_generator(seed):
    grid, views, params = fz.random_scene(seed)
    exp_grid, exp_views, exp_params = random_scene(seed)
    assert grid.dims == tuple(exp_grid.dims)
    np.testing.assert_array_equal(grid.origin, exp_grid.origin)
    np.testing.assert_array_equal(grid.spacing, exp_grid.spacing)
    assert params.astuple() == exp_params.astuple()
    assert len(views) == len(exp_views)
    for got, exp in zip(views, exp_views):
        assert got.depth.dtype == exp.depth.dtype == np.float64
        np.testing.assert_array_equal(got.depth, exp.depth)
        np.testing.assert_array_equal(got.camera.k, exp.camera.k)
        np.testing.assert_array_equal(got.camera.rt, exp.camera.rt)


def jax_views(views):
    return [DepthMapView(depth=v.depth, camera=Camera(k=v.camera.k, rt=v.camera.rt),
                         color=v.color) for v in views]


@pytest.mark.parametrize("seed", [1000, 1007])
def test_coloured_scenes_against_jax_colorize_points(seed):
    """The script's draws of colours and points (``seed ^ 0xC0105`` and
    ``seed ^ 0x0CC1``) through the port's plain route and the JAX one."""
    views, rng = fz._coloured_scene(seed, 0xC0105)
    pts = (rng.random((int(rng.integers(50, 700)), 3)) - 0.5) * 6.0
    got = fz.plain_colours(pts, views, "cpu")
    exp = colorize_points(pts, jax_views(views), backend="xla", dtype=np.float32)
    for name, a, b in zip(("mean", "median", "count"), got, exp):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got[2] > 0).any()
    views, rng = fz._coloured_scene(seed, 0x0CC1)
    pts = (rng.random((int(rng.integers(50, 400)), 3)) - 0.5) * 6.0
    tol = float(rng.uniform(0.0, 0.5))
    _, _, counts = colorize_points(pts, jax_views(views), dtype=np.float64, occlusion_tol=tol)
    np.testing.assert_array_equal(fz.occlusion_counts_np(pts, views, tol), counts)


@pytest.mark.parametrize("check", fz.CHECKS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("seed", PASSING_SEEDS)
def test_seeds_pass_every_check_on_the_cpu(seed, check):
    assert check(seed, torch.device("cpu")) == []


def test_main_on_the_cpu(capsys):
    assert fz.main(["3", "1000", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == "done: 0 failing seeds of 3"
    rec = json.loads(out[-1])
    assert rec["failures"] == 0 and rec["seeds"] == 3 and rec["card"] == "cpu"
    assert rec["seed_list"] == [1000, 1001, 1002]
    assert rec["native"]  # the native library builds here: its checks ran


def test_a_flipped_bit_fails(monkeypatch, capsys):
    real = fz.integrate_views

    def flipped(volume, *args):
        out = real(volume, *args)
        out.view(torch.int32).view(-1)[0] ^= 1
        return out

    monkeypatch.setattr(fz, "integrate_views", flipped)
    assert "kernel_not_bitident" in fz.check(1000, torch.device("cpu"))
    assert fz.main(["1", "1000", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "seed 1000: FAIL" in out and "kernel_not_bitident" in out
    assert json.loads(out.strip().splitlines()[-1])["failing"]["1000"] == ["kernel_not_bitident"]


def test_a_shifted_colour_fails(monkeypatch, capsys):
    real = fz.colorize_points

    def shifted(*args, **kwargs):
        mean, median, count = real(*args, **kwargs)
        mean = mean.copy()
        mean[0, 0] ^= 1
        return mean, median, count

    monkeypatch.setattr(fz, "colorize_points", shifted)
    assert fz.check_coloration(1000, torch.device("cpu")) == ["coloration_mean"]
    assert "occlusion_route" in fz.check_occlusion(1000, torch.device("cpu"))
    assert fz.main(["1", "1000", "--device", "cpu"]) == 1
    assert "seed 1000: FAIL" in capsys.readouterr().out


def test_padded_grid_keeps_the_scene_cells():
    grid, _, _ = fz.random_scene(1003)
    for n in fz.SLABS:
        padded = fz._padded(grid, n)
        assert padded.volume_shape[0] % n == 0
        cz = grid.volume_shape[0]
        for a, b in zip(padded.cell_center_axes(), grid.cell_center_axes()):
            np.testing.assert_array_equal(a[:len(b)], b)
        assert padded.volume_shape[1:] == grid.volume_shape[1:]
        assert padded.volume_shape[0] - cz < n


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        fz.run(range(1000, 1001))
    with pytest.raises(RuntimeError, match="needs a card"):
        fz.main(["1"])


def test_imports_no_jax():
    code = ("import sys; import cudadepthmapintegration_torch.scripts.fuzz_extended; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cudadepthmapintegration_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
