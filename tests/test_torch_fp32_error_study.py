"""The port's float32 error study (``cudadepthmapintegration_torch.scripts.
fp32_error_study``) against the JAX ``scripts/fp32_error_study.py``, on the
CPU at small view counts. Tolerances, and why:

* ``build``: grid, ray potential and cameras **equal** to the JAX script's,
  and the rendered maps **equal** (both render in float64 NumPy with the
  same operations);
* ``fp32_oracle``: **bit for bit** the JAX script's at two counts (the
  same oracle values rounded to float32, summed in the same order);
* ``prefix_sums``: **bit for bit** the float64 oracle and ``fp32_oracle``
  of each prefix of the views;
* ``_common.kernel_flips``, the one flipped-sample rule: **exact** masks on
  samples built to sit on each of its edges (a pixel's half, a map's border,
  -0.0, a negative z, NaN and infinite pixels), from NumPy and from tensors;
* ``flip_counts``: **equal** counts to the capstone's ``sampled_oracle``
  (the same float32 and float64 projections, counted over whole slices);
* the route rows: the plain version on the CPU, its error and shares
  against the float64 oracle as the script reports them, and each count's
  route volume bit for bit the plain version's; a route that flips one bit
  is reported as unequal.

The module imports neither JAX nor the JAX package (checked in a
subprocess), and ``--device cuda`` with no card raises.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch.kernels.integrate_cuda import integrate_views_torch
from cudadepthmapintegration_torch.ops.integrate import projection_tables
from cudadepthmapintegration_torch.ops.oracle import integrate_views_oracle
from cudadepthmapintegration_torch.scripts import capstone_1024 as cap
from cudadepthmapintegration_torch.scripts._common import kernel_flips
from cudadepthmapintegration_torch.scripts import fp32_error_study as fp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_study():
    """The JAX script as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fp32_error_study", os.path.join(REPO, "scripts", "fp32_error_study.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_equals_the_jax_script(jax_study):
    grid, views, params = fp.build(3)
    exp_grid, exp_views, exp_params = jax_study.build(3)
    assert grid.dims == tuple(exp_grid.dims)
    assert grid.origin == tuple(exp_grid.origin) and grid.spacing == tuple(exp_grid.spacing)
    assert params.astuple() == exp_params.astuple()
    for got, exp in zip(views, exp_views):
        np.testing.assert_array_equal(got.camera.k, exp.camera.k)
        np.testing.assert_array_equal(got.camera.rt, exp.camera.rt)
        np.testing.assert_array_equal(got.depth, exp.depth)


@pytest.mark.parametrize("n", [2, 5])
def test_fp32_oracle_equals_the_jax_script(jax_study, n):
    grid, views, params = fp.build(n)
    got = fp.fp32_oracle(grid, views, params)
    exp = jax_study.fp32_oracle(*jax_study.build(n))
    assert got.dtype == exp.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), exp.view(np.int32))
    assert np.abs(got).max() > 0.5


def test_prefix_sums_equal_the_oracles():
    grid, views, params = fp.build(4)
    seen = []
    for n, exp, got in fp.prefix_sums(grid, views, params, (1, 3, 4)):
        seen.append(n)
        want = integrate_views_oracle(grid, views[:n], params)
        np.testing.assert_array_equal(exp.view(np.int64), want.view(np.int64))
        want32 = fp.fp32_oracle(grid, views[:n], params)
        np.testing.assert_array_equal(got.view(np.int32), want32.view(np.int32))
    assert seen == [1, 3, 4]


# (u64, v64, z64), the kernel's float32 (x, y, z) rows, projected, flipped;
# on a map of 4 x 3 pixels.
FLIP_CASES = [
    ((1.2, 1.4, 1.0), (1.2, 1.4, 1.0), True, False),  # the same pixel
    ((1.49, 1.0, 1.0), (1.51, 1.0, 1.0), True, True),  # across a pixel's half
    ((3.4, 0.0, 1.0), (3.6, 0.0, 1.0), True, True),  # off the map's right edge
    ((-0.6, 0.0, 1.0), (-0.4, 0.0, 1.0), True, True),  # -0.0 is on the map
    ((-0.5, 0.0, 1.0), (-0.5, 0.0, 1.0), False, False),  # rounds away to -1
    ((1.0, 1.0, -1.0), (-1.0, -1.0, -1.0), False, False),  # behind the camera
    ((np.nan, np.nan, 0.0), (0.0, 0.0, 0.0), False, False),  # 0 / 0
    ((np.inf, np.inf, 0.0), (1.0, 1.0, 0.0), False, False),  # x / 0
    ((2.5, 2.5, 1.0), (2.4, 2.4, 1.0), True, True),  # rounds to row 3 of 3
]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_kernel_flips_rule(kind):
    u64, v64, z64 = (np.array(c, np.float64) for c in zip(*(c[0] for c in FLIP_CASES)))
    hom32 = [np.array(r, np.float32) for r in zip(*(c[1] for c in FLIP_CASES))]
    if kind == "torch":
        u64, v64, z64 = (torch.from_numpy(a) for a in (u64, v64, z64))
        hom32 = [torch.from_numpy(r) for r in hom32]
    (px, py, on64), (projected, flipped) = kernel_flips(u64, v64, z64, hom32, 4, 3)
    assert [bool(x) for x in projected] == [c[2] for c in FLIP_CASES]
    assert [bool(x) for x in flipped] == [c[3] for c in FLIP_CASES]
    assert [bool(x) for x in on64] == [True, True, True, False, False, False, False, False,
                                       False]
    assert [float(x) for x in px[:4]] == [1.0, 1.0, 3.0, -1.0]


def test_flip_counts_equal_the_capstone_sampled_oracle():
    grid, views, params = fp.build(3)
    t = projection_tables(grid, views, np.float32)
    tables = (t.tx, t.ty, t.tz, t.tc)
    projected, flipped = fp.flip_counts(grid, views, tables, torch.device("cpu"))
    cz, cy, cx = grid.volume_shape
    assert cy == cx
    depths = np.stack([v.depth for v in views]).astype(np.float32)
    vol = integrate_views_torch(torch.zeros(grid.volume_shape),
                                *(torch.from_numpy(a) for a in (*tables, depths)),
                                params).numpy()
    scene = cap.Scene(grid, params, [v.camera for v in views], 256, 192)
    windows = [(k, 0, 0) for k in range(cz)]
    rec = cap.sampled_oracle(scene, tables, depths, [vol[k] for k in range(cz)], windows)
    assert int(projected.sum()) == rec["projected_samples"] > 0.5 * cz * cy * cx * 3
    assert int(flipped.sum()) == rec["flipped_samples"]


def test_run_and_main_on_the_cpu(capsys):
    assert fp.main(["--counts", "2", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert out[-2].startswith("PASS: max fp32 accumulation error at 4 views")
    assert rec["verdict"] == "PASS" and rec["route"] == "plain version"
    assert [r["views"] for r in rec["rows"]] == [r["views"] for r in rec["kernel_rows"]] == [2, 4]
    for row in rec["kernel_rows"]:
        assert 0 <= row["flipped_samples"] <= row["projected_samples"]
        assert row["flip_frac"] <= 2e-4 and row["off_frac"] <= 2e-4
    assert rec["rows"][-1]["max_err"] < rec["budget"] == 0.01 * 0.8
    assert all(row["plain_equal_bits"] for row in rec["kernel_rows"])
    with pytest.raises(SystemExit):
        fp.main(["--counts", "--device", "cpu"])


def test_a_route_off_the_plain_version_is_reported(monkeypatch):
    def flipped(volume, *args):  # the plain version with one bit of one voxel flipped
        out = integrate_views_torch(volume, *args)
        out.view(torch.int32).view(-1)[7] ^= 1
        return out

    monkeypatch.setattr(fp, "integrate_views", flipped)
    rec = fp.run((2,), "cpu")
    assert [row["plain_equal_bits"] for row in rec["kernel_rows"]] == [False]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        fp.run((2,))
    with pytest.raises(RuntimeError, match="needs a card"):
        fp.main(["--counts", "2"])


def test_imports_no_jax():
    code = ("import sys; import cudadepthmapintegration_torch.scripts.fp32_error_study; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cudadepthmapintegration_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
