"""The port's RGB-D readers and ``fuse_rgbd`` CLI against the JAX package.

The TUM and ScanNet readers decode the fixtures that tests/test_tum.py and
tests/test_scannet.py build (TUM's PNGs need PIL; the ``.sens`` stream
keeps raw colour) and must return the JAX readers' frames exactly.
The CLIs run in process on the CPU (``--device cpu`` for the port, the XLA
gather for the JAX package) on the same ``.vti``/``.krtd`` or TUM folder.
Tolerances, and why:

* reader frames: **equal** (the same numpy decoding);
* CLI meshes: equal triangle counts and triangles, vertices within **1e-6
  of the extent** (XLA on the CPU contracts multiply-adds, the port does
  not; see tests/test_torch_sparse.py), online ``ColorWeight`` within
  **2e-5 per unit of weight**, and mean colours within **1** (a uint8
  truncation of a mean that differs in its last bits);
* ``--checkpoint`` resume against an uninterrupted run of the same package:
  **bitwise**.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch.cli import fuse_rgbd as t_fuse
from cudadepthmapintegration_torch.io import ScanNetSensDataset as TSens
from cudadepthmapintegration_torch.io import TUMDataset as TTum
from cudadepthmapintegration_torch.io import TUMIntrinsics as TIntr
from cudadepthmapintegration_torch.io import quaternion_to_rotation as t_quat
from cudadepthmapintegration_tpu.cli import fuse_rgbd as j_fuse
from cudadepthmapintegration_tpu.io import read_vtp, write_depth_map_vti, write_krtd
from cudadepthmapintegration_tpu.io.scannet import ScanNetSensDataset as JSens
from cudadepthmapintegration_tpu.io.tum import TUMDataset as JTum
from cudadepthmapintegration_tpu.io.tum import TUMIntrinsics as JIntr
from cudadepthmapintegration_tpu.io.tum import quaternion_to_rotation as j_quat
from cudadepthmapintegration_tpu.testing import sphere_scene
from test_scannet import write_sens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS = 6
COMMON = ["--voxelSize", "0.1", "--pixelStride", "2", "--contour", "1.0"]


@pytest.fixture(scope="module")
def views():
    return sphere_scene(n_views=N_VIEWS, width=64, height=48, focal=60.0)


@pytest.fixture(scope="module")
def vti_folder(views, tmp_path_factory):
    folder = tmp_path_factory.mktemp("vti")
    for i, v in enumerate(views):
        write_depth_map_vti(str(folder / f"f{i:02d}.vti"), v.depth, v.color)
        write_krtd(str(folder / f"f{i:02d}.krtd"), v.camera)
    (folder / "vtiList.txt").write_text("".join(f"f{i:02d}.vti\n" for i in range(N_VIEWS)))
    (folder / "kList.txt").write_text("".join(f"f{i:02d}.krtd\n" for i in range(N_VIEWS)))
    return folder


@pytest.fixture(scope="module")
def tum_folder(views, tmp_path_factory):
    pytest.importorskip("PIL")
    from test_tum import make_tum_dir

    folder = tmp_path_factory.mktemp("tum")
    make_tum_dir(folder, views)
    return folder


def vti_args(folder):
    return ["--vti", str(folder / "vtiList.txt"), "--krtd", str(folder / "kList.txt"), *COMMON]


TUM_CUSTOM = ["--intrinsics", "custom", "--fx", "60", "--fy", "60", "--cx", "32", "--cy", "24"]


def assert_frames_equal(got, exp):
    for name in ("depth", "color", "name"):
        np.testing.assert_array_equal(getattr(got, name), getattr(exp, name), err_msg=name)
    np.testing.assert_array_equal(got.camera.k, exp.camera.k)
    np.testing.assert_array_equal(got.camera.rt, exp.camera.rt)


def test_quaternion_and_presets_match_jax():
    for q in ((0, 0, 0, 1), (0.1, -0.7, 0.3, 0.6), (1, 2, 3, 4)):
        np.testing.assert_array_equal(t_quat(*q), j_quat(*q))
    for n in (1, 2, 3):
        np.testing.assert_array_equal(TIntr.freiburg(n).k(), JIntr.freiburg(n).k())
    assert TIntr() == TIntr.freiburg(1)


def test_tum_reader_matches_jax(tum_folder):
    t = TTum(str(tum_folder), intrinsics=TIntr(60.0, 60.0, 32.0, 24.0))
    j = JTum(str(tum_folder), intrinsics=JIntr(60.0, 60.0, 32.0, 24.0))
    assert len(t) == len(j) == N_VIEWS and t.frames == j.frames
    for i in range(N_VIEWS):
        assert_frames_equal(t[i], j[i])
    assert (t[0].depth == -1.0).any() and t[0].color.dtype == np.uint8


def test_scannet_reader_matches_jax(views, tmp_path):
    path = str(tmp_path / "scene.sens")
    write_sens(path, views, color_mode="raw")
    t, j = TSens(path), JSens(path)
    assert len(t) == len(j) == N_VIEWS and t.sensor_name == j.sensor_name == "synthetic"
    for i in range(N_VIEWS):
        assert_frames_equal(t[i], j[i])
    tc, jc = t.color_views(), j.color_views()
    assert len(tc) == len(jc) == N_VIEWS
    for i in (0, N_VIEWS - 1):
        np.testing.assert_array_equal(tc[i].color, jc[i].color)
        np.testing.assert_array_equal(tc[i].camera.rt, jc[i].camera.rt)
        assert tc[i].depth.shape == jc[i].depth.shape


def run_both(args, tmp_path, name):
    """Both packages' fuse_rgbd on ``args``; returns their meshes."""
    out = {}
    for pkg, cli, extra in (("jax", j_fuse, []), ("torch", t_fuse, ["--device", "cpu"])):
        path = str(tmp_path / f"{pkg}_{name}.vtp")
        assert cli.main([*args, "--output", path, *extra]) == 0
        out[pkg] = read_vtp(path)
    return out["jax"], out["torch"]


def assert_meshes_match(exp, got):
    assert got.num_triangles == exp.num_triangles > 20
    np.testing.assert_array_equal(got.triangles, exp.triangles)
    extent = np.ptp(exp.points, axis=0).max()
    np.testing.assert_allclose(got.points, exp.points, rtol=0, atol=1e-6 * extent)
    assert sorted(got.point_data) == sorted(exp.point_data)
    radii = np.linalg.norm(got.points, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.15


RUNS = {
    "plain": [],
    "blockBudget": ["--blockBudget", "64"],
    "onlineColor": ["--onlineColor"],
    "colorize": ["--colorize"],
    "occlusionTol": ["--colorize", "--occlusionTol", "0.2"],
    "frameStride": ["--frameStride", "2", "--maxFrames", "2"],
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_fuse_rgbd_matches_jax(vti_folder, tmp_path, run):
    exp, got = run_both(vti_args(vti_folder) + RUNS[run], tmp_path, run)
    assert_meshes_match(exp, got)
    if run == "onlineColor":
        w_exp, w_got = exp.point_data["ColorWeight"], got.point_data["ColorWeight"]
        np.testing.assert_allclose(w_got, w_exp, rtol=2e-5, atol=2e-5)
        assert (w_got > 0).mean() > 0.9
        diff = got.point_data["MeanColoration"].astype(int) - exp.point_data["MeanColoration"]
        assert np.abs(diff).max() <= 1 and got.point_data["MeanColoration"].max() > 0
    if run in ("colorize", "occlusionTol"):
        for name in ("MeanColoration", "MedianColoration", "NbProjectedDepthMap"):
            np.testing.assert_array_equal(got.point_data[name], exp.point_data[name], err_msg=name)
    if run == "occlusionTol":
        plain = run_both(vti_args(vti_folder) + RUNS["colorize"], tmp_path, "plain_colour")[1]
        a = plain.point_data["NbProjectedDepthMap"]
        b = got.point_data["NbProjectedDepthMap"]
        # Occlusion rejection only shrinks counts, and on a closed sphere
        # it rejects something (back-side views are occluded).
        assert (b <= a).all() and b.sum() < a.sum() and b.max() >= 1


@pytest.mark.parametrize("source", ["tum", "sens"])
def test_fuse_rgbd_tum_and_sens_inputs(views, tmp_path, request, source):
    if source == "tum":
        args = ["--tum", str(request.getfixturevalue("tum_folder")), *TUM_CUSTOM]
    else:
        args = ["--sens", str(tmp_path / "scene.sens")]
        write_sens(args[1], views, color_mode="raw")
    exp, got = run_both([*args, *COMMON, "--colorize"], tmp_path, source)
    assert_meshes_match(exp, got)
    assert (got.point_data["NbProjectedDepthMap"] > 0).mean() > 0.9


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fuse_rgbd_checkpoint_resume(vti_folder, tmp_path, writer):
    """Three frames, a checkpoint (written by either package), then the
    port resumes the rest: the mesh equals an uninterrupted port run."""
    base = vti_args(vti_folder) + ["--onlineColor"]
    ref = str(tmp_path / "ref.vtp")
    assert t_fuse.main(base + ["--output", ref, "--device", "cpu"]) == 0
    ck = str(tmp_path / "grid.ckpt.npz")
    first = [*base, "--output", str(tmp_path / "half.vtp"), "--checkpoint", ck,
             "--checkpointEvery", "2", "--maxFrames", "3"]
    if writer == "torch":
        assert t_fuse.main(first + ["--device", "cpu"]) == 0
    else:
        assert j_fuse.main(first) == 0
    resumed = str(tmp_path / "resumed.vtp")
    assert t_fuse.main(base + ["--output", resumed, "--checkpoint", ck, "--device", "cpu"]) == 0
    a, b = read_vtp(ref), read_vtp(resumed)
    if writer == "torch":
        np.testing.assert_array_equal(b.points, a.points)
        np.testing.assert_array_equal(b.point_data["ColorWeight"], a.point_data["ColorWeight"])
    else:
        assert_meshes_match(a, b)
    np.testing.assert_array_equal(b.triangles, a.triangles)
    # A checkpoint from another configuration is refused.
    assert t_fuse.main([*base[:4], "--voxelSize", "0.2", *base[6:], "--output", resumed,
                        "--checkpoint", ck, "--device", "cpu"]) == 1


VALIDATION = {
    "no input": ([], "exactly one of"),
    "two inputs": (["--tum", "x", "--vti", "y"], "exactly one of"),
    "vti without krtd": (["--vti", "a.txt"], "--vti requires --krtd"),
    "bad extension": (["--tum", "x", "--output", "m.obj"], "Bad output extension"),
    "exclusive colour": (["--tum", "x", "--colorize", "--onlineColor"], "exclusive"),
    "delta below thick": (["--tum", "x", "--rayThick", "0.5", "--rayDelta", "0.1"],
                          "Error arguments."),
    "custom intrinsics": (["--tum", "x", "--intrinsics", "custom"], "requires --fx"),
    "missing dataset": (["--tum", "no/such/dir"], "Error : "),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_fuse_rgbd_validation(tmp_path, capsys, case):
    args, message = VALIDATION[case]
    if "--output" not in args:
        args = [*args, "--output", str(tmp_path / "m.vtp")]
    args = [str(tmp_path / a) if a in ("x", "no/such/dir") else a for a in args]
    assert t_fuse.main([*args, "--device", "cpu"]) == 1
    assert message in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_fuse_rgbd_cuda_without_a_card_exits_nonzero(vti_folder, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = t_fuse.main(vti_args(vti_folder) + ["--output", str(tmp_path / "m.vtp")])
    assert rc == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not os.listdir(tmp_path)  # nothing ran


def test_fuse_rgbd_never_imports_jax(vti_folder, tmp_path):
    """A fresh interpreter imports the CLI and the sparse grid and runs
    ``fuse_rgbd --device cpu``, with any import of JAX made to fail."""
    args = vti_args(vti_folder) + ["--output", str(tmp_path / "m.vtp"), "--onlineColor",
                                   "--device", "cpu"]
    code = textwrap.dedent(f"""
        import importlib.abc, sys

        class NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("the port imported " + name)

        assert "jax" not in sys.modules
        sys.meta_path.insert(0, NoJax())
        import cudadepthmapintegration_torch.ops.sparse_grid
        from cudadepthmapintegration_torch.cli import fuse_rgbd
        assert fuse_rgbd.main({args!r}) == 0
        print("jax loaded:", sorted(m for m in sys.modules if m.startswith("jax")))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "jax loaded: []" in proc.stdout
    assert read_vtp(str(tmp_path / "m.vtp")).num_triangles > 20
