"""The port's two CLIs end to end, against the JAX package's CLIs.

Both run in process on one synthetic ``.vti``/``.krtd`` folder: the port
with ``--device cpu`` (its plain PyTorch versions), the JAX package with
``--backend pallas`` (its Pallas kernels in interpreter mode). Tolerances,
and why:

* volume within **1e-3**: the Pallas plan relabels grid axes per
  orientation group on this orbit rig and adds the groups in sorted order
  (see tests/test_torch_integrate.py);
* the same mesh vertex and triangle counts;
* **equal** colour arrays when both coloration CLIs colour the same mesh.

Also here: the port never imports JAX, and nothing falls back — a CUDA run
with no card, a kernel asked for a device it has no kernel for and a build
that cannot run all raise or exit non-zero.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch.cli import colorize as t_colorize
from cudadepthmapintegration_torch.cli import reconstruct as t_reconstruct
from cudadepthmapintegration_torch.kernels import _build
from cudadepthmapintegration_torch.kernels.coloration_cuda import color_stats, gather_colors
from cudadepthmapintegration_torch.kernels.integrate_cuda import integrate_views
from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator as TorchIntegrator
from cudadepthmapintegration_tpu.cli import colorize as j_colorize
from cudadepthmapintegration_tpu.cli import reconstruct as j_reconstruct
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.io import read_mha, read_vtp, read_vts
from cudadepthmapintegration_tpu.io import write_depth_map_vti, write_krtd
from cudadepthmapintegration_tpu.testing import sphere_scene

KP.INTERPRET = True

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("scene")
    views = sphere_scene(n_views=6, width=96, height=72, focal=90.0)
    for i, v in enumerate(views):
        write_depth_map_vti(str(folder / f"f{i:02d}.vti"), v.depth, v.color, v.best_cost)
        write_krtd(str(folder / f"f{i:02d}.krtd"), v.camera)
    (folder / "vtiList.txt").write_text("".join(f"f{i:02d}.vti\n" for i in range(6)))
    (folder / "kList.txt").write_text("".join(f"f{i:02d}.krtd\n" for i in range(6)))
    return folder


def reconstruct_args(folder, out, dims=("26", "22", "18")):
    return [
        "--gridDims", *dims,
        "--gridOrigin", "-1.6", "-1.6", "-1.6",
        "--gridEnd", "1.6", "1.6", "1.6",
        "--rayThick", "0.1", "--rayDelta", "0.3",
        "--threshBestCost", "0.5", "--contour", "0.5",
        "--dataFolder", str(folder),
        "--outputMeshFilename", str(out / "mesh.vtp"),
        "--outputGridFilename", str(out / "grid.vts"),
        "--mhaPath", str(out / "vol.mha"),
    ]


def colorize_args(folder, mesh, out):
    return ["--input", str(mesh), "--output", str(out),
            "--vti", str(folder / "vtiList.txt"), "--krtd", str(folder / "kList.txt")]


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """Both packages' reconstruct CLIs, then both coloration CLIs on the
    JAX package's mesh."""
    out = {}
    for name, cli, extra in (("jax", j_reconstruct, ["--backend", "pallas"]),
                             ("torch", t_reconstruct, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(name)
        assert cli.main(reconstruct_args(dataset, d) + extra) == 0
        out[name] = d
    jmesh = out["jax"] / "mesh.vtp"
    assert j_colorize.main(colorize_args(dataset, jmesh, out["jax"] / "col.vtp")
                           + ["--backend", "pallas"]) == 0
    assert t_colorize.main(colorize_args(dataset, jmesh, out["torch"] / "col.vtp")
                           + ["--device", "cpu"]) == 0
    return out


def test_volumes_agree(runs):
    _, _, jcells = read_vts(str(runs["jax"] / "grid.vts"))
    _, _, tcells = read_vts(str(runs["torch"] / "grid.vts"))
    a, b = jcells["reconstruction_scalar"], tcells["reconstruction_scalar"]
    assert a.shape == b.shape == (25 * 21 * 17,)
    assert np.abs(a).max() > 0.5
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
    (ja, jh), (ta, th) = read_mha(str(runs["jax"] / "vol.mha")), read_mha(str(runs["torch"] / "vol.mha"))
    assert ja.shape == ta.shape == (18, 22, 26)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-3)
    assert jh == {**th, "CompressedDataSize": jh["CompressedDataSize"]}


def test_meshes_agree(runs):
    a = read_vtp(str(runs["jax"] / "mesh.vtp"))
    b = read_vtp(str(runs["torch"] / "mesh.vtp"))
    assert a.num_triangles == b.num_triangles > 100
    assert a.num_points == b.num_points
    assert sorted(a.point_data) == sorted(b.point_data)
    # The JAX CLI contours with the float64 native walker when the native
    # library is built, the port in float32: the points differ in the last
    # float32 bits only (measured 5.96e-8 on this scene).
    np.testing.assert_array_equal(b.triangles, a.triangles)
    np.testing.assert_allclose(b.points, a.points, rtol=0, atol=1e-6)
    radii = np.linalg.norm(b.points, axis=1)
    assert 0.85 < np.median(radii) < 1.1


def test_colour_arrays_equal(runs):
    a = read_vtp(str(runs["jax"] / "col.vtp"))
    b = read_vtp(str(runs["torch"] / "col.vtp"))
    for name in ("MeanColoration", "MedianColoration", "NbProjectedDepthMap"):
        np.testing.assert_array_equal(b.point_data[name], a.point_data[name], err_msg=name)
    assert (b.point_data["NbProjectedDepthMap"] > 0).mean() > 0.9


def test_summary_and_float64(dataset, tmp_path):
    args = reconstruct_args(dataset, tmp_path, dims=("20",))
    assert t_reconstruct.main(args + ["--device", "cpu", "--dtype", "float64", "--summary"]) == 0
    text = (dataset / "summary.txt").read_text()
    assert "--- Views fused : 6" in text and "--- Dimensions : (20, 20, 20)" in text
    assert read_vtp(str(tmp_path / "mesh.vtp")).num_triangles > 100


@pytest.mark.parametrize("bad", [
    ["--gridSpacing", "0.1", "0.1", "0.1"],  # with --gridDims
    ["--rayDelta", "0.05"],  # < rayThick
    ["--rayEta", "1.5"],
])
def test_reconstruct_validation(dataset, tmp_path, bad):
    assert t_reconstruct.main(reconstruct_args(dataset, tmp_path) + bad) == 1


def test_port_never_imports_jax(dataset, tmp_path):
    """A fresh interpreter imports every module of the port and runs both
    CLIs, with any import of JAX made to fail."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys

        class NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("the port imported " + name)

        assert "jax" not in sys.modules
        sys.meta_path.insert(0, NoJax())
        import cudadepthmapintegration_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from cudadepthmapintegration_torch.cli import colorize, reconstruct
        assert reconstruct.main({reconstruct_args(dataset, tmp_path) + ["--device", "cpu"]!r}) == 0
        assert colorize.main({colorize_args(dataset, tmp_path / "mesh.vtp", tmp_path / "c.vtp")
                              + ["--device", "cpu"]!r}) == 0
        print("jax loaded:", sorted(m for m in sys.modules if m.startswith("jax")))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "jax loaded: []" in proc.stdout


@pytest.mark.parametrize("cli", ["reconstruct", "colorize"])
def test_cuda_without_a_card_exits_nonzero(dataset, tmp_path, monkeypatch, capsys, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli == "reconstruct":
        rc = t_reconstruct.main(reconstruct_args(dataset, tmp_path) + ["--device", "cuda"])
    else:
        rc = t_colorize.main(colorize_args(dataset, tmp_path / "m.vtp", tmp_path / "c.vtp"))
    assert rc == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not os.listdir(tmp_path)  # nothing ran


def test_wrappers_raise_for_a_device_without_a_kernel():
    meta = torch.device("meta")
    vol = torch.zeros((4, 3, 2), device=meta)
    tables = [torch.zeros(s, device=meta) for s in ((1, 4, 2), (1, 4, 3), (1, 4, 4), (1, 4))]
    with pytest.raises(ValueError, match="no integrate kernel for device meta"):
        integrate_views(vol, *tables, torch.zeros((1, 5, 5), device=meta), RayPotential())
    with pytest.raises(ValueError, match="no coloration kernel for device meta"):
        gather_colors(torch.zeros((3, 3), device=meta), torch.zeros((1, 3, 4), device=meta),
                      torch.zeros((1, 5, 5), dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="no coloration kernel for device meta"):
        color_stats(torch.zeros((1, 3), dtype=torch.int32, device=meta))
    grid = VoxelGrid(dims=(5, 4, 3), origin=(0, 0, 0), spacing=(1, 1, 1))
    integ = TorchIntegrator(grid, RayPotential(thick=0.1), device=meta).reset()
    with pytest.raises(ValueError, match="no integrate kernel"):
        integ.integrate(sphere_scene(n_views=1, width=16, height=12))


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("CDMI_TORCH_BUILD_DIR", str(tmp_path / "build"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_failed_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'integrate.cu(7): error: something broke' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="something broke"):
        _build.load_library()
    assert not list((tmp_path / "build").glob("*.so"))
