"""The port's BASELINE config 3 pipeline
(``cudadepthmapintegration_torch.scripts.pipeline_e2e``) against the JAX
library functions that the JAX ``scripts/pipeline_e2e.py`` calls, on the CPU
at a small size (33 points an axis, 8 views of 256x256; the rig's focal of
300 keeps the sphere inside maps of 256). Tolerances, and why:

* the grid, ray potential and cameras: **equal** to the JAX script's
  (``scripts/pipeline_e2e.py:80-88``, the JAX ``orbit_cameras``);
* the fused volume: **bit for bit** (int32 view) the port's plain version
  for any batch size (views are added into each voxel one at a time, in
  order); against the JAX ``TSDFIntegrator`` through Pallas-interpret,
  streamed as the JAX script streams, within the **2e-4 flip budget**
  (voxels off by more than 1e-3);
* the mesh against the JAX soup (``marching_cubes(backend="jax",
  _return_soup=True)``) and ``_weld_triangle_soup`` on the same volume:
  **equal** triangles, points within **1e-6 of the extent** (XLA on the CPU
  contracts ``a*b + c`` into an FMA, the port never does);
* the normals: within **1e-6**;
* the colours: **equal** to the JAX ``colorize_points(backend="pallas")``
  (integer statistics of the same samples);
* the ``.mha`` and ``.vtp``: **byte for byte** the JAX writers' on the same
  arrays.

The module imports neither JAX nor the JAX package (checked in a
subprocess), and ``--device cuda`` with no card raises.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch.ops.cell_to_point import cell_to_point
from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator
from cudadepthmapintegration_torch.scripts import pipeline_e2e as pe
from cudadepthmapintegration_tpu.core import Camera, DepthMapView, RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.io.mha import write_mha
from cudadepthmapintegration_tpu.io.polydata import PolyData, write_vtp
from cudadepthmapintegration_tpu.ops.cell_to_point import cell_to_point as jax_cell_to_point
from cudadepthmapintegration_tpu.ops.coloration import colorize_points
from cudadepthmapintegration_tpu.ops.integrate import TSDFIntegrator as JaxIntegrator
from cudadepthmapintegration_tpu.ops.marching_cubes import _weld_triangle_soup, marching_cubes
from cudadepthmapintegration_tpu.ops.normals import normals_for_edge_keys, transform_normals
from cudadepthmapintegration_tpu.testing import orbit_cameras

KP.INTERPRET = True

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS, N_VIEWS, MAP = 33, 8, 256
FLIP_BUDGET = 2e-4
PHASES = ["render_host", "device_warmup", "fuse_streamed", "cell_to_point", "volume_d2h",
          "write_mha", "marching_cubes", "normals_host", "colorize", "write_vtp"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    out = tmp_path_factory.mktemp("e2e")
    res = pe.run(DIMS, N_VIEWS, "cpu", out_dir=str(out), width=MAP, height=MAP)
    return res, out


def jax_scene(res):
    grid = VoxelGrid(dims=res.grid.dims, origin=res.grid.origin, spacing=res.grid.spacing)
    views = [DepthMapView(depth=v.depth, camera=Camera(k=v.camera.k, rt=v.camera.rt),
                          color=v.color) for v in res.views]
    return grid, RayPotential(*res.params.astuple()), views


def off_frac(a, b):
    return float((np.abs(a - b) > 1e-3).mean())


@pytest.mark.parametrize("dims, n_views, width", [(513, 200, 512), (33, 8, 256)])
def test_rig_equals_the_jax_script(dims, n_views, width):
    """``scripts/pipeline_e2e.py:80-88`` with the JAX package's classes."""
    grid, params = pe.e2e_grid(dims)
    spacing = 3.2 / (dims - 1)
    exp = VoxelGrid(dims=(dims,) * 3, origin=(-1.63, -1.61, -1.59), spacing=(spacing,) * 3)
    assert grid.dims == exp.dims and grid.origin == exp.origin and grid.spacing == exp.spacing
    exp_params = RayPotential(thick=2.0 * exp.spacing[0], rho=0.8, eta=0.03,
                              delta=8.0 * exp.spacing[0])
    assert params.astuple() == exp_params.astuple()
    cams = pe.e2e_cameras(n_views, width, width)
    want = orbit_cameras(n_views, 4.0, focal=300.0, width=width, image_height=width)
    assert len(cams) == len(want) == n_views
    for got, exp_cam in zip(cams, want):
        np.testing.assert_array_equal(got.k, exp_cam.k)
        np.testing.assert_array_equal(got.rt, exp_cam.rt)


def test_record_phases_and_gates(small):
    res, _ = small
    rec = res.record
    assert list(rec["phases"]) == PHASES
    assert {"config", "phases", "total_s", "mesh", "volume_checksum", "gates",
            "note"} <= set(rec)
    assert rec["card"] == "cpu" and rec["device"] == "cpu"
    assert rec["phases"]["fuse_streamed"]["mb_moved"] == N_VIEWS * MAP * MAP * 4 / 1e6
    assert rec["phases"]["fuse_streamed"]["event_s"] is None  # no card: no events
    assert rec["mesh"]["points"] == res.mesh.num_points > 100
    assert all(rec["checks"].values()), rec["checks"]
    assert rec["gates"]["coloration_hit_frac"] >= 0.9


@pytest.mark.parametrize("batch", [1, 3, 0])
def test_volume_bitwise_for_any_batch(small, batch):
    res, _ = small
    intg = TSDFIntegrator(res.grid, res.params, device="cpu").reset()
    step = batch or N_VIEWS
    for s in range(0, N_VIEWS, step):
        intg.integrate(res.views[s:s + step])
    assert torch.equal(intg.volume.view(torch.int32), res.volume.view(torch.int32))
    rec = pe.check_volume(res)
    assert rec["plain_equal_bits"] and rec["staged_equal_bits"] and rec["max_abs_err"] == 0.0
    assert rec["kernel_launches"] == 1 and rec["kernel_event_s"] is None


def test_volume_against_jax_pallas(small):
    res, _ = small
    grid, params, views = jax_scene(res)
    intg = JaxIntegrator(grid, params, backend="pallas", view_batch=8, group_fill=32).reset()
    for s in range(0, N_VIEWS, 32):
        intg.integrate(views[s:s + 32])
    intg.flush()
    got = res.volume.numpy()
    assert off_frac(got, np.asarray(intg.result())) <= FLIP_BUDGET
    assert got.max() > 0.5 and got.min() < -0.5


def jax_mesh(res):
    """The JAX script's marching_cubes and normals_host phases on the port's
    volume."""
    pv = jax_cell_to_point(jnp.asarray(res.volume.numpy()))
    xs, ys, zs = res.grid.point_axes(np.float32)
    verts, keys = marching_cubes(pv, 1.0, xs, ys, zs, backend="jax", _return_soup=True)
    mesh, uniq = _weld_triangle_soup(verts, keys, res.grid.matrix, return_keys=True)
    nrm = normals_for_edge_keys(np.asarray(pv), xs, ys, zs, uniq, 1.0)
    return mesh, transform_normals(nrm, res.grid.matrix)


def test_mesh_and_normals_against_the_jax_phases(small):
    res, _ = small
    mesh, normals = jax_mesh(res)
    np.testing.assert_array_equal(res.mesh.triangles, mesh.triangles)
    np.testing.assert_allclose(res.mesh.points, mesh.points, rtol=0, atol=1e-6 * pe.EXTENT)
    np.testing.assert_allclose(res.mesh.point_data["Normals"], normals, rtol=0, atol=1e-6)
    radius = np.median(np.linalg.norm(res.mesh.points, axis=1))
    assert abs(radius - 1.0) < 0.02


def test_colours_equal_jax_colorize_points(small):
    res, _ = small
    _, _, views = jax_scene(res)
    exp = colorize_points(res.mesh.points, views, backend="pallas")
    for name, want in zip(("MeanColoration", "MedianColoration", "NbProjectedDepthMap"), exp):
        np.testing.assert_array_equal(res.mesh.point_data[name], want, err_msg=name)


def test_written_files_equal_the_jax_writers(small, tmp_path):
    res, out = small
    pv = cell_to_point(res.volume).numpy()
    write_mha(str(tmp_path / "v.mha"), pv.astype(np.float64), origin=res.grid.origin,
              spacing=res.grid.spacing, compress=True)
    assert (out / pe.MHA_NAME).read_bytes() == (tmp_path / "v.mha").read_bytes()
    mesh = PolyData(res.mesh.points, res.mesh.triangles)
    mesh.point_data = dict(res.mesh.point_data)
    mesh.active_scalars = res.mesh.active_scalars
    write_vtp(str(tmp_path / "m.vtp"), mesh)
    assert (out / pe.VTP_NAME).read_bytes() == (tmp_path / "m.vtp").read_bytes()


def test_main_writes_the_record_only_with_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert pe.main(["33", "8", "--device", "cpu"]) == 0
    assert os.listdir(tmp_path) == []  # nothing written without --out / --out-dir
    last = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(last)
    assert rec["ok"] and rec["config"].startswith("32^3 x 8 views 512x512")
    record = tmp_path / "rec.json"
    assert pe.main(["33", "8", "--device", "cpu", "--out", str(record), "--out-dir",
                    str(tmp_path / "files")]) == 0
    assert json.loads(record.read_text())["phases"].keys() == set(PHASES)
    assert sorted(os.listdir(tmp_path / "files")) == sorted([pe.MHA_NAME, pe.VTP_NAME])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        pe.run(9, 2)
    with pytest.raises(RuntimeError, match="needs a card"):
        pe.main(["9", "2"])


def test_imports_no_jax():
    code = ("import sys; import cudadepthmapintegration_torch.scripts.pipeline_e2e; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cudadepthmapintegration_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
