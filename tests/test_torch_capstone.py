"""The port's capstone (``cudadepthmapintegration_torch.scripts.capstone_1024``)
against the JAX package's capstone script and library, on the CPU at small
sizes. Tolerances, and why:

* the camera rig, grid and ray potential: **equal** to the JAX script's
  (``scripts/capstone_1024.py:102-121``), draw for draw from
  ``default_rng(0)`` through the JAX ``look_at_camera``;
* the renderer, float32 against the JAX package's float64
  ``render_sphere_view``: depth within **1e-5 relative** where both hit, hit
  masks differing on at most **0.1 %** of pixels (silhouette pixels), colour
  within **one level** (the truncation to uint8);
* the fused volume: **bit for bit** (int32 view) for any batch size, since
  views are added into each voxel one at a time in order; against the JAX
  float64 oracle and the JAX ``TSDFIntegrator`` through Pallas-interpret
  within the **2e-4 flip budget** (voxels off by more than 1e-3);
* the checkpoint drill: **bit for bit** after the resume;
* the mesh: **bit for bit** the port's ``extract_isosurface(...,
  weld_backend="device")``, median radius in [0.95, 1.05];
* the colour arrays: **equal** to the JAX ``colorize_points`` on the same
  points and views (integer statistics of the same samples).

The module imports neither JAX nor the JAX package (checked in a
subprocess), and ``--device cuda`` with no card raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch.ops.marching_cubes import extract_isosurface
from cudadepthmapintegration_torch.scripts import capstone_1024 as cap
from cudadepthmapintegration_tpu.core import Camera, DepthMapView, RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.ops import TSDFIntegrator, integrate_views_oracle
from cudadepthmapintegration_tpu.ops.coloration import colorize_points
from cudadepthmapintegration_tpu.testing import look_at_camera, render_sphere_view

KP.INTERPRET = True

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS, DIMS, MAP = 24, 33, 64  # two batches of 16 and a short tail
FLIP_BUDGET = 2e-4


@pytest.fixture(scope="module")
def small():
    return cap.run(N_VIEWS, DIMS, "cpu", width=MAP, height=MAP, mesh=False)


@pytest.fixture(scope="module")
def meshed():
    return cap.run(32, 65, "cpu", width=96, height=96)


def jax_scene(scene):
    """The port's scene in the JAX package's classes."""
    grid = VoxelGrid(dims=scene.grid.dims, origin=scene.grid.origin,
                     spacing=scene.grid.spacing)
    return grid, RayPotential(*scene.params.astuple())


def jax_views(scene, depths, colors=None):
    return [DepthMapView(depth=depths[i], camera=Camera(k=c.k, rt=c.rt),
                         color=None if colors is None else colors[i])
            for i, c in enumerate(scene.cameras)]


def off_frac(a, b):
    return float((np.abs(a - b) > 1e-3).mean())


@pytest.mark.parametrize("n_views, width, height", [(24, 64, 64), (7, 1920, 1080)])
def test_rig_equals_the_jax_script(n_views, width, height):
    """The loop of ``scripts/capstone_1024.py:102-121`` with the JAX
    package's ``look_at_camera``."""
    dims = 1025
    scene = cap.capstone_scene(n_views, dims, width, height)
    spacing = 3.2 / (dims - 1)
    assert scene.grid.dims == (dims,) * 3
    assert scene.grid.origin == (-1.63, -1.61, -1.59)
    assert scene.grid.spacing == (spacing,) * 3
    assert scene.params.astuple() == (2.0 * spacing, 0.8, 0.03, 8.0 * spacing)
    rng = np.random.default_rng(0)
    f_scale = width / 512.0
    for i, got in enumerate(scene.cameras):
        a = 2 * np.pi * i / n_views
        r = float(rng.uniform(3.5, 4.5))
        eye = (r * np.cos(a), r * np.sin(a), float(rng.uniform(-1, 1)))
        exp = look_at_camera(eye, (0, 0, 0), focal=f_scale * float(rng.uniform(250, 350)),
                             width=width, height=height)
        np.testing.assert_array_equal(got.k, exp.k)
        np.testing.assert_array_equal(got.rt, exp.rt)


@pytest.mark.parametrize("width, height", [(64, 64), (96, 54)])
def test_renderer_against_render_sphere_view(width, height):
    scene = cap.capstone_scene(12, 33, width, height)
    depths, colors = cap.render_maps(scene, "cpu")
    assert depths.dtype == torch.float32 and colors.dtype == torch.uint8
    assert colors.shape == (12, height, width, 3)
    hits = total = flipped = 0
    for i, cam in enumerate(scene.cameras):
        exp = render_sphere_view(Camera(k=cam.k, rt=cam.rt), width, height)
        got_d, got_c = depths[i].numpy(), colors[i].numpy()
        hit, exp_hit = got_d != -1.0, exp.depth != -1.0
        both = hit & exp_hit
        flipped += int((hit != exp_hit).sum())
        total += hit.size
        hits += int(both.sum())
        np.testing.assert_allclose(got_d[both], exp.depth[both], rtol=1e-5, atol=0)
        assert (got_d[~hit] == -1.0).all()
        diff = np.abs(got_c.astype(int) - exp.color.astype(int))
        assert diff[both].max() <= 1
        assert (got_c[~hit] == 0).all()
    assert hits > 0.05 * total  # the sphere fills part of every map
    assert flipped <= 1e-3 * total


def test_fusion_bitwise_for_any_batch(small):
    exp = small.volume.view(torch.int32)
    assert small.phases["fusion"]["batch"] == cap.BATCH
    for batch in (1, 0):  # one map a launch; every map in one launch
        got = cap.fuse_maps(torch.zeros_like(small.volume), small.tables, small.depths,
                            small.scene.params, batch)
        assert torch.equal(got.view(torch.int32), exp)
    assert float(small.volume.abs().max()) > 0.5


def test_fusion_against_jax_oracle_and_pallas(small):
    grid, params = jax_scene(small.scene)
    views = jax_views(small.scene, small.depths.numpy())
    got = small.volume.numpy()
    oracle = integrate_views_oracle(grid, views, params)
    assert off_frac(got, oracle) <= FLIP_BUDGET
    pallas = TSDFIntegrator(grid, params, backend="pallas").reset().integrate(views).result()
    assert off_frac(got, np.asarray(pallas)) <= FLIP_BUDGET
    assert oracle.max() > 0.5 and oracle.min() < -0.5


def test_checkpoint_drill_bitwise():
    straight, resumed = cap.checkpoint_drill("cpu", n_views=8, dims=17, width=96, height=54)
    assert torch.equal(straight.view(torch.int32), resumed.view(torch.int32))
    assert float(straight.abs().max()) > 0.5
    # Half the views alone give another volume: the drill resumed, it did
    # not start again.
    scene = cap.capstone_scene(8, 17, 96, 54)
    depths, _ = cap.render_maps(scene, "cpu")
    half = cap.fuse_maps(torch.zeros_like(straight), cap.device_tables(scene, "cpu"), depths,
                         scene.params, stop=4)
    assert not torch.equal(half, straight)


def test_mesh_equals_extract_isosurface(meshed):
    mesh = meshed.mesh
    exp = extract_isosurface(meshed.scene.grid, meshed.volume, cap.ISO, weld_backend="device")
    np.testing.assert_array_equal(mesh.points, exp.points)
    np.testing.assert_array_equal(mesh.triangles, exp.triangles)
    assert sorted(mesh.point_data) == sorted(exp.point_data)
    for name, arr in exp.point_data.items():
        np.testing.assert_array_equal(mesh.point_data[name], arr, err_msg=name)
    assert mesh.active_scalars == exp.active_scalars
    radius = np.median(np.linalg.norm(mesh.points, axis=1))
    assert 0.95 <= radius <= 1.05
    phases = meshed.phases
    assert phases["contour"]["triangles"] == mesh.num_triangles > 1000
    assert phases["normals"]["bytes_to_host"] == 4 * 65**3


def test_colours_equal_jax_colorize_points(meshed):
    scene = meshed.scene
    views = jax_views(scene, meshed.depths.numpy(), meshed.colors.numpy())
    exp = colorize_points(meshed.mesh.points, views, backend="xla")
    for got, want, name in zip(meshed.colours, exp, ("mean", "median", "count")):
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (meshed.colours[2] > 0).mean() >= 0.9
    rec = meshed.phases["coloration"]
    assert rec["views"] == 32 and rec["vertices"] == meshed.mesh.num_points
    assert rec["occlusion_test"] is False and rec["regime"] == "staged once"


def test_surface_windows_and_sampled_oracle(small):
    scene = small.scene
    size = 12
    windows = cap.surface_windows(scene.grid, 8, size)
    assert len(set(windows)) == 8
    grid, params = jax_scene(scene)
    depths = small.depths.numpy()
    oracle = integrate_views_oracle(grid, jax_views(scene, depths), params)
    fused = [small.volume[k, j:j + size, i:i + size].numpy() for k, j, i in windows]
    for (k, j, i), win in zip(windows, fused):
        assert win.shape == (size, size)
        exp = oracle[k, j:j + size, i:i + size]
        assert exp.max() > 0.1 and exp.min() < -0.01  # inside and free space
    rec = cap.sampled_oracle(scene, [t.numpy() for t in small.tables], depths, fused, windows)
    exp_off = np.mean([np.abs(w - oracle[k, j:j + size, i:i + size]) > 1e-3
                       for (k, j, i), w in zip(windows, fused)])
    assert rec["voxels"] == 8 * size * size
    assert rec["off_frac"] == pytest.approx(exp_off)
    assert 0 <= rec["off_voxels_with_flip"] <= rec["off_voxels"]
    assert rec["projected_samples"] > 0.5 * rec["voxels"] * N_VIEWS
    assert rec["flip_frac"] <= FLIP_BUDGET
    # A volume shifted by more than the tolerance is off everywhere.
    rec = cap.sampled_oracle(scene, [t.numpy() for t in small.tables], depths,
                             [w + 0.01 for w in fused], windows)
    assert rec["off_frac"] == 1.0
    # Every voxel is off: those with a flipped sample are at most the flips.
    assert rec["off_voxels_with_flip"] <= rec["flipped_samples"]


def phase_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_cli_modes_on_the_cpu(monkeypatch, capsys):
    assert cap.main(["24", "33", "--device", "cpu"]) == 0
    lines = phase_lines(capsys.readouterr().out)
    assert [r["phase"] for r in lines] == ["cameras_tables", "render", "fusion", "cell_to_point",
                                           "contour", "normals", "coloration", "memory"]
    assert all(r["mode"] == "default" and r["card"] == "cpu" for r in lines)
    assert lines[2]["views"] == 24 and lines[2]["cells"] == 32**3
    assert cap.main(["hd", "3", "17", "--device", "cpu"]) == 0
    lines = phase_lines(capsys.readouterr().out)
    assert [r["phase"] for r in lines] == ["cameras_tables", "render", "fusion", "memory"]
    assert lines[1]["map"] == [1920, 1080] and lines[2]["launches"] == 0  # no kernel here
    monkeypatch.setattr(cap, "CKPT_VIEWS", 6)
    monkeypatch.setattr(cap, "CKPT_DIMS", 9)
    monkeypatch.setattr(cap, "HD_MAP", (96, 54))
    assert cap.main(["ckpt", "--device", "cpu"]) == 0
    (rec,) = phase_lines(capsys.readouterr().out)
    assert rec["phase"] == "checkpoint" and rec["bit_equal"] and rec["saved_at_view"] == 3
    for bad in (["ckpt", "3"], ["hd", "x"], ["1", "2", "3"]):
        with pytest.raises(SystemExit):
            cap.main(bad + ["--device", "cpu"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        cap.run(4, 9)
    with pytest.raises(RuntimeError, match="needs a card"):
        cap.checkpoint_drill()


def test_imports_no_jax():
    code = ("import sys; import cudadepthmapintegration_torch.scripts.capstone_1024; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cudadepthmapintegration_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
