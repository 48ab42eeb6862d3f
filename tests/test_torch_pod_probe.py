"""The port's z-slab scaling probe (``cudadepthmapintegration_torch.scripts.
pod_probe``) against the JAX ``scripts/pod_probe.py``, on the CPU at a small
size (33 points an axis, 8 views of 64x64, ``--local 2`` and 4). What is
held, and how:

* the workload, the ray potential, the grid and the rig: **equal** to the
  JAX script's (``scripts/pod_probe.py:81-89, 102-116``), the maps too
  (both render in float64 NumPy);
* the scale gate: every slab count's volume **bit for bit** (int32 view)
  the single slab's, and that one the plain ``TSDFIntegrator``'s and the
  plain kernel's on the same staged inputs; one flipped bit fails the
  latter;
* the checkpoint round trip: **exact** (the volume in int32 view, the views
  fused, the grid and ray potential);
* two processes joined by gloo, each rendering half of the maps: after the
  ``all_reduce`` each fuses the volume of one process that rendered them
  all, to an **equal** float64 checksum.

The module imports neither JAX nor the JAX package (checked in a
subprocess), and ``--device cuda`` with no card raises.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator
from cudadepthmapintegration_torch.parallel import make_mesh
from cudadepthmapintegration_torch.scripts import pod_probe as pp
from cudadepthmapintegration_tpu.core import VoxelGrid
from cudadepthmapintegration_tpu.testing import orbit_cameras, render_sphere_view

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (33, 8, 64, 64)


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX script as a module: it reads ``--local`` from the command
    line when imported, and pytest's has none."""
    spec = importlib.util.spec_from_file_location(
        "jax_pod_probe", os.path.join(REPO, "scripts", "pod_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert not mod.LOCAL
    return mod


def test_workload_equals_the_jax_script(jax_probe):
    p = jax_probe.PARAMS
    assert pp.PARAMS.astuple() == (p.thick, p.rho, p.eta, p.delta)
    assert pp.WORKLOAD == (jax_probe.DIMS, jax_probe.N_VIEWS, jax_probe.W, jax_probe.H)
    assert pp.CPU_WORKLOAD == (65, 16, 128, 96)  # the JAX --local shrink, :86-89


def test_scene_equals_the_jax_build():
    dims, n, w, h = 33, 4, 64, 48
    grid, views, io_s = pp.build_scene(dims, n, w, h)
    exp = VoxelGrid(dims=(dims,) * 3, origin=(-1.6,) * 3, spacing=(3.2 / (dims - 1),) * 3)
    assert grid.dims == exp.dims and grid.origin == exp.origin and grid.spacing == exp.spacing
    cams = orbit_cameras(n, 4.0, focal=0.6 * w, width=w, image_height=h)
    for got, cam in zip(views, cams):
        want = render_sphere_view(cam, w, h, radius=1.0, background=-1.0)
        np.testing.assert_array_equal(got.camera.k, cam.k)
        np.testing.assert_array_equal(got.camera.rt, cam.rt)
        np.testing.assert_array_equal(got.depth, want.depth)
    assert io_s > 0


@pytest.mark.parametrize("local", [2, 4])
def test_scale_bitwise_and_exact_round_trip(monkeypatch, local):
    monkeypatch.setattr(pp, "CPU_WORKLOAD", SMALL)
    rec = pp.run(pp.PHASES, local=local, device="cpu")
    assert rec["ok"] and rec["gates"] == {"scale_bitwise": True, "scale_equals_plain": True,
                                          "round_trip_exact": True}
    rows = rec["phases"]["scale"]["rows"]
    assert [r["p"] for r in rows] == [p for p in (1, 2, 4) if p <= local]
    assert [r["gate"] for r in rows] == ["ref"] + ["BITWISE-OK"] * (len(rows) - 1)
    assert rec["phases"]["stage"]["p"] == local
    resume = rec["phases"]["resume"]
    assert resume["slabs"] == local and resume["stripe_views"] == SMALL[1]
    assert resume["volume_bytes"] == 4 * (SMALL[0] - 1) ** 3
    assert rec["devices"] == ["cpu"] * local and rec["card"] == "cpu"


def test_one_slab_equals_the_plain_integrator():
    grid, views, _ = pp.build_scene(*SMALL)
    _, _, vol, equal = pp.fuse_once(grid, views, make_mesh(n_z=1, devices=["cpu"]), reps=0,
                                    plain=True)
    exp = TSDFIntegrator(grid, pp.PARAMS, device="cpu").reset().integrate(views).result()
    np.testing.assert_array_equal(vol.view(np.int32), exp.view(np.int32))
    assert vol.max() > 0.5 and equal is True


def test_a_slab_off_the_plain_version_fails_the_gate(monkeypatch):
    plain_volume = pp.plain_volume

    def flipped(intg, staged):  # the plain slabs with one bit of one voxel flipped
        slabs = plain_volume(intg, staged)
        slabs[-1].view(torch.int32).view(-1)[7] ^= 1
        return slabs

    monkeypatch.setattr(pp, "CPU_WORKLOAD", SMALL)
    monkeypatch.setattr(pp, "plain_volume", flipped)
    rec = pp.run(("scale",), local=2, device="cpu")
    assert rec["gates"] == {"scale_bitwise": True, "scale_equals_plain": False}
    assert not rec["ok"]


def test_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(pp, "CPU_WORKLOAD", SMALL)
    assert pp.main(["scale", "stage", "--local", "2", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln.get("phase") for ln in lines] == ["scale", "stage", None]
    assert list(lines[-1]["phases"]) == ["scale", "stage"] and lines[-1]["ok"]
    with pytest.raises(SystemExit):
        pp.main(["scales", "--device", "cpu"])
    with pytest.raises(ValueError, match="positive"):
        pp.main(["--local", "0", "--device", "cpu"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_share_the_maps():
    # Two thread pools the size of the host would oversubscribe it: the plain
    # version's many small ops then run ten times slower.
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cudadepthmapintegration_torch.scripts.pod_probe", "scale",
         "resume", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, COORDINATOR_ADDRESS=coord, WORLD_SIZE="2", RANK=str(rank),
                 OMP_NUM_THREADS="2"))
        for rank in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    grid, views, _ = pp.build_scene(*pp.CPU_WORKLOAD)
    _, _, vol, _ = pp.fuse_once(grid, views, make_mesh(n_z=1, devices=["cpu"]), reps=0)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["topology"]["process_count"] == 2
        assert rec["topology"]["process_index"] == rank
        assert rec["phases"]["scale"]["volume_checksum"] == float(vol.sum(dtype=np.float64))
        resume = rec["phases"]["resume"]
        assert (resume["process"], resume["processes"]) == (rank, 2)
        assert resume["stripe_views"] == pp.CPU_WORKLOAD[1] // 2
        assert resume["round_trip_exact"]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        pp.run(("scale",))
    with pytest.raises(RuntimeError, match="needs a card"):
        pp.main(["scale", "--local", "2"])


def test_imports_no_jax():
    code = ("import sys; import cudadepthmapintegration_torch.scripts.pod_probe; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cudadepthmapintegration_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
