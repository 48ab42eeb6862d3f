"""The port's resumable fusion (``pipeline/checkpoint.py``,
``pipeline/runner.py``, ``reconstruct --checkpoint``) on the CPU.

The runner cases are those of tests/test_runner.py, run against the port's
runner with its float64 integrator and held to the JAX float64 oracle at the
same 1e-9. Checkpoints cross between the packages in both directions: the
file format is shared. Tolerances, and why:

* **Bitwise** between the port's checkpointed and plain pipelines: a unit
  round-trips the volume through the host unchanged, and each voxel still
  receives the views in order.
* **1e-3** where one package's checkpoint is resumed by the other: the JAX
  XLA path on the CPU contracts multiply-adds and the Pallas plan regroups
  views by orientation, the bound of tests/test_torch_integrate.py.
"""

import os

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
import cudadepthmapintegration_tpu.ops.integrate as JI
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.cli import reconstruct as t_reconstruct
from cudadepthmapintegration_torch.ops import integrate as TI
from cudadepthmapintegration_torch.pipeline import (
    ReconstructionConfig as TorchConfig,
    ReconstructionPipeline as TorchPipeline,
)
from cudadepthmapintegration_torch.pipeline import checkpoint as t_ckpt
from cudadepthmapintegration_torch.pipeline.runner import (
    FaultTolerantRunner,
    FusionUnitError,
)
from cudadepthmapintegration_tpu.cli import reconstruct as j_reconstruct
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.io import read_vts, write_depth_map_vti, write_krtd
from cudadepthmapintegration_tpu.ops import integrate_views_oracle
from cudadepthmapintegration_tpu.pipeline import (
    ReconstructionConfig as JaxConfig,
    ReconstructionPipeline as JaxPipeline,
)
from cudadepthmapintegration_tpu.pipeline import checkpoint as j_ckpt
from cudadepthmapintegration_tpu.testing import sphere_scene

KP.INTERPRET = True

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)
T_PARAMS = interop.params_from(PARAMS)


def grid16():
    return VoxelGrid(dims=(17, 17, 17), origin=(-1.6,) * 3, spacing=(0.2,) * 3)


def scene(n):
    """The JAX package's scene and its port copy."""
    views = sphere_scene(n_views=n, width=64, height=48)
    return views, interop.views_from(views)


def make_integrate_fn(flaky_failures=0):
    state = {"fails_left": flaky_failures}
    grid = interop.grid_from(grid16())

    def integrate_fn(volume, batch):
        if state["fails_left"] > 0:
            state["fails_left"] -= 1
            raise RuntimeError("injected transient failure")
        integ = TI.TSDFIntegrator(grid, T_PARAMS, dtype=torch.float64, device="cpu").reset(volume)
        return integ.integrate(batch).result()

    return integrate_fn


def runner(fn, **kw):
    return FaultTolerantRunner(interop.grid_from(grid16()), T_PARAMS, fn, **kw)


def oracle(views):
    return integrate_views_oracle(grid16(), views, PARAMS)


# -- the checkpoint file ----------------------------------------------------------


def make_checkpoint(module, grid, params):
    rng = np.random.default_rng(0)
    return module.FusionCheckpoint(
        volume=rng.normal(size=grid.volume_shape).astype(np.float32),
        views_fused=5, grid=grid, params=params,
        fused_view_names=["a", "b"], extra={"runner": {"completed_units": [0, 2]}},
    )


def test_round_trip_and_atomic_save(tmp_path):
    grid, params = interop.grid_from(grid16()), T_PARAMS
    ck = make_checkpoint(t_ckpt, grid, params)
    path = str(tmp_path / "run.ckpt")  # no .npz suffix: saved under the name given
    t_ckpt.save_checkpoint(path, ck)
    assert sorted(os.listdir(tmp_path)) == ["run.ckpt"]
    got = t_ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(got.volume, ck.volume)
    assert got.views_fused == 5 and got.fused_view_names == ["a", "b"]
    assert got.extra == ck.extra and got.matches(grid, params)
    assert not got.matches(grid, RayPotential(thick=0.2, delta=0.3))
    t_ckpt.save_checkpoint(str(tmp_path / "run.npz"), ck)
    assert sorted(os.listdir(tmp_path)) == ["run.ckpt", "run.npz"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_load(tmp_path, writer):
    w, r = (j_ckpt, t_ckpt) if writer == "jax" else (t_ckpt, j_ckpt)
    grid = grid16() if writer == "jax" else interop.grid_from(grid16())
    params = PARAMS if writer == "jax" else T_PARAMS
    ck = make_checkpoint(w, grid, params)
    path = str(tmp_path / "x.npz")
    w.save_checkpoint(path, ck)
    got = r.load_checkpoint(path)
    np.testing.assert_array_equal(got.volume, ck.volume)
    assert got.grid.dims == grid.dims and got.grid.origin == grid.origin
    np.testing.assert_array_equal(got.grid.matrix, grid.matrix)
    assert got.params.astuple() == params.astuple()
    assert (got.views_fused, got.fused_view_names, got.extra) == (
        ck.views_fused, ck.fused_view_names, ck.extra)


# -- the runner: the cases of tests/test_runner.py ------------------------------------


def test_runner_fuses_everything():
    views, t_views = scene(7)
    r = runner(make_integrate_fn(), unit_size=2)
    np.testing.assert_allclose(r.run(t_views), oracle(views), atol=1e-9)
    assert not r.failed_units


def test_runner_retries_transient_failures():
    views, t_views = scene(4)
    r = runner(make_integrate_fn(flaky_failures=2), unit_size=2)
    np.testing.assert_allclose(r.run(t_views), oracle(views), atol=1e-9)
    assert not r.failed_units


def always_fail(volume, batch):
    raise RuntimeError("broken")


def test_runner_raises_on_permanent_failures_by_default():
    _, t_views = scene(4)
    with pytest.raises(FusionUnitError) as exc:
        runner(always_fail, unit_size=2, max_retries=2).run(t_views)
    assert sorted(exc.value.failed_units) == [0, 1]


def test_runner_partial_mode_reports_permanent_failures():
    _, t_views = scene(4)
    r = runner(always_fail, unit_size=2, max_retries=2, on_failure="partial")
    r.run(t_views)
    assert sorted(r.failed_units) == [0, 1]
    with pytest.raises(ValueError, match="on_failure"):
        runner(always_fail, on_failure="ignore")


def test_runner_retry_restarts_from_snapshot():
    """A unit that mutates the volume in place and THEN fails must not leak
    its partial accumulation into the retry."""
    views, t_views = scene(4)
    inner = make_integrate_fn()
    state = {"sabotage": 1}

    def dirty_then_fail(volume, batch):
        if state["sabotage"] > 0:
            state["sabotage"] -= 1
            if volume is not None:
                volume += 123.0  # partial, wrong accumulation
            raise RuntimeError("died mid-unit")
        return inner(volume, batch)

    r = runner(dirty_then_fail, unit_size=2, max_retries=3)
    np.testing.assert_allclose(r.run(t_views), oracle(views), atol=1e-9)


def test_runner_layout_change_discards_checkpoint(tmp_path):
    views, t_views = scene(8)
    ckpt = str(tmp_path / "run.ckpt")
    runner(make_integrate_fn(), unit_size=2, checkpoint_path=ckpt).run(t_views)
    vol = runner(make_integrate_fn(), unit_size=4, checkpoint_path=ckpt).run(t_views)
    np.testing.assert_allclose(vol, oracle(views), atol=1e-9)


def test_runner_multi_host_checkpoint_paths_are_distinct(tmp_path):
    views, t_views = scene(8)
    ckpt = str(tmp_path / "run.ckpt")
    partials = []
    for host in range(2):
        r = runner(make_integrate_fn(), unit_size=2, host_id=host, num_hosts=2,
                   checkpoint_path=ckpt)
        assert r.checkpoint_path == f"{ckpt}.h{host}"
        partials.append(r.run(t_views))
    assert (tmp_path / "run.ckpt.h0").exists() and (tmp_path / "run.ckpt.h1").exists()
    np.testing.assert_allclose(partials[0] + partials[1], oracle(views), atol=1e-9)


def test_runner_resume_from_checkpoint(tmp_path):
    views, t_views = scene(8)
    ckpt = str(tmp_path / "run.ckpt")
    calls = {"n": 0}

    def crashy(volume, batch):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("host died")
        return make_integrate_fn()(volume, batch)

    r1 = runner(crashy, unit_size=2, max_retries=1, checkpoint_path=ckpt)
    with pytest.raises(FusionUnitError):
        r1.run(t_views)
    assert len(r1.completed_units) == 2
    seen = []

    def tracking(volume, batch):
        seen.append(len(batch))
        return make_integrate_fn()(volume, batch)

    vol = runner(tracking, unit_size=2, checkpoint_path=ckpt).run(t_views)
    assert len(seen) == 2  # only units 2 and 3 re-ran
    np.testing.assert_allclose(vol, oracle(views), atol=1e-9)


def test_runner_multi_host_striping_sums_to_full():
    views, t_views = scene(8)
    partials = [
        runner(make_integrate_fn(), unit_size=2, host_id=h, num_hosts=2).run(t_views)
        for h in range(2)
    ]
    np.testing.assert_allclose(partials[0] + partials[1], oracle(views), atol=1e-9)


def test_runner_fails_fast_on_programming_errors(tmp_path):
    """A TypeError surfaces on attempt 1 (no retries), with completed
    progress checkpointed for a fixed rerun."""
    views, t_views = scene(4)
    calls = {"n": 0}
    good = make_integrate_fn()

    def buggy(volume, batch):
        calls["n"] += 1
        if calls["n"] >= 2:  # unit 0 succeeds; unit 1 hits the bug
            raise TypeError("integrate_fn() got an unexpected keyword")
        return good(volume, batch)

    ckpt = str(tmp_path / "ft.ckpt")
    with pytest.raises(TypeError):
        runner(buggy, unit_size=2, checkpoint_path=ckpt).run(t_views)
    assert calls["n"] == 2
    calls2 = {"n": 0}

    def fixed(volume, batch):
        calls2["n"] += 1
        return good(volume, batch)

    vol = runner(fixed, unit_size=2, checkpoint_path=ckpt).run(t_views)
    assert calls2["n"] == 1  # only the failed unit re-fused
    np.testing.assert_allclose(vol, oracle(views), atol=1e-9)


# -- the pipeline and the CLI -----------------------------------------------------------


# The origin is offset off the decimal lattice so that no voxel centre
# projects onto an exact half pixel, where the JAX XLA path (which contracts
# multiply-adds on the CPU) and the port may round to different pixels.
CONFIG = dict(grid_dims=(17, 17, 17), grid_spacing=(0.2, 0.2, 0.2),
              grid_origin=(-1.73, -1.71, -1.69), ray_thick=0.1, ray_delta=0.3,
              threshold_best_cost=0.5, write_mha_path=None, stream_batch=3)


def torch_pipeline(**kw):
    return TorchPipeline(TorchConfig(device="cpu", **{**CONFIG, **kw}))


def count_integrate_calls(monkeypatch, module):
    calls = []
    orig = module.TSDFIntegrator.integrate

    def counting(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(module.TSDFIntegrator, "integrate", counting)
    return calls


def crash_on_call(monkeypatch, module, n):
    """Make the n-th integrate call raise a non-transient TypeError."""
    calls = count_integrate_calls(monkeypatch, module)
    orig = module.TSDFIntegrator.integrate

    def crashing(self, *a, **k):
        if len(calls) + 1 == n:
            raise TypeError("injected programming error")
        return orig(self, *a, **k)

    monkeypatch.setattr(module.TSDFIntegrator, "integrate", crashing)


def test_pipeline_checkpoint_bitwise_and_resume_fuses_nothing(tmp_path, monkeypatch):
    _, views = scene(8)
    ref, _ = torch_pipeline().fuse(views)
    ck = str(tmp_path / "fusion.ckpt.npz")
    got, _ = torch_pipeline(checkpoint_path=ck).fuse(views)
    np.testing.assert_array_equal(got.result(), ref.result())
    assert got.views_fused == 8 and got.volume_sweeps == 3  # units of 3, 3, 2
    book = t_ckpt.load_checkpoint(ck).extra["runner"]
    assert book["completed_units"] == [0, 1, 2] and book["unit_size"] == 3
    calls = count_integrate_calls(monkeypatch, TI)
    again, _ = torch_pipeline(checkpoint_path=ck).fuse(views)
    assert calls == []
    np.testing.assert_array_equal(again.result(), ref.result())
    with pytest.raises(ValueError, match="mutually exclusive"):
        torch_pipeline(checkpoint_path=ck).fuse(views, initial=ref.result())


def test_pipeline_preempted_run_resumes_bitwise(tmp_path, monkeypatch):
    _, views = scene(8)
    ref, _ = torch_pipeline().fuse(views)
    ck = str(tmp_path / "run.npz")
    with monkeypatch.context() as m:
        crash_on_call(m, TI, 3)
        with pytest.raises(TypeError):
            torch_pipeline(checkpoint_path=ck).fuse(views)
    assert t_ckpt.load_checkpoint(ck).extra["runner"]["completed_units"] == [0, 1]
    calls = count_integrate_calls(monkeypatch, TI)
    got, _ = torch_pipeline(checkpoint_path=ck).fuse(views)
    assert len(calls) == 1  # only unit 2
    np.testing.assert_array_equal(got.result(), ref.result())


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(tmp_path, monkeypatch, first):
    """One package fuses a unit and is preempted; the other resumes from its
    checkpoint and fuses only the rest."""
    j_views, t_views = scene(6)
    ck = str(tmp_path / "cross.npz")
    j_pipe = JaxPipeline(JaxConfig(**CONFIG, checkpoint_path=ck))
    t_pipe = torch_pipeline(checkpoint_path=ck)
    runs = {"jax": (j_pipe, j_views, JI), "torch": (t_pipe, t_views, TI)}
    second = "torch" if first == "jax" else "jax"
    pipe, views, module = runs[first]
    with monkeypatch.context() as m:
        crash_on_call(m, module, 2)
        with pytest.raises(TypeError):
            pipe.fuse(views)
    assert j_ckpt.load_checkpoint(ck).extra["runner"]["completed_units"] == [0]
    pipe, views, module = runs[second]
    calls = count_integrate_calls(monkeypatch, module)
    got, _ = pipe.fuse(views)
    assert len(calls) == 1
    ref, _ = torch_pipeline().fuse(t_views)
    np.testing.assert_allclose(np.asarray(got.result()), ref.result(), rtol=0, atol=1e-3)
    assert np.abs(ref.result()).max() > 0.5


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


def cli_args(folder, out, *extra):
    return ["--gridDims", "21", "--gridOrigin", "-1.6", "-1.6", "-1.6",
            "--gridEnd", "1.6", "1.6", "1.6", "--rayThick", "0.1", "--rayDelta", "0.3",
            "--threshBestCost", "0.5", "--contour", "0.5", "--dataFolder", str(folder),
            "--outputMeshFilename", str(out / "mesh.vtp"),
            "--outputGridFilename", str(out / "grid.vts"), "--mhaPath", "",
            "--streamBatch", "2", *extra]


def cells(out):
    return read_vts(str(out / "grid.vts"))[2]["reconstruction_scalar"]


def test_cli_checkpoint(dataset, tmp_path, monkeypatch):
    plain, ck_run, resumed = (tmp_path / d for d in ("plain", "ck", "resumed"))
    for d in (plain, ck_run, resumed):
        d.mkdir()
    assert t_reconstruct.main(cli_args(dataset, plain, "--device", "cpu")) == 0
    ck = str(tmp_path / "ck.npz")
    args = cli_args(dataset, ck_run, "--device", "cpu", "--checkpoint", ck)
    assert t_reconstruct.main(args) == 0
    np.testing.assert_array_equal(cells(ck_run), cells(plain))
    loaded = t_ckpt.load_checkpoint(ck)
    assert loaded.extra["runner"]["completed_units"] == [0, 1, 2]
    assert loaded.views_fused == 6
    calls = count_integrate_calls(monkeypatch, TI)
    assert t_reconstruct.main(cli_args(dataset, resumed, "--device", "cpu",
                                       "--checkpoint", ck)) == 0
    assert calls == []
    np.testing.assert_array_equal(cells(resumed), cells(plain))
    assert "--checkpoint" in t_reconstruct.build_parser().format_help()


def test_cli_resumes_a_jax_cli_checkpoint(dataset, tmp_path, monkeypatch):
    jax_out, port_out, plain = (tmp_path / d for d in ("jax", "port", "plain"))
    for d in (jax_out, port_out, plain):
        d.mkdir()
    ck = str(tmp_path / "jax.npz")
    assert j_reconstruct.main(cli_args(dataset, jax_out, "--checkpoint", ck)) == 0
    calls = count_integrate_calls(monkeypatch, TI)
    assert t_reconstruct.main(cli_args(dataset, port_out, "--device", "cpu",
                                       "--checkpoint", ck)) == 0
    assert calls == []  # every unit was already fused by the JAX CLI
    np.testing.assert_array_equal(cells(port_out), cells(jax_out))
    assert t_reconstruct.main(cli_args(dataset, plain, "--device", "cpu")) == 0
    np.testing.assert_allclose(cells(port_out), cells(plain), rtol=0, atol=1e-3)


def test_cli_fusion_unit_error_propagates(dataset, tmp_path, monkeypatch):
    """Only ValueError maps to exit 1; a unit that keeps failing raises."""
    def broken(self, *a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(TI.TSDFIntegrator, "integrate", broken)
    monkeypatch.setattr("time.sleep", lambda s: None)
    with pytest.raises(FusionUnitError):
        t_reconstruct.main(cli_args(dataset, tmp_path, "--device", "cpu",
                                    "--checkpoint", str(tmp_path / "x.npz")))
