"""Two-process crash/resume of the port's runner over ``torch.distributed``.

The counterpart of tests/test_multihost_smoke.py, with real OS processes:

* phase "crash": two processes stripe 4 units (unit_size 2 over 8 views);
  process 1 is preempted (``os._exit``) after finishing one unit, process 0
  completes;
* phase "resume": both join a gloo process group through
  ``parallel.distributed.initialize``, resume from their per-process
  checkpoints (process 1 re-fuses only its unfinished unit), and reduce the
  partial volumes with ``parallel.distributed.all_sum_volume``. The sum
  must equal the full-scene float64 oracle of the JAX package (1e-5: the
  partials are gathered as float32, as the JAX package gathers them).

The worker is this file run as a script; it imports only the port.
"""

import os
import socket
import subprocess
import sys

import numpy as np

PARAMS = dict(thick=0.1, rho=0.8, eta=0.03, delta=0.3)
GRID = dict(dims=(17, 17, 17), origin=(-1.6,) * 3, spacing=(0.2,) * 3)


def _spawn(role, proc, out_dir, coord=None):
    env = dict(os.environ, MH_ROLE=role, MH_PROC=str(proc), MH_DIR=str(out_dir))
    if coord:
        env["MH_COORD"] = coord
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finish(procs, timeout):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return outs


def test_two_process_crash_resume_and_cross_process_sum(tmp_path):
    from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
    from cudadepthmapintegration_tpu.ops import integrate_views_oracle
    from cudadepthmapintegration_tpu.testing import sphere_scene

    procs = [_spawn("crash", p, tmp_path) for p in range(2)]
    outs = _finish(procs, 240)
    assert procs[0].returncode == 0, outs[0][-2000:]
    assert procs[1].returncode == 17, outs[1][-2000:]  # preempted
    assert (tmp_path / "run.ckpt.h0").exists() and (tmp_path / "run.ckpt.h1").exists()

    coord = f"127.0.0.1:{_free_port()}"
    procs = [_spawn("resume", p, tmp_path, coord=coord) for p in range(2)]
    outs = _finish(procs, 240)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]

    # Units already fused are skipped: process 1 fused only unit 3 again.
    np.testing.assert_array_equal(np.load(tmp_path / "resumed_units.0.npy"), [0, 2])
    np.testing.assert_array_equal(np.load(tmp_path / "resumed_units.1.npy"), [1, 3])
    np.testing.assert_array_equal(np.load(tmp_path / "fused_after_resume.0.npy"), [])
    np.testing.assert_array_equal(np.load(tmp_path / "fused_after_resume.1.npy"), [3])

    views = sphere_scene(n_views=8, width=64, height=48)
    exp = integrate_views_oracle(VoxelGrid(**GRID), views, RayPotential(**PARAMS))
    total = np.load(tmp_path / "total.npy")
    assert total.dtype == np.float32
    np.testing.assert_allclose(total, exp, atol=1e-5)


def _worker() -> int:
    """One process of the test above; its role comes from the environment:
    MH_ROLE ("crash" or "resume"), MH_PROC (0 or 1), MH_DIR (scratch
    directory) and, for "resume", MH_COORD (the coordinator's host:port)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from cudadepthmapintegration_torch.core import RayPotential, VoxelGrid
    from cudadepthmapintegration_torch.ops import TSDFIntegrator
    from cudadepthmapintegration_torch.parallel import distributed
    from cudadepthmapintegration_torch.pipeline.runner import FaultTolerantRunner
    from cudadepthmapintegration_torch.testing import sphere_scene

    role, proc, out_dir = (os.environ["MH_ROLE"], int(os.environ["MH_PROC"]),
                           os.environ["MH_DIR"])
    grid, params = VoxelGrid(**GRID), RayPotential(**PARAMS)
    views = sphere_scene(n_views=8, width=64, height=48)
    done = []

    def integrate_fn(volume, batch):
        if role == "crash" and proc == 1 and done:
            os._exit(17)  # simulated preemption after one unit (no cleanup)
        done.append(next(i for i, v in enumerate(views) if v is batch[0]) // 2)
        integ = TSDFIntegrator(grid, params, dtype=torch.float64).reset(volume)
        return integ.integrate(batch).result()

    runner = FaultTolerantRunner(grid, params, integrate_fn, unit_size=2,
                                 checkpoint_path=os.path.join(out_dir, "run.ckpt"),
                                 host_id=proc, num_hosts=2)
    if role == "crash":
        runner.run(views)
        return 0
    distributed.initialize(coordinator_address=os.environ["MH_COORD"],
                           num_processes=2, process_id=proc)
    assert distributed.is_multihost()
    assert torch.distributed.get_backend() == "gloo"
    assert distributed.host_view_slice(8) == range(4 * proc, 4 * proc + 4)
    partial = runner.run(views, resume=True)
    np.save(os.path.join(out_dir, f"resumed_units.{proc}.npy"),
            np.asarray(sorted(runner.completed_units)))
    np.save(os.path.join(out_dir, f"fused_after_resume.{proc}.npy"), np.asarray(done, np.int64))
    total = distributed.all_sum_volume(partial)
    if proc == 0:
        np.save(os.path.join(out_dir, "total.npy"), total)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker())
