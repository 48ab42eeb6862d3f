"""Scaling probe of z-slab fusion: views/s against the number of slabs P,
with a bitwise P-invariance gate, the split between staging and fusion, and
the costs of a resume.

Counterpart of the JAX package's ``scripts/pod_probe.py``, with its workload
(513 points an axis, 64 views of 512x512, thick 0.025, rho 0.8, eta 0.03,
delta 0.1), its three phases and its gates, on PyTorch and the port's
``parallel`` package:

* ``scale``: for each P of 1, 2, 4, 8, 16, 32 that the devices allow and
  that divides the 512 z cells, a ``ShardedTSDFIntegrator`` on a mesh of
  the first P devices stages the views once
  (``stage_pallas_views(frustum_cull=True)``) and fuses them 4 times
  (``run_staged_pallas``, the device drained after each; the best of the
  last 3 counts, the first is the warm-up). Each slab is fused on its own
  (a voxel's sum needs no other slab, ``CudaReconstruction.cu:211``), so
  every P's volume must equal P = 1's bit for bit, and P = 1's must equal
  the plain version of the integrate kernel run on the same staged, culled
  inputs on the same device;
* ``stage``: staging (host tables and maps to the devices, once) against one
  fusion pass, and the time to make the views on this process;
* ``resume``: the two costs of a resume that one process can measure: the
  re-fuse of this process's stripe of the views and the checkpoint round
  trip (``pipeline.checkpoint``), which must give the volume back bit for
  bit.

``--local N`` (the JAX script's N virtual CPU devices) puts N z-slabs on the
one device: ``make_mesh(n_z=P, devices=[device] * P)``, on the card with
``--device cuda``. Without it, P runs over sub-meshes of the process's
cards (``torch.cuda.device_count()``), or of the one CPU. The workload is
shrunk to 65 points an axis and 16 views of 128x96 only with ``--device
cpu``. The JAX script's kernel tuning (``KERNEL_KW``) has no counterpart.

Several processes (a launcher that sets ``COORDINATOR_ADDRESS``,
``WORLD_SIZE`` and ``RANK``; ``parallel.distributed.initialize``) each make
only their stripe of the views, and the stripes, disjoint, are summed
across the processes with ``torch.distributed.all_reduce`` so that every
process holds every map.

Run from the root of a checkout::

    python -m cudadepthmapintegration_torch.scripts.pod_probe [scale] [stage] [resume] \
        [--local N] [--device cuda|cpu]

(every phase when none is named). Prints each phase's lines, one JSON line a
phase and last the record as one JSON object (with the card's name and power
limit); exits 1 when a gate fails. ``--device cuda`` (the default) raises
when there is no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..core.view import DepthMapView
from ..kernels.integrate_cuda import integrate_views_torch
from ..parallel import ShardedTSDFIntegrator, distributed, make_mesh
from ..pipeline.checkpoint import FusionCheckpoint, load_checkpoint, save_checkpoint
from ..testing import orbit_cameras
from ._common import card_description, render_views, same_bits, script_device

__all__ = ["Probe", "build_scene", "fuse_once", "main", "run"]

PARAMS = RayPotential(thick=0.025, rho=0.8, eta=0.03, delta=0.1)
# (points an axis, views, map width, map height): the JAX script's pod
# workload, and the shrunk one it validates with, here only on the CPU.
WORKLOAD = (513, 64, 512, 512)
CPU_WORKLOAD = (65, 16, 128, 96)
SLAB_COUNTS = (1, 2, 4, 8, 16, 32)
REPS = 3  # timed fusion passes after the warm-up
PHASES = ("scale", "stage", "resume")


def banner(s):
    print(f"\n=== {s} ===", flush=True)


@dataclasses.dataclass
class Probe:
    """The scene and the devices the phases share: the grid, every view, the
    seconds this process took to make its stripe of them, the devices."""

    grid: VoxelGrid
    views: list[DepthMapView]
    io_s: float
    devices: list[torch.device]


def build_scene(dims: int, n_views: int, width: int, height: int):
    """The grid, every view and the seconds this process took to make its
    stripe of them: each process renders only its stripe
    (``distributed.host_view_slice``); across processes the disjoint
    stripes' maps are summed by ``all_reduce``, so every process ends with
    every map."""
    grid = VoxelGrid(dims=(dims,) * 3, origin=(-1.6,) * 3, spacing=(3.2 / (dims - 1),) * 3)
    cams = orbit_cameras(n_views, 4.0, focal=0.6 * width, width=width, image_height=height)
    t0 = time.perf_counter()
    mine = distributed.host_view_slice(n_views)
    views: list[DepthMapView | None] = [None] * n_views
    views[mine.start:mine.stop] = render_views(cams[mine.start:mine.stop], width, height,
                                               radius=1.0, background=-1.0)
    io_s = time.perf_counter() - t0
    if distributed.is_multihost():
        depths = torch.zeros((n_views, height, width), dtype=torch.float32)
        for i in mine:
            depths[i] = torch.from_numpy(views[i].depth.astype(np.float32))
        dist.all_reduce(depths)  # the stripes are disjoint: the sum is the gather
        for i in range(n_views):
            if views[i] is None:
                views[i] = DepthMapView(depth=depths[i].numpy(), camera=cams[i])
    return grid, views, io_s


def fuse_once(grid, views, mesh, reps=REPS, plain=False):
    """Stage the views once on ``mesh`` and fuse them ``reps + 1`` times into
    a fresh volume; returns (views per second of the best of the last
    ``reps``, staging seconds, the volume on the host, and with ``plain``
    whether it equals :func:`plain_volume` bit for bit, else None)."""
    intg = ShardedTSDFIntegrator(grid, PARAMS, mesh)
    t0 = time.perf_counter()
    staged = intg.stage_pallas_views(views, frustum_cull=True)
    intg.synchronize()
    stage_s = time.perf_counter() - t0
    best = float("inf")
    for rep in range(reps + 1):  # the first pass warms up
        intg.reset()
        intg.synchronize()
        t0 = time.perf_counter()
        intg.run_staged_pallas(staged)
        intg.synchronize()
        if rep:
            best = min(best, time.perf_counter() - t0)
    equal = None
    if plain:
        equal = all(same_bits(slab, want) for slab, want in
                    zip(intg.slabs, plain_volume(intg, staged)))
    return len(views) / best, stage_s, intg.result(), equal


def plain_volume(intg, staged) -> list[torch.Tensor]:
    """The slabs that the plain version of the integrate kernel fuses from
    zeros on ``staged`` (``stage_pallas_views``' inputs, culled slabs
    included), each on its slab's device."""
    slabs = [torch.zeros_like(slab) for slab in intg.slabs]
    for slab, args in zip(slabs, staged):
        if args is not None:
            integrate_views_torch(slab, *args, PARAMS)
    return slabs


def phase_scale(probe: Probe) -> dict:
    g = probe.grid
    banner(f"views/s vs P (grid {g.dims[0] - 1}^3, {len(probe.views)} views "
           f"{probe.views[0].width}x{probe.views[0].height})")
    cz = g.volume_shape[0]
    ps = [p for p in SLAB_COUNTS if p <= len(probe.devices) and cz % p == 0]
    ref_vol = ref_rate = None
    rows = []
    for p in ps:
        mesh = make_mesh(n_z=p, devices=probe.devices[:p])
        # The first P's volume is also held against the plain version.
        rate, stage_s, vol, equal = fuse_once(g, probe.views, mesh, plain=ref_vol is None)
        if ref_vol is None:
            ref_vol, ref_rate, gate, plain_equal = vol, rate, "ref", equal
            print(f"  P={p:2d}: {'equals' if equal else 'DIFFERS FROM'} the plain version "
                  "bit for bit", flush=True)
        else:
            gate = "BITWISE-OK" if same_bits(vol, ref_vol) else "MISMATCH"
        eff = rate / (ref_rate * p)
        rows.append(dict(p=p, views_per_s=rate, eff=eff, stage_s=stage_s, gate=gate))
        print(f"  P={p:2d}: {rate:8.2f} views/s  eff {eff * 100:5.1f}%  "
              f"stage {stage_s * 1e3:6.0f} ms  {gate}", flush=True)
    # A float64 sum of the volume on the host: equal in every process that
    # fused the same maps.
    return dict(rows=rows, bitwise=all(r["gate"] != "MISMATCH" for r in rows),
                plain_equal_bits=plain_equal, volume_checksum=float(ref_vol.sum(dtype=np.float64)))


def phase_stage(probe: Probe) -> dict:
    banner("staging vs fusion split")
    p = min(len(probe.devices), 8)
    if probe.grid.volume_shape[0] % p:
        p = 1
    rate, stage_s, _, _ = fuse_once(probe.grid, probe.views,
                                    make_mesh(n_z=p, devices=probe.devices[:p]))
    fuse_s = len(probe.views) / rate
    print(f"  P={p}: stage {stage_s:.3f} s (once), fuse {fuse_s:.3f} s per"
          f" {len(probe.views)}-view pass, view I/O {probe.io_s:.3f} s on this process",
          flush=True)
    return dict(p=p, stage_s=stage_s, fuse_s=fuse_s, views_per_s=rate, view_io_s=probe.io_s)


def phase_resume(probe: Probe) -> dict:
    banner("resume costs (this process's stripe)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    size = dist.get_world_size() if dist.is_initialized() else 1
    devs = probe.devices
    intg = ShardedTSDFIntegrator(probe.grid, PARAMS, make_mesh(n_z=len(devs), devices=devs))
    intg.reset().synchronize()
    stripe = [probe.views[i] for i in distributed.host_view_slice(len(probe.views))]
    t0 = time.perf_counter()
    intg.integrate(stripe)
    intg.synchronize()
    refuse_s = time.perf_counter() - t0
    vol = intg.result()
    with tempfile.TemporaryDirectory(prefix="cdmi_pod_probe_") as d:
        path = os.path.join(d, f"probe.ckpt.h{rank}")
        t0 = time.perf_counter()
        save_checkpoint(path, FusionCheckpoint(volume=vol, views_fused=len(stripe),
                                               grid=probe.grid, params=PARAMS))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_checkpoint(path)
        load_s = time.perf_counter() - t0
    exact = bool(back.volume.dtype == vol.dtype and same_bits(back.volume, vol)
                 and back.views_fused == len(stripe) and back.matches(probe.grid, PARAMS))
    print(f"  process {rank}/{size}: stripe {len(stripe)} views re-fuse {refuse_s:.2f} s,"
          f" ckpt save {save_s:.2f} s / load {load_s:.2f} s ({vol.nbytes / 1e6:.0f} MB"
          f" volume), round trip {'exact' if exact else 'DIFFERS'}", flush=True)
    return dict(process=rank, processes=size, stripe_views=len(stripe), slabs=len(devs),
                refuse_s=refuse_s, save_s=save_s, load_s=load_s, volume_bytes=vol.nbytes,
                round_trip_exact=exact)


PHASE_FNS = {"scale": phase_scale, "stage": phase_stage, "resume": phase_resume}


def probe_devices(device: torch.device, local: int | None) -> list[torch.device]:
    """``local`` slabs of ``device``, else every card of the process (or the
    one CPU)."""
    if local is not None:
        return [device] * local
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def run(phases=PHASES, local: int | None = None, device="cuda") -> dict:
    """The named phases; returns the record: the topology, the workload, one
    record a phase and the gates (``scale_bitwise``, ``scale_equals_plain``,
    ``round_trip_exact``)."""
    device = script_device(device, "pod_probe")
    if local is not None and local < 1:
        raise ValueError(f"--local takes a positive slab count, got {local}")
    distributed.initialize()
    topo = distributed.topology_summary()
    print(f"topology: {topo}", flush=True)
    dims, n_views, width, height = CPU_WORKLOAD if device.type == "cpu" else WORKLOAD
    grid, views, io_s = build_scene(dims, n_views, width, height)
    probe = Probe(grid, views, io_s, probe_devices(device, local))
    rec = dict(topology=topo, workload=dict(dims=dims, views=n_views, map=[width, height]),
               devices=[str(d) for d in probe.devices], local=local, phases={},
               device=str(device), card=card_description(device))
    for name in phases:
        t0 = time.time()
        out = PHASE_FNS[name](probe)
        out["seconds"] = time.time() - t0
        rec["phases"][name] = out
        print(json.dumps(dict(phase=name, **out)), flush=True)
        print(f"[phase {name}: {out['seconds']:.0f}s]", flush=True)
    gates = {}
    if "scale" in rec["phases"]:
        gates["scale_bitwise"] = rec["phases"]["scale"]["bitwise"]
        gates["scale_equals_plain"] = rec["phases"]["scale"]["plain_equal_bits"]
    if "resume" in rec["phases"]:
        gates["round_trip_exact"] = rec["phases"]["resume"]["round_trip_exact"]
    rec["gates"] = gates
    rec["ok"] = all(gates.values())
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cudadepthmapintegration_torch.scripts.pod_probe",
        description="Views/s of z-slab fusion against the slab count, staging against "
                    "fusion, and the costs of a resume.")
    p.add_argument("phases", nargs="*", metavar="PHASE",
                   help="scale, stage and/or resume (default: all three)")
    p.add_argument("--local", type=int, metavar="N",
                   help="N z-slabs on the one device instead of one a card")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the hand-written kernel; default) or cpu (its plain version)")
    a = p.parse_args(argv)
    unknown = [ph for ph in a.phases if ph not in PHASES]
    if unknown:
        p.error(f"unknown phase {' '.join(unknown)} (choose from {', '.join(PHASES)})")
    rec = run(a.phases or PHASES, a.local, a.device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
