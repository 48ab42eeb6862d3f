#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``cudadepthmapintegration_torch/
csrc``, holds each against its plain PyTorch version on the card at its
path's shapes (bit for bit: both follow the same rounding, division and
no-contraction rules), then drives two paths through the port's CLIs, in
process, on synthetic datasets:

* the main path: ``cudareconstruction`` at 512^3 cells from 64 views of
  512x512, then ``coloration`` of the mesh it wrote;
* the integrate kernel at the shapes of the JAX package's other kernel
  modes (phase ``integrate_modes``): ``windows`` through the z-sharded
  staging on four slabs of one card, a straight-down mapping scan, 4K maps
  and 1024x768 maps;
* resumable fusion: ``cudareconstruction --checkpoint`` on the main path's
  dataset, uninterrupted, then preempted and resumed (phase
  ``checkpoint``);
* multi-device fusion on a four-slab mesh of one card: the sharded
  pipeline, frustum culling, interleaved slabs, view-parallel fusion, and
  the sharded cell->point, isosurface and coloration (phase ``sharded``),
  each option of the z-slab path timed against its default (phase
  ``shard_options``);
* multi-process fusion: two processes of this script (``--mp-worker``) on
  the one card, joined by ``torch.distributed`` (phase ``multiprocess``);
* sparse RGB-D fusion: ``fuse_rgbd --onlineColor`` over a 300-frame
  640x480 sequence with TUM freiburg1 intrinsics orbiting the unit sphere.

Every phase prints one JSON line. The line before the last holds the
kernels' record (launches counted during each kernel's CLI run only, errors
and CUDA-event times measured here); the last line is
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without that line. It needs no network and imports no JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPS = 5  # timed repetitions of each kernel and plain version
DIMS = 513  # grid points per axis of the main path: 512^3 cells
N_VIEWS = 64
MAP = 512  # depth/colour map width and height of the main path
# Sparse RGB-D path: TUM-sized frames with the freiburg1 calibration.
TUM_W, TUM_H = 640, 480
FR1 = np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]])
# Half of TUM fr1/desk's 573 frames, cut for the time limit.
SPARSE_FRAMES = 300
SPARSE_VOXEL = 0.01
SPARSE_CAPACITY = 32768
KERNEL_FILE = "cudadepthmapintegration_tpu/kernels/integrate_pallas.py"
# View-parallel fusion regroups each voxel's float32 sum (partials added in
# v order): values up to ~64 differ by a few ulps.
VIEW_PARALLEL_ATOL = 1e-4
# shard_axis='auto' relabels the grid, which regroups the kernel's
# projection-table sum: a few ulps where it changes the axis, and a
# projection on a pixel edge may land on the neighbouring pixel. So at most
# FLIP_BUDGET of the voxels may be off by more than AUTO_ATOL (the
# pixel-flip budget of docs/PARITY.md).
AUTO_ATOL = 1e-4
FLIP_BUDGET = 2e-4
# Multi-process fusion: two processes share the card, 256^3 cells from 16
# views of 512x512 in units of 4 views.
MP_DIMS, MP_VIEWS, MP_UNIT = 257, 16, 4


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    each timed with CUDA events on the current stream."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def orbit_views(n, width, height, focal=300.0):
    from cudadepthmapintegration_torch.testing import orbit_cameras, render_sphere_view

    cams = orbit_cameras(n, 4.0, focal=focal, width=width, image_height=height)
    return [render_sphere_view(c, width, height, radius=1.0) for c in cams]


def tum_orbit_view(i, n):
    """Frame ``i`` of ``n`` on an orbit of the unit sphere: 640x480 with
    freiburg1 intrinsics, 3 to 4 m from the centre, up to 43 degrees above
    and below the equator."""
    from cudadepthmapintegration_torch.core import Camera
    from cudadepthmapintegration_torch.testing import look_at_camera, render_sphere_view

    a = 2.0 * np.pi * i / n
    dist, elev = 3.5 + 0.5 * np.sin(3 * a), 0.75 * np.sin(2 * a)
    eye = dist * np.array([np.cos(elev) * np.cos(a), np.cos(elev) * np.sin(a), np.sin(elev)])
    rt = look_at_camera(eye, (0.0, 0.0, 0.0)).rt
    return render_sphere_view(Camera(k=FR1, rt=rt), TUM_W, TUM_H, radius=1.0)


def sparse_kernel_phase(params):
    """The sparse fuse kernel against its plain versions on one frame of the
    sparse path, depth only and with colour; returns the phase record."""
    import torch

    from cudadepthmapintegration_torch.kernels.sparse_cuda import (
        sparse_accumulate_color_torch,
        sparse_fuse,
        sparse_fuse_torch,
    )
    from cudadepthmapintegration_torch.ops.sparse_grid import SparseTSDFGrid

    t0 = time.perf_counter()
    views = [tum_orbit_view(i, 8) for i in range(8)]
    grid = SparseTSDFGrid(voxel_size=SPARSE_VOXEL, params=params, capacity=SPARSE_CAPACITY,
                          with_color=True, device="cuda")
    grid.preallocate(views)  # the trajectory's blocks, as a known-trajectory run would
    for v in views[:3]:
        grid.integrate_frame(v)  # so the compared frame adds into non-zero pools
    batch = grid.frame_batch(views[3])
    n_blocks = int(batch.slots.shape[0])
    voxels = n_blocks * int(np.prod(grid.block_shape))
    args = (batch.slots, batch.origins, batch.proj_rows, grid.axes, batch.depth)
    rec = dict(blocks=n_blocks, voxels=voxels, map=[TUM_H, TUM_W])
    for colour in (False, True):
        names = ("pool", "color_pool", "weight_pool") if colour else ("pool",)
        kernel = {k: getattr(grid, k).clone() for k in names}
        plain = {k: getattr(grid, k).clone() for k in names}

        def run_kernel():
            extra = {}
            if colour:
                extra = dict(color_pool=kernel["color_pool"], weight_pool=kernel["weight_pool"],
                             rgb=batch.rgb, band=grid.color_band)
            sparse_fuse(kernel["pool"], *args, params, **extra)

        def run_plain():
            sparse_fuse_torch(plain["pool"], *args, params)
            if colour:
                sparse_accumulate_color_torch(plain["color_pool"], plain["weight_pool"], *args,
                                              batch.rgb, grid.color_band)

        run_kernel()
        run_plain()
        torch.cuda.synchronize()
        label = "colour" if colour else "depth"
        errs = {k: float((kernel[k] - plain[k]).abs().max()) for k in names}
        equal = {k: torch.equal(kernel[k], plain[k]) for k in names}
        if not all(equal.values()):
            emit(dict(phase="sparse_kernel", case=label, equal=equal, max_abs_err=errs, ok=False))
            raise AssertionError(f"sparse fuse kernel differs from its plain version ({label})")
        ms = cuda_ms(run_kernel, REPS)
        plain_ms = cuda_ms(run_plain, REPS)
        rec[label] = dict(equal=equal, max_abs_err=errs, ms=ms, plain_ms=plain_ms,
                          voxel_updates_per_s=voxels / (ms / 1e3),
                          plain_voxel_updates_per_s=voxels / (plain_ms / 1e3))
    if float(grid.pool.abs().max()) <= 0.5:
        raise AssertionError("sparse kernel case: the frames missed the blocks")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def fuse_rgbd_phase(tmp):
    """``fuse_rgbd --onlineColor --device cuda`` over a written sequence;
    returns the sparse kernel's launches in the run."""
    import io

    from cudadepthmapintegration_torch.cli import fuse_rgbd
    from cudadepthmapintegration_torch.io import read_vtp, write_depth_map_vti, write_krtd
    from cudadepthmapintegration_torch.kernels import coloration_cuda, integrate_cuda, sparse_cuda
    from cudadepthmapintegration_torch.utils.log import Log

    t0 = time.perf_counter()
    for i in range(SPARSE_FRAMES):
        v = tum_orbit_view(i, SPARSE_FRAMES)
        write_depth_map_vti(os.path.join(tmp, f"t{i:03d}.vti"), v.depth, v.color)
        write_krtd(os.path.join(tmp, f"t{i:03d}.krtd"), v.camera)
    lists = {}
    for name, ext in (("tumVti.txt", "vti"), ("tumKrtd.txt", "krtd")):
        lists[ext] = os.path.join(tmp, name)
        with open(lists[ext], "w") as f:
            f.write("".join(f"t{i:03d}.{ext}\n" for i in range(SPARSE_FRAMES)))
    dataset_s = time.perf_counter() - t0

    out = os.path.join(tmp, "fused.vtp")
    log = Log(verbose=True, stream=io.StringIO())
    integrate_cuda.launches = coloration_cuda.launches = sparse_cuda.launches = 0
    t0 = time.perf_counter()
    rc = fuse_rgbd.main([
        "--vti", lists["vti"], "--krtd", lists["krtd"], "--onlineColor", "--device", "cuda",
        "--voxelSize", repr(SPARSE_VOXEL), "--capacity", str(SPARSE_CAPACITY),
        "--pixelStride", "4", "--output", out,
    ], log=log)
    cli_s = time.perf_counter() - t0
    launches = sparse_cuda.launches
    if rc != 0:
        raise AssertionError(f"fuse_rgbd exited {rc}")
    text = log.stream.getvalue()
    fused = re.search(r"fused (\d+) frames in .*?, (\d+) blocks allocated", text)
    if fused is None:
        raise AssertionError("fuse_rgbd did not report its frames and blocks")
    frames, blocks = int(fused.group(1)), int(fused.group(2))
    mesh = read_vtp(out)
    radii = np.linalg.norm(mesh.points, axis=1)
    weight = mesh.point_data.get("ColorWeight", np.zeros(0)).reshape(-1)
    rec = dict(frames=frames, map=[TUM_H, TUM_W], voxel=SPARSE_VOXEL,
               note=f"{SPARSE_FRAMES} frames: half of TUM fr1/desk's 573, cut for the time limit",
               dataset_s=dataset_s, cli_s=cli_s, fuse_s=log.timings["Fuse frames"],
               fused_fps=frames / log.timings["Fuse frames"], blocks_allocated=blocks,
               extract_mesh_s=log.timings["Extract mesh"], launches=launches,
               points=mesh.num_points, triangles=mesh.num_triangles,
               median_radius=float(np.median(radii)) if len(radii) else None,
               arrays=sorted(mesh.point_data),
               color_weight_pos_frac=float((weight > 0).mean()) if len(weight) else 0.0)
    emit(dict(phase="fuse_rgbd", **rec))
    problems = [
        msg for bad, msg in (
            (mesh.num_triangles == 0, "the sparse mesh has no triangles"),
            (not np.isfinite(mesh.points).all(), "sparse mesh points are not finite"),
            (not len(radii) or not 0.95 <= rec["median_radius"] <= 1.05,
             "sparse median radius off the unit sphere"),
            (not {"MeanColoration", "ColorWeight"} <= set(mesh.point_data),
             "online colour arrays missing"),
            (rec["color_weight_pos_frac"] < 0.9, "too few vertices received online colour"),
            (frames != SPARSE_FRAMES, "fuse_rgbd did not fuse every frame"),
            (launches == 0, "fuse_rgbd never launched the sparse fuse kernel"),
        ) if bad
    ]
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def cube_grid(dims, origin):
    """A grid spanning 3.2 along each axis."""
    from cudadepthmapintegration_torch.core import VoxelGrid

    return VoxelGrid(dims=dims, origin=origin, spacing=tuple(3.2 / (d - 1) for d in dims))


def integrate_case(label, grid, views, params):
    """Kernel vs plain version on one grid; returns the case record and the
    fused volume."""
    import torch

    from cudadepthmapintegration_torch.kernels.integrate_cuda import (
        integrate_views,
        integrate_views_torch,
    )
    from cudadepthmapintegration_torch.ops.integrate import projection_tables

    t = projection_tables(grid, views, np.float32)
    depths = np.stack([v.depth for v in views]).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (t.tx, t.ty, t.tz, t.tc, depths)]
    kernel = torch.zeros(grid.volume_shape, device="cuda")
    plain = torch.zeros_like(kernel)
    integrate_views(kernel, *args, params)
    integrate_views_torch(plain, *args, params)
    torch.cuda.synchronize()
    diff = (kernel - plain).abs()
    rec = dict(case=label, cells=list(grid.volume_shape), views=len(views),
               map=list(depths.shape[1:]),
               max_abs_err=float(diff.max()),
               differing_frac=float((kernel != plain).float().mean()))
    if not torch.equal(kernel, plain):
        emit(dict(phase="integrate", **rec, ok=False))
        raise AssertionError(f"integrate kernel differs from its plain version ({label})")
    if float(kernel.abs().max()) <= 0.5:
        raise AssertionError(f"integrate case {label}: the scene missed the grid")
    fused = kernel.cpu().numpy()  # the timed runs below keep accumulating
    rec["ms"] = cuda_ms(lambda: integrate_views(kernel, *args, params), REPS)
    rec["plain_ms"] = cuda_ms(lambda: integrate_views_torch(plain, *args, params), 3)
    updates = grid.num_cells * len(views)
    rec["voxel_updates_per_s"] = updates / (rec["ms"] / 1e3)
    rec["plain_voxel_updates_per_s"] = updates / (rec["plain_ms"] / 1e3)
    return rec, fused


def mapping_scan_views(n, width, height, focal):
    """A straight-down mapping scan: cameras 3.5 above the grid on an 8-wide
    lawnmower pattern, each looking down -z with its own roll (the rig of
    tests/test_sharded_pallas.py at full size)."""
    from cudadepthmapintegration_torch.testing import look_at_camera, render_sphere_view

    views = []
    for i in range(n):
        x, y = -0.7 + 0.2 * (i % 8) + 0.0123, -0.45 + 0.3 * (i // 8) - 0.0071
        roll = i * np.pi / n
        cam = look_at_camera((x, y, 3.5), (x, y, 0.0), up=(np.cos(roll), np.sin(roll), 0.0),
                             focal=focal, width=width, height=height)
        views.append(render_sphere_view(cam, width, height, radius=1.0))
    return views


def oracle_off_frac(grid, vol, views, params, stride=32):
    """Share of voxels off the float64 oracle by more than 1e-3, on every
    ``stride``-th z slice (the oracle is host numpy)."""
    from cudadepthmapintegration_torch.core import VoxelGrid
    from cudadepthmapintegration_torch.ops.oracle import integrate_views_oracle

    off, n = 0, 0
    for k in range(stride // 2, grid.volume_shape[0], stride):
        sub = VoxelGrid(dims=(grid.dims[0], grid.dims[1], 2), spacing=grid.spacing,
                        origin=(grid.origin[0], grid.origin[1],
                                grid.origin[2] + k * grid.spacing[2]))
        exp = integrate_views_oracle(sub, views, params)[0]
        off += int((np.abs(vol[k] - exp) > 1e-3).sum())
        n += exp.size
    return off / n


def integrate_modes_phase(params, orbit32):
    """Rows 3-6 of the kernel table: the JAX package's other kernel modes,
    each through the port's path at that mode's shapes. Every row drives its
    path with the launch count set to 0, then holds the kernel against its
    plain version on the same inputs (``torch.equal``) and times both."""
    import torch

    from cudadepthmapintegration_torch.kernels import integrate_cuda
    from cudadepthmapintegration_torch.kernels.integrate_cuda import integrate_views_torch
    from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator
    from cudadepthmapintegration_torch.parallel import ShardedTSDFIntegrator, make_mesh

    t0 = time.perf_counter()
    rows = []

    # Row 3, mode 'windows': the per-shard kernel of multi-device fusion,
    # staged for four z-slabs of one card.
    grid = cube_grid((DIMS,) * 3, (-1.6,) * 3)
    mesh = make_mesh(n_z=4, devices=["cuda:0"] * 4)
    integ = ShardedTSDFIntegrator(grid, params, mesh).reset()
    integrate_cuda.launches = 0
    staged = integ.stage_pallas_views(orbit32, mode="windows")
    integ.run_staged_pallas(staged).synchronize()
    launches = integrate_cuda.launches
    single = TSDFIntegrator(grid, params, device="cuda").reset().integrate(orbit32).result()
    sharded = integ.result()
    plain = [torch.zeros_like(s) for s in integ.slabs]
    for p, args in zip(plain, staged):
        integrate_views_torch(p, *args, params)
    torch.cuda.synchronize()
    equal = all(torch.equal(k, p) for k, p in zip(integ.slabs, plain))
    rec = dict(row=3, mode="windows", replaces=f"{KERNEL_FILE}:1093",
               path="ShardedTSDFIntegrator.stage_pallas_views(mode='windows') on "
                    "make_mesh(n_z=4, devices=['cuda:0'] * 4)",
               cells=list(grid.volume_shape), views=len(orbit32), map=[MAP, MAP],
               launches=launches, kernel_equals_plain=equal,
               max_abs_err=max(float((k - p).abs().max()) for k, p in zip(integ.slabs, plain)),
               slabs_equal_single_device=bool(np.array_equal(sharded, single)))
    del single, sharded
    if not (equal and rec["slabs_equal_single_device"]) or launches != 4:
        emit(dict(phase="integrate_mode", **rec, ok=False))
        raise AssertionError("row 3: the sharded windows path is off")
    rec["ms"] = cuda_ms(lambda: integ.run_staged_pallas(staged), REPS)
    rec["plain_ms"] = cuda_ms(lambda: [integrate_views_torch(p, *a, params)
                                       for p, a in zip(plain, staged)], 3)
    rows.append(rec)
    emit(dict(phase="integrate_mode", **rec, ok=True))
    del integ, plain, staged
    torch.cuda.empty_cache()

    # Rows 6, 4 and 5: the single-device integrator (the port's counterpart
    # of an explicit mode=) at each mode's shapes.
    cases = [
        (6, "rowsel3m", f"{KERNEL_FILE}:925 + miss counter",
         "straight-down mapping scan", cube_grid((DIMS,) * 3, (-1.6,) * 3),
         mapping_scan_views(32, MAP, MAP, 300.0)),
        (4, "rowselw", f"{KERNEL_FILE}:762", "4K maps", cube_grid((257,) * 3, (-1.6,) * 3),
         orbit_views(4, 3840, 2160, focal=1800.0)),
        (5, "rowseld", f"{KERNEL_FILE}:844", "1024x768 maps", cube_grid((DIMS,) * 3, (-1.6,) * 3),
         orbit_views(16, 1024, 768, focal=600.0)),
    ]
    for row, mode, replaces, label, grid, views in cases:
        integ = TSDFIntegrator(grid, params, device="cuda").reset()
        integrate_cuda.launches = 0
        integ.integrate(views).synchronize()
        launches = integrate_cuda.launches
        path = integ.result()
        del integ
        rec, fused = integrate_case(f"row {row} {label}", grid, views, params)
        rec.update(row=row, mode=mode, replaces=replaces, launches=launches,
                   path="TSDFIntegrator.integrate", path_equals_kernel=bool(np.array_equal(path, fused)))
        if row == 6:
            # The pixel-flip budget of docs/PARITY.md against the oracle.
            rec["oracle_off_frac"] = oracle_off_frac(grid, fused, views, params)
        ok = (rec["path_equals_kernel"] and launches == 1
              and rec.get("oracle_off_frac", 0.0) <= FLIP_BUDGET)
        emit(dict(phase="integrate_mode", **rec, ok=ok))
        if not ok:
            raise AssertionError(f"row {row}: the {label} path is off")
        rows.append(rec)
        del path, fused
        torch.cuda.empty_cache()
    emit(dict(phase="integrate_modes", rows=[r["row"] for r in rows],
              seconds=time.perf_counter() - t0, ok=True))
    return rows


def shard_options_phase(params, rigs):
    """The options of the z-slab path against its default, on four slabs of
    one card at 512^3, per rig: the seconds to stage one batch, the kernel
    ms of the staged batch, the views each shard keeps, and the volume
    against the same staging without the option: frustum culling and
    interleaving bit for bit, ``shard_axis='auto'`` against ``'z'`` within
    ``AUTO_ATOL`` up to ``FLIP_BUDGET`` of the voxels."""
    import torch

    from cudadepthmapintegration_torch.parallel import (
        ShardedTSDFIntegrator,
        grid_for_sharding,
        make_mesh,
        unpermute_volume,
    )

    t0 = time.perf_counter()
    mesh = make_mesh(n_z=4, devices=["cuda:0"] * 4)
    grid = cube_grid((DIMS,) * 3, (-1.6,) * 3)
    out, ok = {}, True
    for rig, views in rigs.items():
        auto_grid, perm = grid_for_sharding(grid, views, 4)
        # name: (grid, integrator options, staging options, compared with)
        variants = {
            "z": (grid, {}, {}, None),
            "z+cull": (grid, {}, {"frustum_cull": True}, "z"),
            "z+interleave": (grid, {"slab_interleave": True}, {}, "z"),
            "auto": (auto_grid, {}, {}, "z"),
            "auto+cull": (auto_grid, {}, {"frustum_cull": True}, "auto"),
        }
        rec, vols = {"perm": list(perm)}, {}
        for name, (g, kw, stage_kw, base) in variants.items():
            integ = ShardedTSDFIntegrator(g, params, mesh, **kw).reset()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            staged = integ.stage_pallas_views(views, **stage_kw)
            torch.cuda.synchronize()
            stage_s = time.perf_counter() - t1
            vol = integ.run_staged_pallas(staged).result()
            if name.startswith("auto"):
                vol = np.ascontiguousarray(unpermute_volume(vol, perm))
            vols[name] = vol
            rec[name] = dict(stage_s=stage_s,
                             ms=cuda_ms(lambda: integ.run_staged_pallas(staged), REPS),
                             views_per_shard=[0 if a is None else int(a[0].shape[0])
                                              for a in staged])
            if base is not None:
                diff = np.abs(vol - vols[base])
                rec[name].update(against=base, max_abs_err=float(diff.max()),
                                 off_frac=float((diff > AUTO_ATOL).mean()),
                                 equal=bool(np.array_equal(vol, vols[base])))
                ok &= rec[name]["equal"] or (name == "auto"
                                             and rec[name]["off_frac"] <= FLIP_BUDGET)
            del integ, staged, vol
            torch.cuda.empty_cache()
        del vols
        out[rig] = rec
    emit(dict(phase="shard_options", cells=list(grid.volume_shape),
              views=len(next(iter(rigs.values()))), map=[MAP, MAP], auto_atol=AUTO_ATOL,
              flip_budget=FLIP_BUDGET, **out, seconds=time.perf_counter() - t0, ok=ok))
    if not ok:
        raise AssertionError("a sharding option changed the fused volume")


class _Timed:
    """Wall seconds of each call of ``owner.name`` while in the block, with
    the card drained before and after each call."""

    def __init__(self, owner, name):
        self.owner, self.name, self.seconds = owner, name, []

    def __enter__(self):
        import torch

        self.orig = orig = getattr(self.owner, self.name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def checkpoint_phase(tmp, cli_args, plain_volume, captured):
    """``cudareconstruction --checkpoint``: an uninterrupted run in units of
    16 views, then a run preempted by a non-transient error in its third
    unit, resumed by the CLI."""
    from cudadepthmapintegration_torch.cli import reconstruct
    from cudadepthmapintegration_torch.kernels import integrate_cuda
    from cudadepthmapintegration_torch.io import DepthMapDataset
    from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator
    from cudadepthmapintegration_torch.pipeline import runner as runner_mod
    from cudadepthmapintegration_torch.pipeline.checkpoint import load_checkpoint
    from cudadepthmapintegration_torch.pipeline.reconstruction import (
        ReconstructionConfig,
        ReconstructionPipeline,
    )

    t0 = time.perf_counter()
    ck = os.path.join(tmp, "ck.npz")
    args = cli_args + ["--mhaPath", "", "--streamBatch", "16"]
    integrate_cuda.launches = 0
    with _Timed(runner_mod, "save_checkpoint") as saves, \
            _Timed(TSDFIntegrator, "reset") as uploads, \
            _Timed(TSDFIntegrator, "result") as downloads:
        t1 = time.perf_counter()
        rc = reconstruct.main(args + ["--checkpoint", ck])
        cli_s = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"reconstruct --checkpoint exited {rc}")
    run = captured[-1]
    loaded = load_checkpoint(ck)
    units = loaded.extra["runner"]["completed_units"]
    snapshot_s = time.perf_counter()
    np.array(run.volume, copy=True)
    snapshot_s = time.perf_counter() - snapshot_s
    rec = dict(units=units, launches=integrate_cuda.launches, cli_s=cli_s,
               fuse_s=run.execution_time, volume_sweeps=run.volume_sweeps,
               volume_mb=run.volume.nbytes / 1e6, checkpoint_mb=os.path.getsize(ck) / 1e6,
               save_s=saves.seconds, reset_upload_s=uploads.seconds,
               result_download_s=downloads.seconds, host_snapshot_copy_s=snapshot_s,
               equal_plain_cli=bool(np.array_equal(run.volume, plain_volume)),
               checkpoint_equal_plain_cli=bool(np.array_equal(loaded.volume, plain_volume)))
    del loaded

    # Preempted: the third unit's integrate raises a TypeError, which the
    # runner does not retry; units 0 and 1 stay checkpointed.
    ck2 = os.path.join(tmp, "preempted.npz")
    spacing = 3.2 / (DIMS - 1)
    cfg = ReconstructionConfig(
        grid_dims=(DIMS,) * 3, grid_origin=(-1.6,) * 3, grid_end=(1.6,) * 3,
        ray_thick=2 * spacing, ray_delta=8 * spacing, ray_rho=0.8, ray_eta=0.03,
        threshold_best_cost=0.5, contour_value=1.0, device="cuda", stream_batch=16,
        write_mha_path=None, checkpoint_path=ck2)
    dataset = DepthMapDataset.from_folder(tmp, "vtiList.txt", "kList.txt")
    orig, calls = TSDFIntegrator.integrate, []

    def preempted(self, *a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise TypeError("injected preemption")
        return orig(self, *a, **k)

    TSDFIntegrator.integrate = preempted
    try:
        ReconstructionPipeline(cfg).fuse(dataset)
        raise AssertionError("the preempted run did not stop")
    except TypeError:
        pass
    finally:
        TSDFIntegrator.integrate = orig
    rec["preempted_units"] = load_checkpoint(ck2).extra["runner"]["completed_units"]
    integrate_cuda.launches = 0
    with _Timed(runner_mod, "save_checkpoint") as saves:
        rc = reconstruct.main(args + ["--checkpoint", ck2])
    if rc != 0:
        raise AssertionError(f"the resumed reconstruct exited {rc}")
    rec.update(resumed_launches=integrate_cuda.launches, resumed_save_s=saves.seconds,
               resumed_fuse_s=captured[-1].execution_time,
               resumed_equal_uninterrupted=bool(np.array_equal(captured[-1].volume, run.volume)),
               seconds=time.perf_counter() - t0)
    ok = (rec["units"] == [0, 1, 2, 3] and rec["equal_plain_cli"]
          and rec["checkpoint_equal_plain_cli"] and rec["launches"] == 4
          and rec["preempted_units"] == [0, 1] and rec["resumed_launches"] == 2
          and rec["resumed_equal_uninterrupted"])
    emit(dict(phase="checkpoint", **rec, ok=ok))
    if not ok:
        raise AssertionError("resumable fusion is off")
    captured.clear()


def sharded_phase(tmp, params, contour):
    """Multi-device fusion of the main path's dataset on four z-slabs of one
    card, against the single-device path; returns the launches of the
    sharded pipeline and of the sharded coloration."""
    import torch

    from cudadepthmapintegration_torch.io import DepthMapDataset
    from cudadepthmapintegration_torch.kernels import coloration_cuda, integrate_cuda
    from cudadepthmapintegration_torch.ops import (
        cell_to_point,
        colorize_points,
        extract_isosurface,
    )
    from cudadepthmapintegration_torch.parallel import (
        ShardedTSDFIntegrator,
        grid_for_sharding,
        make_mesh,
        sharded_cell_to_point,
        sharded_colorize_points,
        sharded_extract_isosurface,
    )
    from cudadepthmapintegration_torch.pipeline.reconstruction import (
        ReconstructionConfig,
        ReconstructionPipeline,
    )

    t0 = time.perf_counter()
    spacing = 3.2 / (DIMS - 1)
    cfg = ReconstructionConfig(
        grid_dims=(DIMS,) * 3, grid_origin=(-1.6,) * 3, grid_end=(1.6,) * 3,
        ray_thick=2 * spacing, ray_delta=8 * spacing, ray_rho=0.8, ray_eta=0.03,
        threshold_best_cost=0.5, contour_value=contour, device="cuda", write_mha_path=None)
    grid = cfg.make_grid()
    dataset = DepthMapDataset.from_folder(tmp, "vtiList.txt", "kList.txt")
    mesh4 = make_mesh(n_z=4, devices=["cuda:0"] * 4)
    single, single_s = ReconstructionPipeline(cfg).fuse(dataset)
    volume = single.result()
    integrate_cuda.launches = 0
    sharded, sharded_s = ReconstructionPipeline(cfg, mesh=mesh4, shard_axis="auto").fuse(dataset)
    launches = integrate_cuda.launches
    rec = dict(mesh="make_mesh(n_z=4, devices=['cuda:0'] * 4)", cells=list(grid.volume_shape),
               views=len(dataset), perm=list(grid_for_sharding(grid, dataset, 4)[1]),
               single_fuse_s=single_s, sharded_fuse_s=sharded_s, launches=launches,
               pipeline_equal=bool(np.array_equal(sharded.result(), volume)))
    z_integ, rec["sharded_z_fuse_s"] = ReconstructionPipeline(
        cfg, mesh=mesh4, shard_axis="z").fuse(dataset)
    rec["pipeline_z_equal"] = bool(np.array_equal(z_integ.result(), volume))
    del z_integ

    views = [v.thresholded(cfg.threshold_best_cost) for v in dataset]
    batches = [views[s : s + cfg.stream_batch] for s in range(0, len(views), cfg.stream_batch)]
    culled = ShardedTSDFIntegrator(grid, params, mesh4).reset()
    inter = ShardedTSDFIntegrator(grid, params, mesh4, slab_interleave=True).reset()
    mesh22 = make_mesh(n_z=2, n_v=2, devices=["cuda:0"] * 4)
    vpar = ShardedTSDFIntegrator(grid, params, mesh22).reset()
    for b in batches:
        culled.integrate_pallas(b, frustum_cull=True)
        inter.integrate(b)
        vpar.integrate_view_parallel(b)
    rec["frustum_cull_equal"] = bool(np.array_equal(culled.result(), volume))
    rec["interleave_equal"] = bool(np.array_equal(inter.result(), volume))
    vp_err = float(np.abs(vpar.result() - volume).max())
    rec.update(view_parallel_max_abs_err=vp_err, view_parallel_atol=VIEW_PARALLEL_ATOL)
    del culled, inter, vpar

    dense_dev = torch.from_numpy(volume).cuda()
    rec["cell_to_point_equal"] = bool(torch.equal(
        torch.cat([b.to("cuda:0") for b in sharded_cell_to_point(sharded.slabs)]),
        cell_to_point(dense_dev)))
    t1 = time.perf_counter()
    dense = extract_isosurface(grid, dense_dev, contour)
    rec["dense_extract_s"] = time.perf_counter() - t1
    del dense_dev
    t1 = time.perf_counter()
    dist = sharded_extract_isosurface(sharded.slabs, grid, contour, mesh4)
    rec["sharded_extract_s"] = time.perf_counter() - t1
    rec.update(triangles=dist.num_triangles, dense_triangles=dense.num_triangles,
               mesh_points_equal=bool(np.array_equal(dist.points, dense.points)),
               mesh_triangles_equal=bool(np.array_equal(dist.triangles, dense.triangles)),
               mesh_normals_equal=bool(np.array_equal(dist.point_data["Normals"],
                                                      dense.point_data["Normals"])))
    coloration_cuda.launches = 0
    t1 = time.perf_counter()
    got = sharded_colorize_points(dist.points, views, mesh4)
    rec["sharded_colorize_s"] = time.perf_counter() - t1
    col_launches = coloration_cuda.launches
    exp = colorize_points(dist.points, views, device="cuda")
    rec.update(coloration_launches=col_launches,
               coloration_equal=all(bool(np.array_equal(a, b)) for a, b in zip(got, exp)),
               seconds=time.perf_counter() - t0)
    ok = (rec["pipeline_equal"] and rec["pipeline_z_equal"] and rec["frustum_cull_equal"]
          and rec["interleave_equal"]
          and vp_err <= VIEW_PARALLEL_ATOL and rec["cell_to_point_equal"]
          and dist.num_triangles == dense.num_triangles > 0 and rec["mesh_points_equal"]
          and rec["mesh_triangles_equal"] and rec["mesh_normals_equal"]
          and rec["coloration_equal"] and launches == 8 and col_launches > 0)
    emit(dict(phase="sharded", **rec, ok=ok))
    if not ok:
        raise AssertionError("multi-device fusion is off")


def mp_scene():
    from cudadepthmapintegration_torch.core import RayPotential

    return (cube_grid((MP_DIMS,) * 3, (-1.6,) * 3),
            RayPotential(thick=0.025, rho=0.8, eta=0.03, delta=0.1),
            orbit_views(MP_VIEWS, MAP, MAP))


def mp_worker(rank: int, coord: str, out_dir: str) -> int:
    """One of the two processes of :func:`multiprocess_phase`: joins the gloo
    group, fuses its striped units on the card through the runner (with
    per-process checkpoints), then sums the partial volumes across the
    processes; rank 0 saves the sum. Prints one JSON line."""
    from cudadepthmapintegration_torch.kernels import integrate_cuda
    from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator
    from cudadepthmapintegration_torch.parallel import distributed
    from cudadepthmapintegration_torch.pipeline.runner import FaultTolerantRunner

    t0 = time.perf_counter()
    distributed.initialize(coordinator_address=coord, num_processes=2, process_id=rank)
    grid, params, views = mp_scene()
    integ = TSDFIntegrator(grid, params, device="cuda")

    def integrate_fn(volume, batch):
        return integ.reset(volume).integrate(batch).result()

    runner = FaultTolerantRunner(grid, params, integrate_fn, unit_size=MP_UNIT,
                                 checkpoint_path=os.path.join(out_dir, "mp.npz"),
                                 host_id=rank, num_hosts=2)
    integrate_cuda.launches = 0
    partial = runner.run(views)
    launches = integrate_cuda.launches
    total = distributed.all_sum_volume(partial)
    if rank == 0:
        np.save(os.path.join(out_dir, "total.npy"), total)
    topo = distributed.topology_summary()
    import torch.distributed as dist

    dist.destroy_process_group()
    emit(dict(rank=rank, launches=launches, units=sorted(runner.completed_units),
              topology=topo, seconds=time.perf_counter() - t0))
    return 0


def multiprocess_phase():
    """Two processes of this script on the one card, joined by
    ``parallel.distributed`` (gloo): each fuses its striped units through the
    runner, and ``all_sum_volume`` must equal the same two replicas summed
    in this process bit for bit."""
    import socket

    from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    with tempfile.TemporaryDirectory(prefix="cdmi_smoke_mp_") as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker",
                                   str(rank), coord, tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"multi-process worker exited {p.returncode}: {o[-2000:]}")
        workers = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        total = np.load(os.path.join(tmp, "total.npy"))
    grid, params, views = mp_scene()
    integ = TSDFIntegrator(grid, params, device="cuda")
    replicas = []
    for rank in range(2):
        vol = np.zeros(grid.volume_shape, np.float32)
        for start in range(rank * MP_UNIT, len(views), 2 * MP_UNIT):
            vol = integ.reset(vol).integrate(views[start : start + MP_UNIT]).result()
        replicas.append(vol)
    sequential = integ.reset().integrate(views).result()
    rec = dict(processes=2, backend="gloo", cells=list(grid.volume_shape), views=len(views),
               unit=MP_UNIT, workers=workers,
               equal_replica_sum=bool(np.array_equal(total, replicas[0] + replicas[1])),
               sequential_max_abs_err=float(np.abs(total - sequential).max()),
               atol=VIEW_PARALLEL_ATOL, seconds=time.perf_counter() - t0)
    ok = (rec["equal_replica_sum"] and rec["sequential_max_abs_err"] <= VIEW_PARALLEL_ATOL
          and [w["units"] for w in workers] == [[0, 2], [1, 3]]
          and all(w["launches"] == 2 for w in workers))
    emit(dict(phase="multiprocess", **rec, ok=ok))
    if not ok:
        raise AssertionError("multi-process fusion is off")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2

    from cudadepthmapintegration_torch.cli import colorize, reconstruct
    from cudadepthmapintegration_torch.core import RayPotential
    from cudadepthmapintegration_torch.io import read_mha, read_vtp, write_depth_map_vti, write_krtd
    from cudadepthmapintegration_torch.kernels import _build, coloration_cuda, integrate_cuda
    from cudadepthmapintegration_torch.ops.coloration import POINT_CHUNK
    from cudadepthmapintegration_torch.ops.oracle import integrate_views_oracle
    from cudadepthmapintegration_torch.pipeline.reconstruction import ReconstructionPipeline

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi))

    # 2. Build.
    t0 = time.perf_counter()
    _build.load_library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              compiled=_build.BUILD.compiled, library=str(_build.BUILD.path),
              spill_bytes=sum(int(n) for n in re.findall(r"(\d+) bytes spill", _build.BUILD.log)),
              ptxas=[ln.strip() for ln in _build.BUILD.log.splitlines()
                     if "entry function" in ln or "registers" in ln or "spill" in ln]))

    # 3. Integrate kernel vs plain version.
    t0 = time.perf_counter()
    bench = RayPotential(thick=0.025, rho=0.8, eta=0.03, delta=0.1)
    # The odd grid's origin is offset like the repo's parity cases
    # (scripts/tpu_validate.py), so that no voxel center of this symmetric
    # rig sits on an exact half-pixel boundary, where float32 and float64
    # may round to different pixels.
    cases = [
        ("512^3 x 32 views 512x512", (DIMS,) * 3, (-1.6,) * 3, orbit_views(32, MAP, MAP)),
        ("256^3 x 8 views 1920x1080", (257,) * 3, (-1.6,) * 3,
         orbit_views(8, 1920, 1080, focal=900.0)),
        ("odd 100x66x44 x 12 views 320x240", (101, 67, 45), (-1.63, -1.61, -1.59),
         orbit_views(12, 320, 240, focal=200.0)),
    ]
    records = []
    for label, dims, origin, views in cases:
        grid = cube_grid(dims, origin)
        rec, vol = integrate_case(label, grid, views, bench)
        records.append(rec)
        emit(dict(phase="integrate", **rec, ok=True))
    # The odd grid against the float64 oracle: the pixel-flip budget of
    # docs/PARITY.md, at most 2e-4 of the voxels off by more than 1e-3.
    oracle = integrate_views_oracle(grid, views, bench)
    off = float((np.abs(vol - oracle) > 1e-3).mean())
    emit(dict(phase="integrate_oracle", case=label, off_frac=off, budget=2e-4))
    if off > 2e-4:
        raise AssertionError(f"integrate kernel off the float64 oracle on {off:.2e} of voxels")
    emit(dict(phase="integrate_done", seconds=time.perf_counter() - t0))
    del vol
    torch.cuda.empty_cache()

    # 3b. Rows 3-6: the integrate kernel at the other TPU modes' shapes.
    mode_rows = integrate_modes_phase(bench, cases[0][3])
    # 3c. The z-slab path's options against its default.
    shard_options_phase(bench, {"orbit": cases[0][3],
                                "scan": mapping_scan_views(32, MAP, MAP, 300.0)})
    del cases
    torch.cuda.empty_cache()

    # 4. Coloration kernel vs plain version: a 1M-point sphere sample in
    # raster order against 64 views, in the main path's vertex chunks.
    t0 = time.perf_counter()
    views = orbit_views(N_VIEWS, MAP, MAP)
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((1 << 20, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts = pts[np.lexsort(pts.T)].astype(np.float32)
    proj = torch.from_numpy(np.stack(
        [(v.camera.k4 @ v.camera.rt)[:3, :] for v in views]).astype(np.float32)).cuda()
    colors = torch.from_numpy(np.stack([v.color for v in views])).cuda()
    pts_d = torch.from_numpy(pts).cuda()
    n_valid, col_err = 0, 0
    for s in range(0, pts.shape[0], POINT_CHUNK):
        chunk = pts_d[s : s + POINT_CHUNK]
        ks, kv = coloration_cuda.gather_colors(chunk, proj, colors)
        ps, pv = coloration_cuda.gather_colors_torch(chunk, proj, colors)
        if not (torch.equal(ks, ps) and torch.equal(kv, pv)):
            emit(dict(phase="coloration", ok=False, chunk=s,
                      valid_differ=int((kv != pv).sum()),
                      samples_differ=int((ks != ps).any(-1).sum())))
            raise AssertionError("coloration kernel differs from its plain version")
        n_valid += int(kv.sum())
        col_err = max(col_err, int((ks.int() - ps.int()).abs().max()))
    chunk = pts_d[:POINT_CHUNK]
    col = dict(points=int(pts.shape[0]), views=N_VIEWS, chunk=POINT_CHUNK,
               valid_frac=n_valid / (pts.shape[0] * N_VIEWS), max_abs_err=col_err)
    col["ms"] = cuda_ms(lambda: coloration_cuda.gather_colors(chunk, proj, colors), REPS)
    col["plain_ms"] = cuda_ms(lambda: coloration_cuda.gather_colors_torch(chunk, proj, colors), REPS)
    col["samples_per_s"] = POINT_CHUNK * N_VIEWS / (col["ms"] / 1e3)
    col["plain_samples_per_s"] = POINT_CHUNK * N_VIEWS / (col["plain_ms"] / 1e3)
    emit(dict(phase="coloration", **col, seconds=time.perf_counter() - t0, ok=True))
    del pts_d, proj, colors
    torch.cuda.empty_cache()

    # 5. The main path: both CLIs, in process, on a dataset written to disk.
    with tempfile.TemporaryDirectory(prefix="cdmi_smoke_") as tmp:
        t0 = time.perf_counter()
        for i, v in enumerate(views):
            write_depth_map_vti(os.path.join(tmp, f"f{i:03d}.vti"), v.depth, v.color, v.best_cost)
            write_krtd(os.path.join(tmp, f"f{i:03d}.krtd"), v.camera)
        with open(os.path.join(tmp, "vtiList.txt"), "w") as f:
            f.write("".join(f"f{i:03d}.vti\n" for i in range(N_VIEWS)))
        with open(os.path.join(tmp, "kList.txt"), "w") as f:
            f.write("".join(f"f{i:03d}.krtd\n" for i in range(N_VIEWS)))
        emit(dict(phase="dataset", views=N_VIEWS, map=[MAP, MAP],
                  seconds=time.perf_counter() - t0))
        del views

        paths = {k: os.path.join(tmp, k) for k in ("mesh.vtp", "grid.vts", "vol.mha", "col.vtp")}
        spacing = 3.2 / (DIMS - 1)
        cli_args = [
            "--gridDims", str(DIMS), "--gridOrigin", "-1.6", "-1.6", "-1.6",
            "--gridEnd", "1.6", "1.6", "1.6",
            "--rayThick", repr(2 * spacing), "--rayDelta", repr(8 * spacing),
            "--rayRho", "0.8", "--rayEta", "0.03",
            "--threshBestCost", "0.5", "--contour", "1.0",
            "--dataFolder", tmp, "--outputMeshFilename", paths["mesh.vtp"],
            "--outputGridFilename", paths["grid.vts"], "--device", "cuda",
        ]
        # The CLIs run in process; keep each reconstruct run's result so
        # that the checkpoint phase can compare volumes.
        captured = []
        pipeline_run = ReconstructionPipeline.run

        def capturing_run(self, *a, **k):
            captured.append(pipeline_run(self, *a, **k))
            return captured[-1]

        ReconstructionPipeline.run = capturing_run
        integrate_cuda.launches = 0
        coloration_cuda.launches = 0
        t0 = time.perf_counter()
        rc = reconstruct.main(cli_args + ["--mhaPath", paths["vol.mha"], "--summary"])
        t_rec = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"reconstruct exited {rc}")
        t0 = time.perf_counter()
        rc = colorize.main([
            "--input", paths["mesh.vtp"], "--output", paths["col.vtp"],
            "--vti", os.path.join(tmp, "vtiList.txt"), "--krtd", os.path.join(tmp, "kList.txt"),
            "--device", "cuda",
        ])
        t_col = time.perf_counter() - t0
        launches = {"integrate": integrate_cuda.launches, "coloration": coloration_cuda.launches}
        if rc != 0:
            raise AssertionError(f"colorize exited {rc}")
        with open(os.path.join(tmp, "summary.txt")) as f:
            summary = [ln for ln in f.read().splitlines() if ln.startswith("--- ")]
        emit(dict(phase="cli", reconstruct_s=t_rec, colorize_s=t_col, launches=launches,
                  summary=summary,
                  file_mb={k: os.path.getsize(p) / 1e6 for k, p in paths.items()}))

        # Read the outputs back and check them.
        mesh = read_vtp(paths["col.vtp"])
        radii = np.linalg.norm(mesh.points, axis=1)
        count = mesh.point_data["NbProjectedDepthMap"].reshape(-1)
        vol, _ = read_mha(paths["vol.mha"])
        check = dict(points=mesh.num_points, triangles=mesh.num_triangles,
                     median_radius=float(np.median(radii)),
                     radius_in_0p95_1p05=float(((radii > 0.95) & (radii < 1.05)).mean()),
                     counted_frac=float((count > 0).mean()),
                     arrays=sorted(mesh.point_data), mha_shape=list(vol.shape),
                     mha_finite=bool(np.isfinite(vol).all()))
        emit(dict(phase="outputs", **check))
        need = {"MeanColoration", "MedianColoration", "NbProjectedDepthMap", "Normals"}
        problems = [
            msg for bad, msg in (
                (mesh.num_triangles == 0, "the mesh has no triangles"),
                (not np.isfinite(mesh.points).all(), "mesh points are not finite"),
                (not 0.95 <= check["median_radius"] <= 1.05, "median radius off the unit sphere"),
                (not need <= set(mesh.point_data), "colour arrays missing"),
                (check["counted_frac"] < 0.9, "too few vertices were seen"),
                (vol.shape != (DIMS,) * 3 or not check["mha_finite"], "bad .mha volume"),
                (launches["integrate"] == 0, "the CLI never launched the integrate kernel"),
                (launches["coloration"] == 0, "the CLI never launched the coloration kernel"),
            ) if bad
        ]
        if problems:
            raise AssertionError("; ".join(problems))

        # 5b. Resumable fusion on the same dataset, against the CLI run above.
        plain_volume = captured.pop().volume
        del mesh, vol, radii, count
        checkpoint_phase(tmp, cli_args, plain_volume, captured)
        ReconstructionPipeline.run = pipeline_run
        del plain_volume
        torch.cuda.empty_cache()

        # 5c. Multi-device fusion on four slabs of this card.
        sharded_phase(tmp, RayPotential(thick=2 * spacing, rho=0.8, eta=0.03,
                                        delta=8 * spacing), 1.0)
        torch.cuda.empty_cache()

    # 5d. Two processes on this card, joined by torch.distributed.
    multiprocess_phase()

    # 6. The sparse RGB-D path: its kernel vs its plain versions (2 voxels
    # thick, an 8-voxel band: fuse_rgbd's defaults), then the fuse_rgbd CLI.
    sparse = sparse_kernel_phase(
        RayPotential(thick=2 * SPARSE_VOXEL, rho=0.8, eta=0.03, delta=8 * SPARSE_VOXEL))
    emit(dict(phase="sparse_kernel", **sparse, ok=True))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cdmi_smoke_rgbd_") as tmp:
        launches["sparse_fuse"] = fuse_rgbd_phase(tmp)

    main_case = records[0]
    emit({"kernels": [
        dict(name="integrate", route="cuda",
             source="cudadepthmapintegration_torch/csrc/integrate.cu",
             replaces="cudadepthmapintegration_tpu/kernels/integrate_pallas.py:925",
             launches=launches["integrate"],
             max_abs_err=max(r["max_abs_err"] for r in records),
             ms=main_case["ms"], plain_ms=main_case["plain_ms"]),
        *(dict(name=f"integrate[{r['mode']}]", route="cuda",
               source="cudadepthmapintegration_torch/csrc/integrate.cu",
               replaces=r["replaces"], launches=r["launches"], max_abs_err=r["max_abs_err"],
               ms=r["ms"], plain_ms=r["plain_ms"]) for r in mode_rows),
        dict(name="coloration", route="cuda",
             source="cudadepthmapintegration_torch/csrc/coloration.cu",
             replaces="cudadepthmapintegration_tpu/kernels/coloration_pallas.py:85",
             launches=launches["coloration"], max_abs_err=col["max_abs_err"],
             ms=col["ms"], plain_ms=col["plain_ms"]),
        dict(name="sparse_fuse", route="cuda",
             source="cudadepthmapintegration_torch/csrc/sparse_fuse.cu",
             replaces="cudadepthmapintegration_tpu/kernels/gather_points.py:35",
             launches=launches["sparse_fuse"],
             max_abs_err=max(max(sparse[c]["max_abs_err"].values()) for c in ("depth", "colour")),
             ms=sparse["colour"]["ms"], plain_ms=sparse["colour"]["plain_ms"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
