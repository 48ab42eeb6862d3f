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
* on the main path's dataset and volume: ``ReconstructionFilter`` (phase
  ``filter``, bit-equal to the CLI's volume), the contour by its three
  routes, device with the host or the device weld and the native float64
  walker (phase ``mesh_backends``: seconds, bytes copied to the host, the
  device weld bit-equal to the host weld), the views' zlib blocks decoded
  by the native codec and by Python ``zlib`` (phase ``vti_decode``), and
  ``cudareconstruction --trace --metrics`` at 256^3 in a process of its own
  (``--trace-metrics DIR``; phase ``trace_metrics``: the trace must name the
  integrate kernel). The build phase also builds the native host library
  (``make -C native``);
* the integrate kernel at the shapes of the JAX package's other kernel
  modes (phase ``integrate_modes``): ``windows`` through the z-sharded
  staging on four slabs of one card, a straight-down mapping scan, 4K maps
  and 1024x768 maps;
* resumable fusion: ``cudareconstruction --checkpoint`` on the main path's
  dataset, uninterrupted, then preempted and resumed (phase
  ``checkpoint``);
* multi-device fusion on a four-slab mesh of one card: the sharded
  pipeline, frustum culling, interleaved slabs, view-parallel fusion, and
  the sharded cell->point, isosurface (on the card, and with the native
  walker against the dense native mesh) and coloration (phase ``sharded``),
  each option of the z-slab path timed against its default (phase
  ``shard_options``);
* multi-process fusion: two processes of this script (``--mp-worker``) on
  the one card, joined by ``torch.distributed`` (phase ``multiprocess``);
* sparse RGB-D fusion: ``fuse_rgbd --onlineColor`` over a 300-frame
  640x480 sequence with TUM freiburg1 intrinsics orbiting the unit sphere;
* the capstone (``python -m cudadepthmapintegration_torch.scripts.
  capstone_1024``) in a process of its own (``--capstone``; phase
  ``capstone``): 1000 maps of 512x512 rendered on the card and fused into
  1024^3 cells, the whole volume meshed and coloured against every view,
  then its ``ckpt`` drill and its ``hd`` mode. 16 slices and 8 windows of
  the volume are held to the plain version in bit patterns, the windows to
  the float64 oracle (the share of projected samples whose pixel float32
  flips stays within the flip budget; the voxels off are reported), and one
  vertex chunk to the plain gather and statistics;
* the port's counterparts of the JAX side's last four top-level scripts
  (``cudadepthmapintegration_torch/scripts/``), each in a process of its own
  with the launch counts set to 0 just before its path and read just
  after: ``pipeline_e2e`` (``--pipeline-e2e``: BASELINE config 3, 512^3
  cells from 200 views of 512x512 rendered, fused, meshed, coloured and
  written, its volume bit-equal to the plain version over every map),
  ``fuzz_extended`` (``--fuzz-extended``: four random scenes of
  tests/test_fuzz_parity.py and 100 from seed 1000 through every route,
  each held to the plain versions), ``fp32_error`` (``--fp32-error``: the
  float32 error against the float64 oracle at 8, 64, 256 and 1000 views,
  the CUDA kernel at each, bit-equal to the plain version) and
  ``pod_probe`` (``--pod-probe``: ``--local 4``, views/s on 1, 2 and 4
  z-slabs of the card, bit-equal across them and to the plain version, the
  staging split and the resume costs).

The integrate kernel is held to its plain version in bit patterns (int32
view, which tells -0.0 from +0.0), on the odd grid from a volume of -0.0
too, and so is the CLI's fused volume. Every
kernel record carries its bound: the least time an H100 could take for the
same work, the larger of its FLOPs over the FP32 peak and its bytes (each
input read once, each output written once) over the HBM rate, with the
share of it the kernel reached.

The coloration gather is also held to its plain version with ``z_test``,
with the occlusion test and on samples that miss every view (phase
``coloration_masks``), and ``colorize --occlusionTol`` runs both coloration
kernels (phase ``cli_occlusion``).

The sparse fuse kernels are held to their plain versions in bit patterns
on eight cases (phase ``sparse_kernel``): one fr1 frame into ~5,600 blocks
of 8^3 (the row kernel), the same from pools of -0.0, the same with blocks
across the camera plane, behind it and off the image, and the frame into
blocks of (4, 6, 5), 4^3, 16^3 and (3, 5, 7), the last also from pools of
-0.0 (the general kernel). Each is timed four ways: CUDA events around a call
(``ms``), the kernel's device time under ``torch.profiler``
(``device_ms``), the same with the L2 flushed before each call
(``cold_device_ms``, the yardstick against the byte bound) and the Python
call's wall time (``host_ms``). The cases run in a fresh process of this
script (``--sparse-cases``): late in a long process ``torch.profiler``
recorded no device time.

Every phase prints one JSON line. The line before the last holds the
kernels' record (launches counted during each kernel's CLI run only, and
during the capstone's default mode as ``capstone_launches`` and each of the
port's scripts' paths as ``<phase>_launches``, errors,
bounds and CUDA-event times of one call measured here; the coloration
records carry the card's own time, ``device_ms``, beside them); the last
line is ``{"ok": true, "device": {...}}``. Any failure raises, and the
script exits non-zero without that line. It needs no network and imports no
JAX.

``python3 chip_smoke.py --integrate-shapes`` does one thing only: it builds
``csrc/integrate.cu`` once per launch shape (voxels a thread along z, block
shape), holds each build to the plain version bit for bit and times it on
the integrate cases. ``python3 chip_smoke.py --coloration-shapes`` does the
same for ``csrc/coloration.cu`` (views a gather thread, threads a block of
each kernel) on one vertex chunk of the coloration phase, and ``python3
chip_smoke.py --sparse-shapes [rows|general]`` for ``csrc/sparse_fuse.cu``
(the row kernel's voxels a thread and blocks a CTA on the fr1 frame, the
general kernel's voxels a thread and threads a CTA on the frame's (4, 6, 5)
blocks), by cold device time. The library
itself is built with one shape. ``python3 chip_smoke.py --gather-ab DIR``
times the coloration gather of the checkout unpacked in ``DIR`` against
this checkout's, each built from its own sources in a process of its own,
and ``python3 chip_smoke.py --sparse-ab DIR [BZxBYxBX]`` the sparse fuse
kernel on blocks of that shape (8x8x8 by default).
"""

from __future__ import annotations

import itertools
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
# An H100 SXM's peaks (NVIDIA's data sheet): FP32 outside the tensor cores
# and HBM3. The bounds are taken against them, whatever the power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# FLOPs of one unit of work, counted from the kernels' arithmetic:
# an integrate (voxel, view) update: 8 adds for hom, 2 divisions, 2 x 2 for
# the roundings, 3 for the ray potential and the accumulate;
INTEGRATE_FLOPS = 17
# a coloration (vertex, view) sample: 3 rows x (3 multiplies + 3 adds), 2
# divisions, 2 x 2 for the roundings;
COLORATION_FLOPS = 24
# a sample of the colour statistics: the count, three sums and one
# selection step a channel (integer operations, taken at the FP32 rate);
STATS_OPS = 7
# a sparse voxel update: 4 rows x (3 multiplies + 3 adds), 2 divisions,
# 2 x 2 for the roundings, 3 for the potential and the accumulate; with
# colour 11 more (a division, the falloff, 3 multiply-adds, the weight).
SPARSE_FLOPS, SPARSE_COLOR_FLOPS = 33, 11
NEG_ZERO = -(1 << 31)  # the int32 bits of -0.0
# The launch shapes `--integrate-shapes` builds csrc/integrate.cu with:
# voxels a thread along z, and threads a block along x and y.
SHAPE_KZS = (1, 2, 4, 8, 16)
SHAPE_BLOCKS = ((32, 4), (32, 8), (16, 8), (8, 16))
# The launch shapes `--coloration-shapes` builds csrc/coloration.cu with:
# (views a gather thread, gather threads a block, statistics threads a
# block, words a statistics thread loads ahead); the statistics shapes ride
# on the library's gather shape.
COLOR_SHAPES = (*((g, t, 128, 8) for g in (1, 2, 4, 8, 16) for t in (128, 256)),
                *((8, 256, st, b) for st in (64, 128) for b in (1, 4, 16, 32)), (8, 256, 64, 8),
                (8, 256, 256, 8))
# Crafted sample columns straight into the statistics: (views, vertices),
# every column kind in each: few views, then 1,000 views (bin counts past
# 255) and 65,535 views (a bin of 65,535 samples), ~260 MB of words each.
STATS_CASES = ((1, 7 * 96), (2, 7 * 96), (17, 7 * 96), (300, 7 * 96), (1000, 65536),
               (65535, 1024))
# The occlusion tolerance of the gather's card cases and of the colorize
# run with --occlusionTol: 8 voxels of the main path's grid.
OCCLUSION_TOL = 0.05
# The scratch buffer a cold device time writes and reads before each run:
# five times the H100's 50 MB L2.
L2_FLUSH_BYTES = 256 << 20
# A substring of the name of every sparse fuse kernel in csrc/sparse_fuse.cu
# (and of the one before it), as torch.profiler reports kernel names.
SPARSE_KERNEL_NAME = "sparse_fuse"
# The launch shapes `--sparse-shapes` builds csrc/sparse_fuse.cu with:
# voxels a thread along an x-row of an 8^3 block, and sparse blocks a CTA.
# A CTA has blocks x 512 / voxels threads, at most 1,024; at 1,024 a thread
# has 64 registers, fewer than the colour kernel needs at 4 voxels a thread
# (it spilled), so (4, 8) is left out.
SPARSE_SHAPES = tuple((vx, nb) for vx in (1, 2, 4, 8) for nb in (1, 2, 4, 8)
                      if nb * 512 // vx <= 1024 and (vx, nb) != (4, 8))
# The general kernel's launch shapes `--sparse-shapes` builds with:
# consecutive voxels a thread, and threads a CTA (at most 512, the source's
# static_assert). A shape that spills is reported and timed, and is no
# candidate for the library's shape.
SPARSE_GEN_SHAPES = tuple((vx, t) for vx in (1, 2, 4, 8) for t in (128, 256, 512))
# The general kernel's block shapes in phase sparse_kernel: (4, 6, 5), whose
# time stands in the kernels line; 4^3 and 16^3 (voxblox's default
# voxels_per_side), as users pick them; (3, 5, 7), whose voxels do not come
# in whole 16-byte vectors (word traffic), also from pools of -0.0.
GENERAL_BLOCKS = ((4, 6, 5), (4, 4, 4), (16, 16, 16), (3, 5, 7))
GENERAL_CASES = (*("block_" + "x".join(map(str, b)) for b in GENERAL_BLOCKS),
                 "block_3x5x7_neg_zero")
# The grid extent of the main path along each axis, [-1.6, 1.6].
EXTENT = 3.2
# The keys of the metrics report, as the JAX package writes them
# (cudadepthmapintegration_tpu/utils/profiling.py, FusionMetrics.report).
METRICS_KEYS = ["voxels", "views", "seconds", "voxel_updates_per_sec", "views_per_sec",
                "hbm_roofline_fraction"]
# reconstruct --trace --metrics runs at 256^3 cells, so its .vts write stays
# short.
TRACE_DIMS = 257
# Each meshing route on the main path's volume is timed this many times, in
# turns with the others; the median is kept.
MESH_REPS = 3
# The capstone's checks: slices through the sphere's middle held to the plain
# version, and windows across its surface held to the float64 oracle.
CAPSTONE_SLAB = 16
CAPSTONE_WINDOWS = 8
CAPSTONE_WINDOW = 128
# Seeds of tests/test_fuzz_parity.py's random scenes that the fuzz phase
# runs before the extended fuzz's.
FUZZ_SEEDS = (1, 11, 12, 13)
# The extended fuzz's seeds: (how many, the first), the JAX script's defaults.
FUZZ_EXTENDED = (100, 1000)
# The port scripts' phases, each a process of this script: (flag, phase).
SCRIPT_PHASES = (("--pipeline-e2e", "pipeline_e2e"), ("--fuzz-extended", "fuzz_extended"),
                 ("--fp32-error", "fp32_error"), ("--pod-probe", "pod_probe"))
# The TPU run's mesh of BASELINE config 3 (E2E_512.json: points, triangles),
# reported beside the card's, not compared: that volume went through another
# staging.
E2E_TPU_MESH = (906386, 1812772)


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


def device_ms(fn, reps: int, kernel: str | None = None, cold: bool = False) -> float:
    """Milliseconds the card spends in the kernels and copies of one
    ``fn()``: their device times under ``torch.profiler`` summed over
    ``reps`` runs after one warm-up, divided by ``reps``. Unlike
    :func:`cuda_ms`, it leaves out the time the card waits for the host to
    launch, which dominates a call of a few tens of microseconds.

    With ``kernel``, only the entries whose name contains it are summed.
    With ``cold`` (which needs ``kernel``), each run first flushes the L2: it
    writes a scratch buffer of ``L2_FLUSH_BYTES`` and reads it back, so that
    the run finds its inputs in device memory, as a caller whose other work
    passed through the L2 would, and the L2 holds no dirty line of the
    flush to write back during the run. The flush's own kernels fall outside
    the name filter."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cold and kernel is None:
        raise ValueError("a cold device time needs the kernel's name")
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if cold:
                scratch.fill_(1.0)
                scratch.sum()
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total_us = sum(e.self_device_time_total for e in events if kernel is None or kernel in e.key)
    if total_us <= 0:
        seen = sorted({e.key[:60] for e in events if e.self_device_time_total > 0})
        raise AssertionError(f"torch.profiler recorded no device time for {kernel or 'fn'} "
                             f"(device entries: {seen})")
    return total_us / reps / 1e3


def host_ms(fn, reps: int) -> float:
    """Median wall milliseconds of the Python call ``fn()`` over ``reps``
    runs after one warm-up, the card drained before each and not waited for
    after it: what the caller's thread spends to launch."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def roofline(flops, nbytes, ms):
    """The bound of work of ``flops`` FLOPs and ``nbytes`` bytes, and the
    share of it that a kernel taking ``ms`` reached."""
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound = max(ops_ms, bytes_ms)
    return dict(flops=flops, bytes=nbytes, bound_ms=bound,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                roofline_share=bound / ms)


def integrate_roofline(cells, views, cells_xyz, map_hw, ms):
    """Integrate: the volume read and written once, the maps and the
    (V, 4, c) tables read once."""
    cz, cy, cx = cells_xyz
    nbytes = 8 * cells + 4 * views * (map_hw[0] * map_hw[1] + 4 * (cx + cy + cz + 1))
    return roofline(INTEGRATE_FLOPS * cells * views, nbytes, ms)


def nvidia_smi() -> str:
    """The card's name and power limit, printed on a line of their own."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def same_bits(a, b) -> bool:
    """Equal bit patterns: unlike ``==``, tells -0.0 from +0.0."""
    import torch

    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(np.array_equal(a.view(np.int32), b.view(np.int32)))


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


def sparse_params():
    """``fuse_rgbd``'s ray potential at the sparse path's voxel: 2 voxels
    thick, an 8-voxel band."""
    from cudadepthmapintegration_torch.core import RayPotential

    return RayPotential(thick=2 * SPARSE_VOXEL, rho=0.8, eta=0.03, delta=8 * SPARSE_VOXEL)


def sparse_case_grid(params, views, block_shape=(8, 8, 8)):
    """A colour grid of the sparse path on the card holding the blocks of
    the ``views``' trajectory, with the first three views fused, so that a
    later frame adds into non-zero pools. 8^3 blocks take the path's
    capacity; other shapes exactly as many blocks as the trajectory touches
    (16^3 blocks at the path's capacity would be 2.7 GB of pools)."""
    from cudadepthmapintegration_torch.ops.sparse_grid import SparseTSDFGrid

    capacity = SPARSE_CAPACITY
    if tuple(block_shape) != (8, 8, 8):
        probe = SparseTSDFGrid(voxel_size=SPARSE_VOXEL, params=params, block_shape=block_shape,
                               capacity=0, device="cpu")
        capacity = len(set().union(*(probe._touched_blocks(v) for v in views)))
    grid = SparseTSDFGrid(voxel_size=SPARSE_VOXEL, params=params, block_shape=block_shape,
                          capacity=capacity, with_color=True, device="cuda")
    grid.preallocate(views)  # the trajectory's blocks, as a known-trajectory run would
    for v in views[:3]:
        grid.integrate_frame(v)
    return grid


def straddle_batch(grid, view):
    """``view``'s batch with a cube of 9^3 blocks around its camera carved
    too, every one of them: the frustum test keeps the blocks across the
    camera plane, and the rest (wholly behind the camera, or off the image)
    are added as an over-inclusive caller would add them."""
    import torch

    rt = view.camera.rt
    eye = -rt[:3, :3].T @ rt[:3, 3]
    centre = np.floor(eye / grid._block_extent).astype(np.int64)
    cube = [tuple(int(x) for x in centre + d) for d in itertools.product(range(-4, 5), repeat=3)]
    grid._allocate(cube)
    batch = grid.frame_batch(view)
    have = set(batch.slots.tolist())
    extra = [c for c in cube if grid.block_map[c] not in have]
    slots = torch.tensor([grid.block_map[c] for c in extra], dtype=torch.int32, device="cuda")
    origins = torch.from_numpy(
        (np.array(extra, np.float64) * grid._block_extent).astype(np.float32)).cuda()
    return batch._replace(slots=torch.cat([batch.slots, slots]),
                          origins=torch.cat([batch.origins, origins]))


def sparse_views():
    """The sparse cases' frames: an 8-frame fr1 orbit; each case fuses the
    first three and takes frame 3."""
    return [tum_orbit_view(i, 8) for i in range(8)]


def sparse_cases(params):
    """The sparse kernels' cases, ``[(label, grid, batch, from_neg_zero)]``,
    each frame 3 of :func:`sparse_views`:

    * ``fr1``: into the trajectory's 8^3 blocks (~5,600): row 8's shape, the
      row kernel;
    * ``neg_zero``: the same with every pool word -0.0 before the frame;
    * ``straddle``: the same with the blocks of :func:`straddle_batch`;
    * ``block_4x6x5``, ``block_4x4x4``, ``block_16x16x16``, ``block_3x5x7``:
      the frame into blocks of each of ``GENERAL_BLOCKS``: the general
      kernel; ``block_3x5x7_neg_zero``: the last from pools of -0.0."""
    views = sparse_views()
    grid = sparse_case_grid(params, views)
    batch = grid.frame_batch(views[3])
    cases = [("fr1", grid, batch, False), ("neg_zero", grid, batch, True),
             ("straddle", grid, straddle_batch(grid, views[3]), False)]
    for shape, label in zip(GENERAL_BLOCKS, GENERAL_CASES):
        odd = sparse_case_grid(params, views, block_shape=shape)
        cases.append((label, odd, odd.frame_batch(views[3]), False))
    cases.append((GENERAL_CASES[-1], *cases[-1][1:3], True))
    return cases


def sparse_bound(voxels, colour, n_blocks, map_hw, ms):
    """Bound of one sparse fuse call: the pools read and written once (4
    bytes a voxel, 16 more with colour), the frame's maps (4 bytes a pixel,
    3 more with colour), slots and origins (16 bytes a block) read once."""
    flops = (SPARSE_FLOPS + (SPARSE_COLOR_FLOPS if colour else 0)) * voxels
    nbytes = (2 * (4 + (16 if colour else 0)) * voxels
              + map_hw[0] * map_hw[1] * (4 + (3 if colour else 0)) + 16 * n_blocks)
    return roofline(flops, nbytes, ms)


def sparse_times(run, voxels, colour, n_blocks, map_hw):
    """One sparse fuse call ``run()`` timed four ways: ``ms`` (CUDA events
    around the call, the host's launch included), ``device_ms`` (the
    kernel's own time under ``torch.profiler``), ``cold_device_ms`` (the
    same with the L2 flushed before each call: the yardstick against the
    byte bound) and ``host_ms`` (the Python call's wall time). With the
    bound, and its share by CUDA events (``roofline_share``) and by cold
    device time (``cold_device_share``)."""
    rec = dict(ms=cuda_ms(run, REPS), device_ms=device_ms(run, REPS, SPARSE_KERNEL_NAME),
               cold_device_ms=device_ms(run, REPS, SPARSE_KERNEL_NAME, cold=True),
               host_ms=host_ms(run, REPS))
    rec["voxel_updates_per_s"] = voxels / (rec["ms"] / 1e3)
    rec.update(sparse_bound(voxels, colour, n_blocks, map_hw, rec["ms"]))
    rec["cold_device_share"] = rec["bound_ms"] / rec["cold_device_ms"]
    return rec


def sparse_case(label, grid, batch, params, from_neg_zero=False):
    """One sparse case: the kernel against the plain versions in bit
    patterns, depth only and with colour, each from the grid's pools (or,
    with ``from_neg_zero``, from pools of -0.0: every voxel adds its
    potential or +0.0, so no touched word may stay -0.0), then timed by
    :func:`sparse_times`. Returns the case record."""
    import torch

    from cudadepthmapintegration_torch.kernels import sparse_cuda as sc
    from cudadepthmapintegration_torch.kernels.sparse_cuda import (
        sparse_accumulate_color_torch,
        sparse_fuse,
        sparse_fuse_torch,
    )

    h, w = batch.depth.shape
    ui, _, zcam = sc._project(batch.origins, batch.proj_rows, grid.axes, grid.block_shape, h, w)
    behind = (zcam < 0).flatten(1)
    n_blocks = int(batch.slots.shape[0])
    voxels = n_blocks * int(np.prod(grid.block_shape))
    # A checkout from before the row kernel (--sparse-time of a parent) has
    # one kernel and one counter.
    kind = sc.kernel_for(grid.block_shape) if hasattr(sc, "kernel_for") else "general"
    rec = dict(block_shape=list(grid.block_shape), blocks=n_blocks, voxels=voxels, map=[h, w],
               kernel=kind, valid_frac=float((ui >= 0).float().mean()),
               blocks_behind=int(behind.all(1).sum()),
               blocks_across_plane=int((behind.any(1) & ~behind.all(1)).sum()),
               voxels_off_image=int(((zcam >= 0) & (ui < 0)).sum()))
    del ui, zcam, behind
    args = (batch.slots, batch.origins, batch.proj_rows, grid.axes, batch.depth)
    touched = batch.slots.long()
    for colour in (False, True):
        names = ("pool", "color_pool", "weight_pool") if colour else ("pool",)
        plain = {k: getattr(grid, k).clone() for k in names}
        if from_neg_zero:
            for t in plain.values():
                t.fill_(-0.0)
        kernel = {k: t.clone() for k, t in plain.items()}

        def run_kernel(kernel=kernel, colour=colour):
            extra = {}
            if colour:
                extra = dict(color_pool=kernel["color_pool"], weight_pool=kernel["weight_pool"],
                             rgb=batch.rgb, band=grid.color_band)
            sparse_fuse(kernel["pool"], *args, params, **extra)

        def run_plain(plain=plain, colour=colour):
            sparse_fuse_torch(plain["pool"], *args, params)
            if colour:
                sparse_accumulate_color_torch(plain["color_pool"], plain["weight_pool"], *args,
                                              batch.rgb, grid.color_band)

        sc.launches = sc.rows_launches = 0
        run_kernel()
        launches = dict(all=sc.launches, rows=sc.rows_launches)
        run_plain()
        torch.cuda.synchronize()
        mode = "colour" if colour else "depth"
        out = dict(launches=launches,
                   equal_bits={k: same_bits(kernel[k], plain[k]) for k in names},
                   max_abs_err={k: float((kernel[k] - plain[k]).abs().max()) for k in names})
        ok = all(out["equal_bits"].values()) and launches == dict(all=1, rows=int(kind == "rows"))
        if from_neg_zero:
            words = {k: kernel[k][touched].view(torch.int32) for k in names}
            out["neg_zero_words"] = {k: int((v == NEG_ZERO).sum()) for k, v in words.items()}
            out["pos_zero_words"] = {k: int((v == 0).sum()) for k, v in words.items()}
            ok = ok and not any(out["neg_zero_words"].values()) and out["pos_zero_words"]["pool"] > 0
        if not ok:
            emit(dict(phase="sparse_kernel", case=label, mode=mode, **rec, **out, ok=False))
            raise AssertionError(f"sparse fuse kernel differs from its plain version ({label}, {mode})")
        out["plain_ms"] = cuda_ms(run_plain, 3)
        out.update(sparse_times(run_kernel, voxels, colour, n_blocks, (h, w)))
        rec[mode] = out
        del plain, kernel
    return rec


def sparse_cases_main() -> int:
    """``--sparse-cases``: :func:`sparse_case` on every case of
    :func:`sparse_cases`, one line each, the frames' reach and the straddle
    case's geometry checked; the last line holds every case's record."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    params = sparse_params()
    cases = sparse_cases(params)
    out = {}
    for label, grid, batch, from_neg_zero in cases:
        out[label] = rec = sparse_case(label, grid, batch, params, from_neg_zero)
        emit(dict(phase="sparse_kernel", case=label, **rec, ok=True))
    missed = [label for label, rec in out.items() if not rec["valid_frac"] > 0]
    if float(cases[0][1].pool.abs().max()) <= 0.5 or missed:
        raise AssertionError(f"sparse kernel case: the frames missed the blocks {missed}")
    straddle = out["straddle"]
    if not (straddle["blocks_behind"] and straddle["blocks_across_plane"]
            and straddle["voxels_off_image"] and 0 < straddle["valid_frac"] < 1):
        raise AssertionError(f"the straddle case misses its geometry ({straddle})")
    emit(dict(phase="sparse_cases", cases=out))
    return 0


def sparse_kernel_phase(params):
    """The sparse fuse kernels against their plain versions on every case of
    :func:`sparse_cases`, in a process of its own (``--sparse-cases``), whose
    lines but the last are passed on: late in this process, after the
    phases before it, ``torch.profiler`` recorded no device time at all
    (PERF.md section 7), while a fresh process records every call. Then the
    general kernel's own path, here: ``integrate_frame`` of a (4, 6, 5)
    grid, launches counted from 0. Returns ``{case: record}`` and that
    path's launches."""
    import torch

    from cudadepthmapintegration_torch.kernels import sparse_cuda as sc

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--sparse-cases"],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr[-4000:], sep="\n", file=sys.stderr)
        raise AssertionError(f"--sparse-cases exited {proc.returncode}")
    print("\n".join(lines[:-1]), flush=True)
    out = json.loads(lines[-1])["cases"]
    views = sparse_views()
    odd = sparse_case_grid(params, views, block_shape=(4, 6, 5))
    sc.launches = sc.rows_launches = 0
    odd.integrate_frame(views[3])
    path = dict(all=sc.launches, rows=sc.rows_launches)
    del odd
    torch.cuda.empty_cache()
    emit(dict(phase="sparse_kernel_done", general_path="SparseTSDFGrid(block_shape=(4, 6, 5))"
              ".integrate_frame", general_path_launches=path,
              seconds=time.perf_counter() - t0, ok=path == dict(all=1, rows=0)))
    if path != dict(all=1, rows=0):
        raise AssertionError(f"the (4, 6, 5) grid did not launch the general kernel ({path})")
    return out, path["all"]


def fuse_rgbd_phase(tmp):
    """``fuse_rgbd --onlineColor --device cuda`` over a written sequence;
    returns the sparse kernels' launches in the run, one a frame, each of
    the row kernel (the grid's blocks are 8^3)."""
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
    integrate_cuda.launches = sparse_cuda.launches = sparse_cuda.rows_launches = 0
    coloration_cuda.launches = coloration_cuda.stats_launches = 0
    t0 = time.perf_counter()
    rc = fuse_rgbd.main([
        "--vti", lists["vti"], "--krtd", lists["krtd"], "--onlineColor", "--device", "cuda",
        "--voxelSize", repr(SPARSE_VOXEL), "--capacity", str(SPARSE_CAPACITY),
        "--pixelStride", "4", "--output", out,
    ], log=log)
    cli_s = time.perf_counter() - t0
    launches, rows_launches = sparse_cuda.launches, sparse_cuda.rows_launches
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
               rows_launches=rows_launches,
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
            (launches != frames or rows_launches != launches,
             "fuse_rgbd did not fuse every frame through the row kernel"),
        ) if bad
    ]
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def cube_grid(dims, origin):
    """A grid spanning 3.2 along each axis."""
    from cudadepthmapintegration_torch.core import VoxelGrid

    return VoxelGrid(dims=dims, origin=origin, spacing=tuple(3.2 / (d - 1) for d in dims))


def integrate_case(label, grid, views, params, from_neg_zero=False):
    """Kernel vs plain version on one grid; returns the case record and the
    fused volume. With ``from_neg_zero`` both run once more from a volume of
    -0.0."""
    import torch

    from cudadepthmapintegration_torch.kernels.integrate_cuda import (
        integrate_views,
        integrate_views_torch,
        stage_tables,
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
               differing_frac=float((kernel.view(torch.int32) != plain.view(torch.int32))
                                    .float().mean()))
    if not same_bits(kernel, plain):
        emit(dict(phase="integrate", **rec, ok=False))
        raise AssertionError(f"integrate kernel differs from its plain version ({label})")
    if float(kernel.abs().max()) <= 0.5:
        raise AssertionError(f"integrate case {label}: the scene missed the grid")
    if from_neg_zero:
        # Every sample adds its potential or +0.0, and -0.0 + +0.0 is +0.0,
        # so no -0.0 word may stay. A kernel that skipped the +0.0 add would
        # keep -0.0 where no valid sample reached: only the bits show it.
        k0, p0 = torch.full_like(kernel, -0.0), torch.full_like(plain, -0.0)
        integrate_views(k0, *args, params)
        integrate_views_torch(p0, *args, params)
        bits = k0.view(torch.int32)
        rec["from_neg_zero"] = neg = dict(
            equal_bits=same_bits(k0, p0), neg_zero_words=int((bits == NEG_ZERO).sum()),
            pos_zero_words=int((bits == 0).sum()))
        del k0, p0, bits
        if not neg["equal_bits"] or neg["neg_zero_words"] or not neg["pos_zero_words"]:
            emit(dict(phase="integrate", **rec, ok=False))
            raise AssertionError(f"integrate kernel from -0.0 is off ({label})")
    fused = kernel.cpu().numpy()  # the timed runs below keep accumulating
    rec["ms"] = cuda_ms(lambda: integrate_views(kernel, *args, params), REPS)
    # The wrapper's table staging alone, a part of ``ms``.
    rec["stage_ms"] = cuda_ms(lambda: stage_tables(*args[:4]), REPS)
    rec["plain_ms"] = cuda_ms(lambda: integrate_views_torch(plain, *args, params), 3)
    updates = grid.num_cells * len(views)
    rec["voxel_updates_per_s"] = updates / (rec["ms"] / 1e3)
    rec["plain_voxel_updates_per_s"] = updates / (rec["plain_ms"] / 1e3)
    rec.update(integrate_roofline(grid.num_cells, len(views), grid.volume_shape,
                                  depths.shape[1:], rec["ms"]))
    return rec, fused


def integrate_cases():
    """The integrate kernel's cases, ``(label, dims, origin, views)``: row
    1's shape, 1080p maps, and an odd grid."""
    # The odd grid's origin is offset like the repo's parity cases
    # (scripts/tpu_validate.py), so that no voxel center of this symmetric
    # rig sits on an exact half-pixel boundary, where float32 and float64
    # may round to different pixels.
    return [
        ("512^3 x 32 views 512x512", (DIMS,) * 3, (-1.6,) * 3, orbit_views(32, MAP, MAP)),
        ("256^3 x 8 views 1920x1080", (257,) * 3, (-1.6,) * 3,
         orbit_views(8, 1920, 1080, focal=900.0)),
        ("odd 100x66x44 x 12 views 320x240", (101, 67, 45), (-1.63, -1.61, -1.59),
         orbit_views(12, 320, 240, focal=200.0)),
    ]


def library_shape(source):
    """The launch shape the library builds ``csrc/<source>`` with: the
    ``#define CDMI_*`` defaults of the file."""
    from cudadepthmapintegration_torch.kernels._build import CSRC

    text = (CSRC / source).read_text()
    return {k.lower(): int(v) for k, v in re.findall(r"#define CDMI_(\w+) (\d+)", text)}


def build_shapes(source, shapes, out_dir):
    """Compile ``csrc/<source>`` once per entry of ``shapes`` (``{name:
    {macro: value}}``, passed as ``-D``), one nvcc each, all started
    together. Returns ``{name: (library, nvcc's output)}``, each library's
    C entries typed as ``kernels/_build.py`` types them."""
    import ctypes

    from cudadepthmapintegration_torch.kernels import _build

    src = str(_build.CSRC / source)
    procs = {}
    for name, defines in shapes.items():
        out = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
               "-shared", "-o", out, src]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise AssertionError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(out)
        for entry, argtypes in _build._ENTRIES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        built[name] = (lib, log)
    return built


def build_integrate_shapes(out_dir):
    """csrc/integrate.cu at every launch shape of ``SHAPE_KZS`` x
    ``SHAPE_BLOCKS`` (``-D CDMI_INTEGRATE_*``). Returns ``{name: (C entry,
    registers, spill bytes)}``."""
    shapes = {f"kz{kz}_{bx}x{by}": {"CDMI_INTEGRATE_KZ": kz, "CDMI_INTEGRATE_BLOCK_X": bx,
                                    "CDMI_INTEGRATE_BLOCK_Y": by}
              for kz in SHAPE_KZS for bx, by in SHAPE_BLOCKS}
    return {name: (lib.cdmi_integrate, int(re.findall(r"Used (\d+) registers", log)[-1]),
                   sum(int(n) for n in re.findall(r"(\d+) bytes spill", log)))
            for name, (lib, log) in build_shapes("integrate.cu", shapes, out_dir).items()}


def integrate_shapes_main() -> int:
    """``--integrate-shapes``: every launch shape of the integrate kernel,
    held to the plain version in bit patterns and timed on the integrate
    cases, twice over (CUDA-event medians, the table staging included)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from cudadepthmapintegration_torch.core import RayPotential
    from cudadepthmapintegration_torch.kernels._build import check
    from cudadepthmapintegration_torch.kernels.integrate_cuda import (
        integrate_views_torch,
        stage_tables,
    )
    from cudadepthmapintegration_torch.ops.integrate import projection_tables

    nvidia_smi()
    params = RayPotential(thick=0.025, rho=0.8, eta=0.03, delta=0.1)
    s = params.scalars()
    with tempfile.TemporaryDirectory(prefix="cdmi_shapes_") as tmp:
        t0 = time.perf_counter()
        built = build_integrate_shapes(tmp)
        emit(dict(phase="integrate_shapes_build", seconds=time.perf_counter() - t0,
                  library_shape=library_shape("integrate.cu"),
                  registers={k: v[1] for k, v in built.items()},
                  spill_bytes={k: v[2] for k, v in built.items()}))
        for label, dims, origin, views in integrate_cases():
            grid = cube_grid(dims, origin)
            t = projection_tables(grid, views, np.float32)
            depths = np.stack([v.depth for v in views]).astype(np.float32)
            args = [torch.from_numpy(a).cuda() for a in (t.tx, t.ty, t.tz, t.tc, depths)]
            plain = integrate_views_torch(torch.zeros(grid.volume_shape, device="cuda"),
                                          *args, params)
            (cz, cy, cx), (n, h, w) = grid.volume_shape, depths.shape
            ms = {name: [] for name in built}
            for _ in range(2):
                for name, (fn, _, _) in built.items():
                    def run(vol, fn=fn):
                        tables = stage_tables(*args[:4])
                        check(fn(vol.data_ptr(), *(a.data_ptr() for a in tables),
                                 args[4].data_ptr(), n, cz, cy, cx, h, w, s["thick"], s["rho"],
                                 s["delta"], s["rho_over_thick"], s["neg_eta_rho"], 0,
                                 torch.cuda.current_stream().cuda_stream), name)

                    vol = torch.zeros_like(plain)
                    run(vol)
                    torch.cuda.synchronize()
                    if not same_bits(vol, plain):
                        raise AssertionError(f"integrate shape {name} differs on {label}")
                    ms[name].append(cuda_ms(lambda: run(vol), REPS))
            emit(dict(phase="integrate_shapes", case=label, equal_bits=True, ms=ms,
                      fastest=sorted(ms, key=lambda k: min(ms[k]))[:6]))
            del args, plain, vol
            torch.cuda.empty_cache()
    return 0


def build_coloration_shapes(out_dir):
    """csrc/coloration.cu at every launch shape of ``COLOR_SHAPES``. Returns
    ``{name: (gather entry, statistics entry, ptxas lines)}``."""
    shapes = {f"v{g}_{t}_s{st}_b{sb}": {"CDMI_COLOR_VIEWS": g, "CDMI_COLOR_THREADS": t,
                                        "CDMI_STATS_THREADS": st, "CDMI_STATS_BATCH": sb}
              for g, t, st, sb in COLOR_SHAPES}
    return {name: (lib.cdmi_gather_colors, lib.cdmi_color_stats,
                   [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])
            for name, (lib, log) in build_shapes("coloration.cu", shapes, out_dir).items()}


def coloration_shapes_main() -> int:
    """``--coloration-shapes``: every launch shape of the coloration kernels
    on the coloration phase's first vertex chunk, each build's words and
    statistics held to the plain versions and timed (device time,
    :func:`device_ms`), twice over."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from cudadepthmapintegration_torch.kernels import coloration_cuda as cc
    from cudadepthmapintegration_torch.kernels._build import check
    from cudadepthmapintegration_torch.ops.coloration import POINT_CHUNK

    nvidia_smi()
    pts_d, proj, texels = coloration_inputs(orbit_views(N_VIEWS, MAP, MAP))
    chunk = pts_d[:POINT_CHUNK].contiguous()
    n, n_views = chunk.shape[0], proj.shape[0]
    h, w = texels.shape[1:]
    plain_words = cc.gather_colors_torch(chunk, proj, texels)
    plain_stats = cc.color_stats_torch(plain_words)
    with tempfile.TemporaryDirectory(prefix="cdmi_shapes_") as tmp:
        t0 = time.perf_counter()
        built = build_coloration_shapes(tmp)
        emit(dict(phase="coloration_shapes_build", seconds=time.perf_counter() - t0,
                  library_shape=library_shape("coloration.cu"),
                  ptxas={k: v[2] for k, v in built.items()}))
        stream = torch.cuda.current_stream().cuda_stream
        ms = {name: {"gather": [], "stats": []} for name in built}
        for _ in range(2):
            for name, (gather, stats, _) in built.items():
                words = torch.empty_like(plain_words)
                buf = torch.empty_like(plain_stats)
                mean, median, count = cc.split_stats(buf)

                def run_gather(gather=gather, words=words):
                    check(gather(chunk.data_ptr(), proj.data_ptr(), texels.data_ptr(), None,
                                 words.data_ptr(), n, n_views, h, w, 0, 0.0, 0, stream), name)

                def run_stats(stats=stats, words=words, mean=mean, median=median, count=count):
                    check(stats(words.data_ptr(), n, mean.data_ptr(), median.data_ptr(),
                                count.data_ptr(), n, n_views, 0, stream), name)

                run_gather()
                run_stats()
                torch.cuda.synchronize()
                if not (torch.equal(words, plain_words) and torch.equal(buf, plain_stats)):
                    raise AssertionError(f"coloration shape {name} differs from the plain versions")
                ms[name]["gather"].append(device_ms(run_gather, REPS))
                ms[name]["stats"].append(device_ms(run_stats, REPS))
        emit(dict(phase="coloration_shapes", vertices=n, views=n_views, equal=True, ms=ms,
                  fastest_gather=sorted(ms, key=lambda k: min(ms[k]["gather"]))[:4],
                  fastest_stats=sorted(ms, key=lambda k: min(ms[k]["stats"]))[:4]))
    return 0


def gather_time_main(root) -> int:
    """``--gather-time ROOT``: the coloration gather of the package under
    ``ROOT`` (this checkout or another one), built from that checkout's
    sources, timed on the coloration phase's first vertex chunk: device
    time (:func:`device_ms`) and a call's CUDA-event time. Takes either
    gather: the packed-word one (``stage_texels``) or the byte-a-channel one
    before it, which returned samples and a mask."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cudadepthmapintegration_torch.kernels import coloration_cuda as cc
    from cudadepthmapintegration_torch.ops.coloration import POINT_CHUNK

    views = orbit_views(N_VIEWS, MAP, MAP)
    proj = torch.from_numpy(np.stack(
        [(v.camera.k4 @ v.camera.rt)[:3, :] for v in views]).astype(np.float32)).cuda()
    colors = torch.from_numpy(np.stack([v.color for v in views])).cuda()
    chunk = torch.from_numpy(sphere_points(1 << 20)[:POINT_CHUNK]).cuda()
    if hasattr(cc, "stage_texels"):
        texels = cc.stage_texels(colors)
        words = cc.gather_colors(chunk, proj, texels)

        def run():
            cc.gather_colors(chunk, proj, texels, out=words)
    else:
        def run():
            cc.gather_colors(chunk, proj, colors)
    emit(dict(phase="gather_time", package=os.path.dirname(cc.__file__),
              packed=hasattr(cc, "stage_texels"), device_ms=device_ms(run, REPS),
              call_ms=cuda_ms(run, REPS)))
    return 0


def ab_main(kind, parent_root, *extra) -> int:
    """``--gather-ab PARENT_ROOT`` and ``--sparse-ab PARENT_ROOT [BLOCK]``:
    the coloration gather (``kind`` ``"gather"``) or the sparse fuse kernel
    (``"sparse"``; ``extra`` the block shape, see :func:`sparse_time_main`)
    of another checkout, unpacked under ``PARENT_ROOT``, against this one's,
    each in a process of its own (``--gather-time``, ``--sparse-time``), in
    the order parent, this, this, parent."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    nvidia_smi()
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("parent", parent_root), ("this", here), ("this", here),
                        ("parent", parent_root)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), f"--{kind}-time", root,
                               *extra], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"--{kind}-time {root} exited {proc.returncode}")
        runs.append(dict(label=label, **json.loads(proc.stdout.strip().splitlines()[-1])))
    emit(dict(phase=f"{kind}_ab", runs=runs))
    return 0


def sparse_time_main(root, block="8x8x8") -> int:
    """``--sparse-time ROOT [BLOCK]``: the sparse fuse kernel of the package
    under ``ROOT`` (this checkout or another one), built from that
    checkout's sources, on frame 3 of :func:`sparse_views` into blocks of
    ``BLOCK`` (``BZxBYxBX``; 8x8x8, the ``fr1`` case of :func:`sparse_cases`,
    by default), depth only and with colour: held to that package's plain
    versions in bit patterns, then timed by :func:`sparse_times`. Prints one
    JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cudadepthmapintegration_torch.kernels import sparse_cuda

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    nvidia_smi()
    params = sparse_params()
    views = sparse_views()
    grid = sparse_case_grid(params, views, tuple(int(b) for b in block.split("x")))
    rec = sparse_case(f"block_{block}", grid, grid.frame_batch(views[3]), params)
    emit(dict(phase="sparse_time", package=os.path.dirname(sparse_cuda.__file__), **rec))
    return 0


def ptxas_kernels(log):
    """``{kernel: (registers, spill bytes)}`` of each entry function of
    ``csrc/sparse_fuse.cu`` in ``nvcc -Xptxas -v`` output, named
    ``rows[colour]``, ``general[depth]``, ``general[colour,words]`` and so
    on (the general kernel's word instance, for shapes whose voxels do not
    come in whole vectors, is marked ``words``)."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(rows_kernel|fuse_kernel)ILb(\d)E(\w*)'",
                      line)
        if m:
            colour = "colour" if m.group(2) == "1" else "depth"
            if m.group(1) == "rows_kernel":
                name = f"rows[{colour}]"
            else:
                vec = re.match(r"Li\d+ELi\d+ELb(\d)E", m.group(3))
                name = f"general[{colour}{'' if vec and vec.group(1) == '1' else ',words'}]"
            table[name] = [0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            table[name][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in table.items()}


def sparse_sweep(entries, grid, batch, params, label):
    """Every C entry of ``entries`` (``{shape: entry}``) on ``batch`` into
    ``grid``'s pools, depth only and with colour: held to the plain
    versions in bit patterns, then timed by cold device time twice over,
    beside PyTorch's in-place add over a slab of as many bytes as the
    pools, read and written once (``torch_add``, what the traffic can
    reach). Prints one line a mode."""
    import torch

    from cudadepthmapintegration_torch.kernels import sparse_cuda as sc
    from cudadepthmapintegration_torch.kernels._build import check

    args = (batch.slots, batch.origins, batch.proj_rows, grid.axes, batch.depth)
    voxels = int(batch.slots.shape[0]) * int(np.prod(grid.block_shape))
    for colour in (False, True):
        names = ("pool", "color_pool", "weight_pool") if colour else ("pool",)
        plain = {k: getattr(grid, k).clone() for k in names}
        sc.sparse_fuse_torch(plain["pool"], *args, params)
        if colour:
            sc.sparse_accumulate_color_torch(plain["color_pool"], plain["weight_pool"], *args,
                                             batch.rgb, grid.color_band)
        ms = {name: [] for name in entries}
        for _ in range(2):
            for name, entry in entries.items():
                pools = {k: getattr(grid, k).clone() for k in names}
                extra = {}
                if colour:
                    extra = dict(color_pool=pools["color_pool"],
                                 weight_pool=pools["weight_pool"], rgb=batch.rgb,
                                 band=grid.color_band)
                c_args = sc.launch_args(pools["pool"], *args, params, **extra)

                def run(entry=entry, c_args=c_args, name=name):
                    check(entry(*c_args), name)

                run()
                torch.cuda.synchronize()
                if not all(same_bits(pools[k], plain[k]) for k in names):
                    raise AssertionError(f"sparse shape {name} differs from the plain version "
                                         f"({label})")
                ms[name].append(device_ms(run, REPS, SPARSE_KERNEL_NAME, cold=True))
                del pools
        slab = torch.zeros(voxels * (5 if colour else 1), device="cuda")
        add = [device_ms(lambda: slab.add_(0.0), REPS, "add", cold=True) for _ in range(2)]
        del slab, plain
        bound = sparse_bound(voxels, colour, int(batch.slots.shape[0]), batch.depth.shape, 1.0)
        emit(dict(phase="sparse_shapes", case=label, mode="colour" if colour else "depth",
                  block_shape=list(grid.block_shape), blocks=int(batch.slots.shape[0]),
                  equal_bits=True, cold_device_ms=ms, torch_add_ms=add,
                  bound_ms=bound["bound_ms"], fastest=sorted(ms, key=lambda k: min(ms[k]))[:5]))


def sparse_shapes_main(which="both") -> int:
    """``--sparse-shapes [rows|general]``: ``csrc/sparse_fuse.cu`` built at
    every launch shape of a kernel, each build held to the plain versions in
    bit patterns, depth only and with colour, and timed by cold device time
    twice over (:func:`sparse_sweep`). The row kernel at every shape of
    ``SPARSE_SHAPES`` (``-D CDMI_SPARSE_VX``, ``CDMI_SPARSE_BLOCKS`` and the
    same for the colour instance, ``CDMI_SPARSE_COLOR_*``) on the ``fr1``
    case; the general kernel at every shape of ``SPARSE_GEN_SHAPES``
    (``CDMI_SPARSE_GEN_VX``, ``_THREADS``, ``_COLOR_VX``, ``_COLOR_THREADS``)
    on the same frame into (4, 6, 5) blocks. The row sweep sets the general
    kernel at the library's shape beside the row kernel on the 8^3 blocks.
    A row shape that spills fails the sweep; a general shape that spills is
    reported and timed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    nvidia_smi()
    params = sparse_params()
    views = sparse_views()
    shapes = {}
    if which in ("both", "rows"):
        shapes.update({f"vx{vx}_b{nb}": {"CDMI_SPARSE_VX": vx, "CDMI_SPARSE_BLOCKS": nb,
                                         "CDMI_SPARSE_COLOR_VX": vx, "CDMI_SPARSE_COLOR_BLOCKS": nb}
                       for vx, nb in SPARSE_SHAPES})
    if which in ("both", "general"):
        shapes.update({f"gen_vx{vx}_t{t}": {"CDMI_SPARSE_GEN_VX": vx, "CDMI_SPARSE_GEN_THREADS": t,
                                            "CDMI_SPARSE_GEN_COLOR_VX": vx,
                                            "CDMI_SPARSE_GEN_COLOR_THREADS": t}
                       for vx, t in SPARSE_GEN_SHAPES})
    if not shapes:
        raise AssertionError(f"--sparse-shapes takes rows or general, not {which}")
    with tempfile.TemporaryDirectory(prefix="cdmi_shapes_") as tmp:
        t0 = time.perf_counter()
        built = build_shapes("sparse_fuse.cu", shapes, tmp)
        tables = {name: ptxas_kernels(log) for name, (_, log) in built.items()}
        # A shape's spills, by instance, in the kernel it sets (a row shape
        # builds the general kernel at the library's shape, and the other
        # way round).
        spill = {name: {k: s for k, (_, s) in t.items()
                        if s and k.startswith("general") == name.startswith("gen_")}
                 for name, t in tables.items()}
        emit(dict(phase="sparse_shapes_build", seconds=time.perf_counter() - t0,
                  library_shape=library_shape("sparse_fuse.cu"),
                  registers={name: {k: r for k, (r, _) in t.items()} for name, t in tables.items()},
                  spill_bytes=spill))
        rows = {n: lib.cdmi_sparse_fuse_rows for n, (lib, _) in built.items()
                if not n.startswith("gen_")}
        if any(spill[n] for n in rows):
            raise AssertionError(f"ptxas spilled in a sparse row shape ({spill})")
        if rows:
            # The general kernel at the library's shape on the same 8^3 blocks.
            rows["general"] = built[next(iter(rows))][0].cdmi_sparse_fuse
            grid = sparse_case_grid(params, views)
            sparse_sweep(rows, grid, grid.frame_batch(views[3]), params, "fr1")
            del grid
            torch.cuda.empty_cache()
        general = {n: lib.cdmi_sparse_fuse for n, (lib, _) in built.items()
                   if n.startswith("gen_")}
        if which != "rows":
            grid = sparse_case_grid(params, views, block_shape=(4, 6, 5))
            sparse_sweep(general, grid, grid.frame_batch(views[3]), params, "block_4x6x5")
    return 0


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
    plain version on the same inputs (bit patterns) and times both."""
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
    equal = all(same_bits(k, p) for k, p in zip(integ.slabs, plain))
    rec = dict(row=3, mode="windows", replaces=f"{KERNEL_FILE}:1093",
               path="ShardedTSDFIntegrator.stage_pallas_views(mode='windows') on "
                    "make_mesh(n_z=4, devices=['cuda:0'] * 4)",
               cells=list(grid.volume_shape), views=len(orbit32), map=[MAP, MAP],
               launches=launches, kernel_equals_plain=equal,
               max_abs_err=max(float((k - p).abs().max()) for k, p in zip(integ.slabs, plain)),
               slabs_equal_single_device=same_bits(sharded, single))
    del single, sharded
    if not (equal and rec["slabs_equal_single_device"]) or launches != 4:
        emit(dict(phase="integrate_mode", **rec, ok=False))
        raise AssertionError("row 3: the sharded windows path is off")
    rec["ms"] = cuda_ms(lambda: integ.run_staged_pallas(staged), REPS)
    rec["plain_ms"] = cuda_ms(lambda: [integrate_views_torch(p, *a, params)
                                       for p, a in zip(plain, staged)], 3)
    rec.update(integrate_roofline(grid.num_cells, len(orbit32), grid.volume_shape, (MAP, MAP),
                                  rec["ms"]))
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
                   path="TSDFIntegrator.integrate", path_equals_kernel=same_bits(path, fused))
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


def cli_plain_phase(tmp, cfg, volume):
    """The plain version on the card fuses the CLI's thresholded views in one
    call; the CLI's volume (two kernel launches) must have its bits."""
    import torch

    from cudadepthmapintegration_torch.io import DepthMapDataset
    from cudadepthmapintegration_torch.kernels.integrate_cuda import integrate_views_torch
    from cudadepthmapintegration_torch.ops.integrate import projection_tables

    t0 = time.perf_counter()
    views = [v.thresholded(cfg.threshold_best_cost)
             for v in DepthMapDataset.from_folder(tmp, "vtiList.txt", "kList.txt")]
    grid = cfg.make_grid()
    t = projection_tables(grid, views, np.float32)
    depths = np.stack([v.depth for v in views]).astype(np.float32)
    plain = torch.zeros(grid.volume_shape, device="cuda")
    integrate_views_torch(plain, *(torch.from_numpy(a).cuda()
                                   for a in (t.tx, t.ty, t.tz, t.tc, depths)),
                          cfg.ray_potential())
    plain = plain.cpu().numpy()
    rec = dict(views=len(views), cells=list(grid.volume_shape), equal_bits=same_bits(volume, plain),
               max_abs_err=float(np.abs(volume - plain).max()),
               seconds=time.perf_counter() - t0)
    emit(dict(phase="cli_plain", **rec, ok=rec["equal_bits"]))
    if not rec["equal_bits"]:
        raise AssertionError("the CLI's fused volume differs from the plain version")


def main_cli_args(tmp, mesh_path, grid_path, dims=None):
    """``cudareconstruction`` flags of the main path on the dataset in
    ``tmp`` (``dims`` grid points an axis, ``DIMS`` by default): the ray
    potential 2 and 8 voxels of the 512^3 grid thick."""
    spacing = 3.2 / (DIMS - 1)
    return [
        "--gridDims", str(dims or DIMS), "--gridOrigin", "-1.6", "-1.6", "-1.6",
        "--gridEnd", "1.6", "1.6", "1.6",
        "--rayThick", repr(2 * spacing), "--rayDelta", repr(8 * spacing),
        "--rayRho", "0.8", "--rayEta", "0.03",
        "--threshBestCost", "0.5", "--contour", "1.0",
        "--dataFolder", tmp, "--outputMeshFilename", mesh_path,
        "--outputGridFilename", grid_path, "--device", "cuda",
    ]


def filter_phase(tmp, cfg, grid, volume):
    """``ReconstructionFilter.update()`` on the card over the main path's
    dataset, with the CLI's ray potential, threshold and grid: it fuses the
    same batches of 32 views, so its volume must have the bits of the CLI's,
    from two launches of the integrate kernel."""
    from cudadepthmapintegration_torch.kernels import integrate_cuda
    from cudadepthmapintegration_torch.pipeline import ReconstructionFilter

    t0 = time.perf_counter()
    f = (ReconstructionFilter()
         .set_ray_potential_rho(cfg.ray_rho).set_ray_potential_thickness(cfg.ray_thick)
         .set_ray_potential_eta(cfg.ray_eta).set_ray_potential_delta(cfg.ray_delta)
         .set_threshold_best_cost(cfg.threshold_best_cost)
         .set_file_path_vti(os.path.join(tmp, "vtiList.txt"))
         .set_file_path_krtd(os.path.join(tmp, "kList.txt"))
         .set_grid_matrix(grid.matrix)
         .set_input_grid(grid.dims, grid.origin, grid.spacing)
         .set_device("cuda"))
    integrate_cuda.launches = 0
    f.update()
    launches = integrate_cuda.launches
    vol = f.get_output_volume()
    rec = dict(cells=list(vol.shape), execution_s=f.get_execution_time(), launches=launches,
               equal_bits=same_bits(vol, volume), seconds=time.perf_counter() - t0)
    ok = rec["equal_bits"] and launches == 2
    emit(dict(phase="filter", **rec, ok=ok))
    if not ok:
        raise AssertionError("ReconstructionFilter's volume differs from the CLI's, or it "
                             f"launched the integrate kernel {launches} times, not 2")


class _D2HBytes:
    """Bytes of CUDA tensors copied to the host with ``.cpu()`` while in the
    block: how the port's meshing routes move data off the card."""

    def __enter__(self):
        import torch

        self.nbytes = 0
        self.orig = orig = torch.Tensor.cpu

        def cpu(t, *a, **k):
            if t.is_cuda:
                self.nbytes += t.nbytes
            return orig(t, *a, **k)

        torch.Tensor.cpu = cpu
        return self

    def __exit__(self, *exc):
        import torch

        torch.Tensor.cpu = self.orig


def mesh_backends_phase(grid, volume, contour):
    """``extract_isosurface`` of the CLI's volume on the card by three
    routes, in turns, ``MESH_REPS`` times each: device extraction with the
    host weld (the main path's), with the device weld, and the native float64
    host walker. The device weld must give the host weld's mesh bit for bit;
    the native walker the same triangles, its points within 1e-6 of the
    extent. Returns the native mesh."""
    import torch

    from cudadepthmapintegration_torch.ops import extract_isosurface

    t0 = time.perf_counter()
    vol = torch.from_numpy(volume).cuda()
    routes = {"device_host_weld": {}, "device_device_weld": dict(weld_backend="device"),
              "native_host_weld": dict(backend="native")}
    times = {name: [] for name in routes}
    meshes, d2h = {}, {}
    for _ in range(MESH_REPS):
        for name, kw in routes.items():
            torch.cuda.synchronize()
            with _D2HBytes() as copied:
                t1 = time.perf_counter()
                meshes[name] = extract_isosurface(grid, vol, contour, **kw)
                times[name].append(time.perf_counter() - t1)
            d2h[name] = copied.nbytes
    del vol
    torch.cuda.empty_cache()
    rec = {name: dict(seconds=float(np.median(times[name])), seconds_all=times[name],
                      d2h_bytes=d2h[name], points=meshes[name].num_points,
                      triangles=meshes[name].num_triangles) for name in routes}
    host, dev, nat = (meshes[name] for name in routes)
    weld_equal = (np.array_equal(dev.points, host.points) and dev.points.dtype == host.points.dtype
                  and np.array_equal(dev.triangles, host.triangles)
                  and np.array_equal(dev.point_data["Normals"], host.point_data["Normals"]))
    same_points = nat.num_points == host.num_points
    nat_err = float(np.abs(nat.points - host.points).max()) if same_points else None
    rec.update(device_weld_equal=bool(weld_equal),
               native_triangles_equal=bool(np.array_equal(nat.triangles, host.triangles)),
               native_points_max_abs_err=nat_err, native_points_atol=1e-6 * EXTENT,
               seconds=time.perf_counter() - t0)
    ok = (rec["device_weld_equal"] and rec["native_triangles_equal"] and same_points
          and nat_err <= 1e-6 * EXTENT and host.num_triangles > 0)
    emit(dict(phase="mesh_backends", **rec, ok=ok))
    if not ok:
        raise AssertionError("a meshing route disagrees with the main path's")
    return nat


def vti_decode_phase(tmp):
    """The main path's 64 views read back as written (uncompressed), then a
    zlib-compressed copy of each read with the native codec and with Python
    ``zlib``, in turns (native, zlib, zlib, native): every array equal."""
    from cudadepthmapintegration_torch import native
    from cudadepthmapintegration_torch.io import read_vti, write_vti

    names = [f"f{i:03d}.vti" for i in range(N_VIEWS)]
    zdir = os.path.join(tmp, "zlib")
    os.makedirs(zdir)

    def read_all(folder):
        t0 = time.perf_counter()
        images = [read_vti(os.path.join(folder, n)) for n in names]
        return time.perf_counter() - t0, images

    raw_s, raw = read_all(tmp)
    t0 = time.perf_counter()
    for n, image in zip(names, raw):
        write_vti(os.path.join(zdir, n), image, compress=True)
    write_s = time.perf_counter() - t0
    available, decoded, secs = native.available, {}, {"native": [], "zlib": []}
    for codec in ("native", "zlib", "zlib", "native"):
        native.available = available if codec == "native" else (lambda: False)
        try:
            s, decoded[codec] = read_all(zdir)
        finally:
            native.available = available
        secs[codec].append(s)

    def arrays(image):
        return {**{f"point/{k}": v for k, v in image.point_data.items()},
                **{f"cell/{k}": v for k, v in image.cell_data.items()}}

    equal = all(
        arrays(a).keys() == arrays(b).keys() == arrays(c).keys()
        and all(np.array_equal(arrays(a)[k], arrays(b)[k]) and np.array_equal(arrays(a)[k], arrays(c)[k])
                for k in arrays(a))
        for a, b, c in zip(raw, decoded["native"], decoded["zlib"]))
    rec = dict(views=N_VIEWS, arrays=sorted(arrays(raw[0])), vti_decode_s=dict(
                   uncompressed=raw_s, native=secs["native"], zlib=secs["zlib"]),
               compressed_mb=sum(os.path.getsize(os.path.join(zdir, n)) for n in names) / 1e6,
               uncompressed_mb=sum(os.path.getsize(os.path.join(tmp, n)) for n in names) / 1e6,
               compress_write_s=write_s, equal=bool(equal))
    emit(dict(phase="vti_decode", **rec, ok=rec["equal"]))
    if not equal:
        raise AssertionError("the native codec and Python zlib decoded different arrays")


def trace_metrics_main(tmp) -> int:
    """``--trace-metrics DIR``: ``cudareconstruction --device cuda --trace
    --metrics`` at 256^3 cells on the main path's dataset in ``DIR``, in a
    fresh process (late in a long process ``torch.profiler`` recorded no
    device time, PERF.md section 7), between two runs with ``--metrics``
    only, for the trace's cost: the first pays the process's first CUDA
    work, the last is warm like the traced one. Prints one line: the
    integrate launches of the traced run, each run's seconds and pipeline
    phases, the seconds the trace takes to start and to stop and write its
    file, the metrics report, the kernels the trace names on the card, and
    the allocator's bytes after the traced run."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from cudadepthmapintegration_torch.cli import reconstruct
    from cudadepthmapintegration_torch.kernels import integrate_cuda
    from cudadepthmapintegration_torch.utils import device_memory_stats, profiling
    from cudadepthmapintegration_torch.utils.log import Log

    logs, trace_s = [], {}
    trace = profiling.trace

    class TimedTrace:
        """``profiling.trace``, its start and its stop and write timed."""

        def __init__(self, log_dir):
            self.ctx = trace(log_dir)

        def __enter__(self):
            t0 = time.perf_counter()
            out = self.ctx.__enter__()
            trace_s["start"] = time.perf_counter() - t0
            return out

        def __exit__(self, *exc):
            t0 = time.perf_counter()
            out = self.ctx.__exit__(*exc)
            trace_s["stop_and_write"] = time.perf_counter() - t0
            return out

    profiling.trace = TimedTrace

    class KeptLog(Log):
        """The CLI's log, kept for its phase timers."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            logs.append(self)

    reconstruct.Log = KeptLog
    out = os.path.join(tmp, "trace_metrics")
    trace_dir, metrics = os.path.join(out, "trace"), os.path.join(out, "metrics.json")
    os.makedirs(out)
    args = main_cli_args(tmp, os.path.join(out, "mesh.vtp"), os.path.join(out, "grid.vts"),
                         dims=TRACE_DIMS) + ["--mhaPath", "", "--metrics", metrics]
    runs = {}
    for name, extra in (("untraced_first", []), ("traced", ["--trace", trace_dir]),
                        ("untraced", [])):
        integrate_cuda.launches = 0
        t0 = time.perf_counter()
        rc = reconstruct.main(args + extra)
        runs[name] = dict(cli_s=time.perf_counter() - t0, launches=integrate_cuda.launches,
                          phases_s=logs[-1].timings)
        if rc != 0:
            raise AssertionError(f"reconstruct {' '.join(extra)} --metrics exited {rc}")
        if name == "traced":
            memory = device_memory_stats("cuda:0")
            with open(metrics) as f:
                report = json.load(f)
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    emit(dict(launches=runs["traced"]["launches"], runs=runs, trace_s=trace_s, report=report,
              trace_file=trace_file,
              trace_mb=os.path.getsize(os.path.join(trace_dir, trace_file)) / 1e6,
              trace_events=len(events), device_kernel_names=len(kernels),
              integrate_kernels=[k[:100] for k in kernels if "integrate_kernel" in k],
              integrate_kernel_events=sum(1 for e in events if e.get("cat") == "kernel"
                                          and "integrate_kernel" in e["name"]),
              memory=memory))
    return 0


def trace_metrics_phase(tmp):
    """``reconstruct --trace --metrics`` in a process of its own
    (``--trace-metrics``): the trace must name the integrate kernel among
    the card's events, and the report carry the JAX keys, 64 views, 256^3
    voxels, a positive rate and an HBM fraction under 1.05."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-metrics", tmp],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr[-4000:], sep="\n", file=sys.stderr)
        raise AssertionError(f"--trace-metrics exited {proc.returncode}")
    rec = json.loads(lines[-1])
    report = rec["report"]
    fraction = report.get("hbm_roofline_fraction")
    checks = dict(
        trace_names_integrate_kernel=rec["integrate_kernel_events"] > 0,
        report_keys=list(report) == METRICS_KEYS,
        views=report.get("views") == N_VIEWS,
        voxels=report.get("voxels") == (TRACE_DIMS - 1) ** 3,
        rate=(report.get("voxel_updates_per_sec") or 0) > 0,
        fraction=fraction is not None and 0 < fraction < 1.05,
        launches=rec["launches"] == 2,
    )
    emit(dict(phase="trace_metrics", **rec, checks=checks, seconds=time.perf_counter() - t0,
              ok=all(checks.values())))
    if not all(checks.values()):
        raise AssertionError(f"reconstruct --trace --metrics failed {[k for k, v in checks.items() if not v]}")


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
               equal_plain_cli=same_bits(run.volume, plain_volume),
               checkpoint_equal_plain_cli=same_bits(loaded.volume, plain_volume))
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
               resumed_equal_uninterrupted=same_bits(captured[-1].volume, run.volume),
               seconds=time.perf_counter() - t0)
    ok = (rec["units"] == [0, 1, 2, 3] and rec["equal_plain_cli"]
          and rec["checkpoint_equal_plain_cli"] and rec["launches"] == 4
          and rec["preempted_units"] == [0, 1] and rec["resumed_launches"] == 2
          and rec["resumed_equal_uninterrupted"])
    emit(dict(phase="checkpoint", **rec, ok=ok))
    if not ok:
        raise AssertionError("resumable fusion is off")
    captured.clear()


def sharded_phase(tmp, params, contour, native_mesh):
    """Multi-device fusion of the main path's dataset on four z-slabs of one
    card, against the single-device path; the sharded isosurface by the
    device route against the dense one, and by the native walker against
    ``native_mesh`` (the dense native mesh of phase ``mesh_backends``)."""
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
               pipeline_equal=same_bits(sharded.result(), volume))
    z_integ, rec["sharded_z_fuse_s"] = ReconstructionPipeline(
        cfg, mesh=mesh4, shard_axis="z").fuse(dataset)
    rec["pipeline_z_equal"] = same_bits(z_integ.result(), volume)
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
    rec["frustum_cull_equal"] = same_bits(culled.result(), volume)
    rec["interleave_equal"] = same_bits(inter.result(), volume)
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
    t1 = time.perf_counter()
    dist_native = sharded_extract_isosurface(sharded.slabs, grid, contour, mesh4, backend="native")
    rec["sharded_native_extract_s"] = time.perf_counter() - t1
    rec["native_mesh_equal"] = bool(
        np.array_equal(dist_native.points, native_mesh.points)
        and np.array_equal(dist_native.triangles, native_mesh.triangles)
        and np.array_equal(dist_native.point_data["Normals"], native_mesh.point_data["Normals"]))
    del dist_native
    coloration_cuda.launches = coloration_cuda.stats_launches = 0
    t1 = time.perf_counter()
    got = sharded_colorize_points(dist.points, views, mesh4)
    rec["sharded_colorize_s"] = time.perf_counter() - t1
    col_launches = coloration_cuda.launches
    stats_launches = coloration_cuda.stats_launches
    exp = colorize_points(dist.points, views, device="cuda")
    rec.update(coloration_launches=col_launches, coloration_stats_launches=stats_launches,
               coloration_equal=all(bool(np.array_equal(a, b)) for a, b in zip(got, exp)),
               seconds=time.perf_counter() - t0)
    ok = (rec["pipeline_equal"] and rec["pipeline_z_equal"] and rec["frustum_cull_equal"]
          and rec["interleave_equal"]
          and vp_err <= VIEW_PARALLEL_ATOL and rec["cell_to_point_equal"]
          and dist.num_triangles == dense.num_triangles > 0 and rec["mesh_points_equal"]
          and rec["mesh_triangles_equal"] and rec["mesh_normals_equal"]
          and rec["native_mesh_equal"] and rec["coloration_equal"] and launches == 8 and col_launches > 0
          and stats_launches > 0)
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


def sphere_points(n):
    """``n`` points on the unit sphere from seed 0, in raster (z, y, x) order
    like a mesh's vertices."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((n, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts[np.lexsort(pts.T)].astype(np.float32)


def coloration_inputs(views):
    """The coloration phase's inputs on the card: 2^20 sphere points, the
    views' projection rows and their colours staged as RGBX words."""
    import torch

    from cudadepthmapintegration_torch.kernels.coloration_cuda import stage_texels

    proj = torch.from_numpy(np.stack(
        [(v.camera.k4 @ v.camera.rt)[:3, :] for v in views]).astype(np.float32)).cuda()
    texels = stage_texels(torch.from_numpy(np.stack([v.color for v in views])).cuda())
    return torch.from_numpy(sphere_points(1 << 20)).cuda(), proj, texels


def coloration_phase(views):
    """Both coloration kernels against their plain versions on every vertex
    chunk of 2^20 sphere points x the views: the gather word for word, the
    statistics byte for byte (the plain statistics are PR 4's route's
    reductions: int64 sums, float64 mean, sort-based median). Returns the
    phase record and the inputs."""
    import torch

    from cudadepthmapintegration_torch.kernels import coloration_cuda as cc
    from cudadepthmapintegration_torch.ops.coloration import POINT_CHUNK

    t0 = time.perf_counter()
    pts_d, proj, texels = coloration_inputs(views)
    n_views = proj.shape[0]
    n_valid, max_err = 0, 0
    for s in range(0, pts_d.shape[0], POINT_CHUNK):
        chunk = pts_d[s : s + POINT_CHUNK]
        kw = cc.gather_colors(chunk, proj, texels)
        pw = cc.gather_colors_torch(chunk, proj, texels)
        ks, ps = cc.color_stats(kw), cc.color_stats_torch(kw)
        checks = dict(gather_equal=torch.equal(kw, pw), stats_equal=torch.equal(ks, ps))
        if not all(checks.values()):
            emit(dict(phase="coloration", chunk=s, **checks,
                      words_differ=int((kw != pw).sum()), ok=False))
            raise AssertionError(f"coloration kernels differ from their plain versions ({checks})")
        n_valid += int((kw != 0).sum())
        max_err = max(max_err, int((kw.long() - pw.long()).abs().max()),
                      int((ks.int() - ps.int()).abs().max()))
    col = dict(points=int(pts_d.shape[0]), views=n_views, chunk=POINT_CHUNK,
               valid_frac=n_valid / (pts_d.shape[0] * n_views), max_abs_err=max_err,
               seconds=time.perf_counter() - t0)
    return col, (pts_d[:POINT_CHUNK], proj, texels)


def coloration_masks_phase(views, inputs):
    """The gather's rejections on the card: 65,536 points spread over a cube
    of side 10 around the sphere (off-image, behind cameras at radius 4,
    inside the sphere), gathered with and without ``z_test`` and with and
    without the views' depth maps (the occlusion test, -1 where a map has no
    depth), each held word for word to the plain gather and its statistics
    to the plain statistics. Returns the largest error."""
    import torch

    from cudadepthmapintegration_torch.kernels import coloration_cuda as cc
    from cudadepthmapintegration_torch.ops.coloration import POINT_CHUNK

    t0 = time.perf_counter()
    _, proj, texels = inputs
    rng = np.random.default_rng(1)
    pts = (rng.random((POINT_CHUNK, 3)) - 0.5) * 10.0
    chunk = torch.from_numpy(pts[np.lexsort(pts.T)].astype(np.float32)).cuda()
    depths = torch.from_numpy(np.stack([v.depth for v in views]).astype(np.float32)).cuda()
    cases, max_err = {}, 0
    for z_test in (False, True):
        for tol in (None, OCCLUSION_TOL):
            kw = dict(z_test=z_test, depths=None if tol is None else depths,
                      occlusion_tol=tol or 0.0)
            k, p = cc.gather_colors(chunk, proj, texels, **kw), cc.gather_colors_torch(
                chunk, proj, texels, **kw)
            ks, ps = cc.color_stats(k), cc.color_stats_torch(k)
            name = f"z_test={z_test},occlusion_tol={tol}"
            cases[name] = dict(gather_equal=torch.equal(k, p), stats_equal=torch.equal(ks, ps),
                               valid_frac=float((k != 0).float().mean()))
            max_err = max(max_err, int((k.long() - p.long()).abs().max()),
                          int((ks.int() - ps.int()).abs().max()))
    frac = {k: c["valid_frac"] for k, c in cases.items()}
    base = frac["z_test=False,occlusion_tol=None"]
    ok = (all(c["gather_equal"] and c["stats_equal"] for c in cases.values())
          and 0 < base < 1 and frac["z_test=True,occlusion_tol=None"] < base
          and frac[f"z_test=False,occlusion_tol={OCCLUSION_TOL}"] < base)
    emit(dict(phase="coloration_masks", cases=cases, seconds=time.perf_counter() - t0, ok=ok))
    if not ok:
        raise AssertionError("the gather's rejections differ from the plain gather's, "
                             "or a test rejected nothing")
    return max_err


def coloration_times(col, inputs):
    """Times of the coloration kernels and their plain versions on the first
    vertex chunk, with the bounds: the gather (12 bytes a vertex, 48 a view
    and a texel's 3 bytes of colour a valid sample read, a word a sample
    written), the statistics (the words read, 10 bytes a vertex written),
    and the chunk statistic with no word buffer at all. ``kernel_bytes`` is
    what the gather moves with its 4-byte RGBX texels; it is not the bound.

    Every ``ms`` and ``plain_ms`` is a CUDA-event time of one call as the
    caller makes it, the host's launch included, like every other kernel's
    in this script; ``device_ms`` beside it is the card's own time
    (:func:`device_ms`). ``torch_reduce_ms`` is the plain statistics, PR 4's
    route's reductions, on the same words."""
    from cudadepthmapintegration_torch.kernels import coloration_cuda as cc

    chunk, proj, texels = inputs
    n, n_views = chunk.shape[0], proj.shape[0]
    words = cc.gather_colors(chunk, proj, texels)
    valid = int((words != 0).sum())
    samples = n * n_views

    def times(kernel, plain, flops=None, nbytes=None):
        rec = dict(ms=cuda_ms(kernel, REPS), plain_ms=cuda_ms(plain, REPS),
                   device_ms=device_ms(kernel, REPS), plain_device_ms=device_ms(plain, REPS))
        if flops is not None:
            rec.update(roofline(flops, nbytes, rec["ms"]))
            rec["device_share"] = rec["bound_ms"] / rec["device_ms"]
        return rec

    def route():
        return cc.color_stats(cc.gather_colors(chunk, proj, texels, out=words))

    def plain_route():
        return cc.color_stats_torch(cc.gather_colors_torch(chunk, proj, texels))

    gather = times(lambda: cc.gather_colors(chunk, proj, texels, out=words),
                   lambda: cc.gather_colors_torch(chunk, proj, texels),
                   COLORATION_FLOPS * samples, 12 * n + 48 * n_views + 3 * valid + 4 * samples)
    gather["kernel_bytes"] = 12 * n + 48 * n_views + 4 * valid + 4 * samples
    stats = times(lambda: cc.color_stats(words), lambda: cc.color_stats_torch(words),
                  STATS_OPS * samples, 4 * samples + 10 * n)
    whole = times(route, plain_route)
    col.update(
        gather=gather, stats=stats, gather_ms=gather["ms"], stats_ms=stats["ms"],
        torch_reduce_ms=stats["plain_ms"], torch_reduce_device_ms=stats["plain_device_ms"],
        ms=whole["ms"], device_ms=whole["device_ms"], plain_ms=whole["plain_ms"],
        samples_per_s=samples / (gather["device_ms"] / 1e3))
    col["no_buffer"] = roofline((COLORATION_FLOPS + STATS_OPS) * samples,
                                12 * n + 48 * n_views + 3 * valid + 10 * n, col["ms"])
    col["no_buffer"]["device_share"] = col["no_buffer"]["bound_ms"] / col["device_ms"]
    emit(dict(phase="coloration", **col, ok=True))
    return col


def stats_columns_phase():
    """The statistics kernel against its plain version on crafted sample
    columns (``testing.color_stat_columns``), every column kind, at each of
    ``STATS_CASES``; returns the largest error."""
    import torch

    from cudadepthmapintegration_torch.kernels import coloration_cuda as cc
    from cudadepthmapintegration_torch.testing import color_stat_columns

    t0 = time.perf_counter()
    cases, max_err = [], 0
    for n_views, n in STATS_CASES:
        words = torch.from_numpy(color_stat_columns(n_views, n, seed=n_views)).cuda()
        k, p = cc.color_stats(words), cc.color_stats_torch(words)
        torch.cuda.synchronize()
        count = cc.split_stats(p)[2]
        case = dict(views=n_views, vertices=n, equal=torch.equal(k, p),
                    max_count=int(count.max()), mb=words.numel() * 4 / 1e6)
        if not case["equal"]:
            emit(dict(phase="stats_columns", **case, ok=False))
            raise AssertionError(f"statistics kernel differs on crafted columns ({case})")
        max_err = max(max_err, int((k.int() - p.int()).abs().max()))
        cases.append(case)
        del words, k, p, count
        torch.cuda.empty_cache()
    emit(dict(phase="stats_columns", cases=cases, seconds=time.perf_counter() - t0, ok=True))
    return max_err


def cli_colors_phase(tmp, mesh, occlusion_tol=None, phase="cli_colors"):
    """The colorize CLI's three colour arrays against the plain versions of
    both coloration kernels, run on the card through ``colorize_points`` on
    the same mesh and views with the same ``occlusion_tol``."""
    from cudadepthmapintegration_torch.io import DepthMapDataset
    from cudadepthmapintegration_torch.ops.coloration import colorize_points

    t0 = time.perf_counter()
    views = list(DepthMapDataset.from_folder(tmp, "vtiList.txt", "kList.txt"))
    with _PlainColoration():
        exp = colorize_points(mesh.points, views, occlusion_tol=occlusion_tol, device="cuda")
    names = ("MeanColoration", "MedianColoration", "NbProjectedDepthMap")
    equal = {k: bool(np.array_equal(mesh.point_data[k].reshape(e.shape), e))
             for k, e in zip(names, exp)}
    emit(dict(phase=phase, points=mesh.num_points, views=len(views), equal=equal,
              occlusion_tol=occlusion_tol, counted_frac=float((exp[2] > 0).mean()),
              seconds=time.perf_counter() - t0, ok=all(equal.values())))
    if not all(equal.values()):
        raise AssertionError(f"the CLI's colours differ from the plain route ({equal})")
    return exp


def cli_occlusion_phase(tmp, col_args, plain):
    """``colorize --occlusionTol`` on the main path's mesh: both coloration
    kernels launched (counted from 0 for this run only), its colours equal
    to the plain route's with the same tolerance, and the occlusion test
    rejecting samples of the ``plain`` counts (``NbProjectedDepthMap``
    without it)."""
    from cudadepthmapintegration_torch.cli import colorize
    from cudadepthmapintegration_torch.io import read_vtp
    from cudadepthmapintegration_torch.kernels import coloration_cuda

    out = os.path.join(tmp, "col_occluded.vtp")
    coloration_cuda.launches = coloration_cuda.stats_launches = 0
    t0 = time.perf_counter()
    rc = colorize.main(col_args + ["--output", out, "--occlusionTol", repr(OCCLUSION_TOL)])
    seconds = time.perf_counter() - t0
    launches = {"coloration": coloration_cuda.launches,
                "coloration_stats": coloration_cuda.stats_launches}
    if rc != 0:
        raise AssertionError(f"colorize --occlusionTol exited {rc}")
    emit(dict(phase="cli_occlusion", colorize_s=seconds, launches=launches))
    if not all(launches.values()):
        raise AssertionError(f"colorize --occlusionTol skipped a coloration kernel ({launches})")
    mesh = read_vtp(out)
    occluded = cli_colors_phase(tmp, mesh, OCCLUSION_TOL, phase="cli_occlusion_colors")[2]
    if not (occluded <= plain).all() or not (occluded < plain).any():
        raise AssertionError("--occlusionTol rejected no sample, or added one")


class _PlainColoration:
    """Within the block, ``ops.coloration`` runs the plain versions of both
    coloration kernels, on whatever device its tensors are."""

    def __enter__(self):
        from cudadepthmapintegration_torch.kernels import coloration_cuda as cc
        from cudadepthmapintegration_torch.ops import coloration as ops

        self.saved = ops.gather_colors, ops.color_stats
        ops.gather_colors, ops.color_stats = cc.gather_colors_torch, cc.color_stats_torch
        return self

    def __exit__(self, *exc):
        from cudadepthmapintegration_torch.ops import coloration as ops

        ops.gather_colors, ops.color_stats = self.saved


def capstone_slab(res, k0, n):
    """Slices ``k0 .. k0+n`` of the capstone's volume against the plain
    version on the card over every map, in int32 bit patterns: the plain
    version runs on a volume of ``n`` slices with the ``tz`` table sliced, so
    every table value is the full grid's."""
    import torch

    from cudadepthmapintegration_torch.kernels.integrate_cuda import integrate_views_torch

    tx, ty, tz, tc = res.tables
    t0 = time.perf_counter()
    plain = integrate_views_torch(
        torch.zeros((n,) + tuple(res.volume.shape[1:]), device=res.volume.device),
        tx, ty, tz[:, :, k0:k0 + n], tc, res.depths, res.scene.params)
    torch.cuda.synchronize()
    kernel = res.volume[k0:k0 + n]
    return dict(k0=k0, slices=n, equal_bits=same_bits(kernel, plain),
                max_abs_err=float((kernel - plain).abs().max()),
                plain_s=time.perf_counter() - t0)


def capstone_oracle(res, windows, size):
    """The capstone's volume on ``windows`` (``surface_windows``) against
    the plain version on the card (bit for bit, the ``tx``/``ty``/``tz``
    tables sliced) and against the float64 oracle on the host, which also
    counts the samples whose pixel the float32 projection flips."""
    import torch

    from cudadepthmapintegration_torch.kernels.integrate_cuda import integrate_views_torch
    from cudadepthmapintegration_torch.scripts.capstone_1024 import sampled_oracle

    tx, ty, tz, tc = res.tables
    fused, plain_equal = [], True
    for k, j0, i0 in windows:
        win = res.volume[k:k + 1, j0:j0 + size, i0:i0 + size]
        plain = integrate_views_torch(
            torch.zeros_like(win), tx[:, :, i0:i0 + size], ty[:, :, j0:j0 + size],
            tz[:, :, k:k + 1], tc, res.depths, res.scene.params)
        plain_equal &= same_bits(win.contiguous(), plain)
        fused.append(win[0].cpu().numpy())
    t0 = time.perf_counter()
    depths = res.depths.cpu().numpy()  # the maps cross to the host once
    tables = [t.cpu().numpy() for t in res.tables]
    rec = sampled_oracle(res.scene, tables, depths, fused, windows)
    return dict(rec, window=[size, size], plain_equal_bits=plain_equal,
                oracle_s=time.perf_counter() - t0)


def capstone_chunk(res, start):
    """One 65,536-vertex chunk of the capstone's mesh against every view: the
    gather kernel in the main path's view batches of 64 against the plain
    gather (word for word), the statistics kernel against
    ``color_stats_torch`` (byte for byte), and both against the colour
    arrays the run produced; CUDA-event ms of each, kernel and plain, and
    the bounds of ``coloration_times``."""
    import torch

    from cudadepthmapintegration_torch.kernels.coloration_cuda import (
        color_stats,
        color_stats_torch,
        gather_colors,
        gather_colors_torch,
        split_stats,
        stage_texels,
    )
    from cudadepthmapintegration_torch.ops.coloration import POINT_CHUNK

    cams, dev = res.scene.cameras, res.colors.device
    n_views = len(cams)
    pts = torch.from_numpy(np.ascontiguousarray(
        res.mesh.points[start:start + POINT_CHUNK], np.float32)).to(dev)
    proj = torch.from_numpy(np.stack([(c.k4 @ c.rt)[:3, :] for c in cams])
                            .astype(np.float32)).to(dev)
    texels = stage_texels(res.colors)
    words = torch.empty((n_views, pts.shape[0]), dtype=torch.int32, device=dev)

    def gather():
        for vs in range(0, n_views, 64):
            gather_colors(pts, proj[vs:vs + 64], texels[vs:vs + 64], out=words, view_offset=vs)

    gather()
    plain = gather_colors_torch(pts, proj, texels)
    stats = color_stats(words)
    plain_stats = color_stats_torch(words)
    mean, median, count = (t.cpu().numpy() for t in split_stats(stats.cpu()))
    stop = start + pts.shape[0]
    r_mean, r_median, r_count = (a[start:stop] for a in res.colours)
    rec = dict(start=start, vertices=int(pts.shape[0]), views=n_views,
               gather_equal=bool(torch.equal(words, plain)),
               stats_equal=bool(torch.equal(stats, plain_stats)),
               run_equal=bool(np.array_equal(mean, r_mean) and np.array_equal(median, r_median)
                              and np.array_equal(count, r_count)),
               max_abs_err=float(max((words - plain).abs().max(),
                                     (stats.int() - plain_stats.int()).abs().max())))
    n, samples, valid = int(pts.shape[0]), words.numel(), int((words != 0).sum())
    rec["gather_ms"] = cuda_ms(gather, REPS)
    rec["gather_plain_ms"] = cuda_ms(lambda: gather_colors_torch(pts, proj, texels), 1)
    rec["gather_bound"] = roofline(COLORATION_FLOPS * samples,
                                   12 * n + 48 * n_views + 3 * valid + 4 * samples,
                                   rec["gather_ms"])
    rec["stats_ms"] = cuda_ms(lambda: color_stats(words), REPS)
    rec["stats_plain_ms"] = cuda_ms(lambda: color_stats_torch(words), 1)
    rec["stats_bound"] = roofline(STATS_OPS * samples, 4 * samples + 10 * n, rec["stats_ms"])
    return rec


def capstone_main() -> int:
    """``--capstone``: the capstone (``cudadepthmapintegration_torch.scripts.
    capstone_1024``) on the card, in a process of its own, with its checks:

    * the default mode at full size, 1000 maps of 512x512 into 1024^3 cells,
      meshed and coloured, the kernels' launch counts set to 0 just before
      and read just after; the fusion's bound by ``integrate_roofline``;
    * the fused volume: 16 slices through the sphere's middle and 8 windows
      of 128 x 128 cells across its surface bit-equal to the plain version on
      the card; the windows against the float64 oracle (the share of
      projected samples whose pixel float32 flips must stay within
      ``FLIP_BUDGET``; the share of voxels off by more than 1e-3 is
      reported); the same volume fused by one launch over all the maps;
    * the mesh's median radius, the share of vertices coloured, and one
      vertex chunk against the plain gather and statistics;
    * the ``ckpt`` drill (bit-equal after the resume) and the ``hd`` mode (32
      maps of 1920x1080 into the same grid, 16 slices bit-equal to the plain
      version).

    Prints the capstone's phase lines, then one line with the launches and
    the checks; exits 1 when a check fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from cudadepthmapintegration_torch.kernels import _build, coloration_cuda, integrate_cuda
    from cudadepthmapintegration_torch.ops.coloration import POINT_CHUNK
    from cudadepthmapintegration_torch.scripts import capstone_1024 as cap

    _build.load_library()
    t0 = time.perf_counter()
    integrate_cuda.launches = 0
    coloration_cuda.launches = coloration_cuda.stats_launches = 0
    res = cap.run()
    launches = {"integrate": integrate_cuda.launches, "coloration": coloration_cuda.launches,
                "coloration_stats": coloration_cuda.stats_launches}
    run_s = time.perf_counter() - t0
    grid, n_views = res.scene.grid, len(res.scene.cameras)
    fusion = res.phases["fusion"]
    fusion_bound = integrate_roofline(grid.num_cells, n_views, grid.volume_shape,
                                      tuple(res.depths.shape[1:]), fusion["event_seconds"] * 1e3)

    # One launch over every map, into a second volume: the same bits.
    one = torch.zeros_like(res.volume)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cap.fuse_maps(one, res.tables, res.depths, res.scene.params, batch=0)
    end.record()
    end.synchronize()
    one_launch = dict(ms=start.elapsed_time(end), equal_bits=same_bits(one, res.volume),
                      **integrate_roofline(grid.num_cells, n_views, grid.volume_shape,
                                           tuple(res.depths.shape[1:]), start.elapsed_time(end)))
    del one
    torch.cuda.empty_cache()

    centre_k = int(round(-grid.origin[2] / grid.spacing[2] - 0.5))
    slab = capstone_slab(res, centre_k - CAPSTONE_SLAB // 2, CAPSTONE_SLAB)
    oracle = capstone_oracle(res, cap.surface_windows(grid, CAPSTONE_WINDOWS, CAPSTONE_WINDOW),
                             CAPSTONE_WINDOW)
    radii = np.linalg.norm(res.mesh.points, axis=1)
    count = res.colours[2]
    n_chunks = -(-res.mesh.num_points // POINT_CHUNK)
    chunk = capstone_chunk(res, (n_chunks // 2) * POINT_CHUNK)
    del res
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    cap.checkpoint_drill()  # raises unless the resumed volume is bit-equal
    ckpt_s = time.perf_counter() - t1
    hd = cap.run(cap.HD_VIEWS, cap.DIMS, width=cap.HD_MAP[0], height=cap.HD_MAP[1], mesh=False,
                 mode="hd")
    hd_slab = capstone_slab(hd, centre_k - CAPSTONE_SLAB // 2, CAPSTONE_SLAB)
    hd_fusion = hd.phases["fusion"]
    hd_bound = integrate_roofline(grid.num_cells, cap.HD_VIEWS, grid.volume_shape,
                                  tuple(hd.depths.shape[1:]), hd_fusion["event_seconds"] * 1e3)
    del hd
    torch.cuda.empty_cache()

    checks = dict(
        launched_integrate=launches["integrate"] == -(-n_views // cap.BATCH),
        launched_gather=launches["coloration"] == n_chunks * -(-n_views // 64),
        launched_stats=launches["coloration_stats"] == n_chunks,
        one_launch_equal_bits=one_launch["equal_bits"],
        slab_equal_bits=slab["equal_bits"],
        windows_equal_bits=oracle["plain_equal_bits"],
        flip_frac_within_budget=oracle["flip_frac"] <= FLIP_BUDGET,
        median_radius=0.95 <= float(np.median(radii)) <= 1.05,
        coloured_share=float((count > 0).mean()) >= 0.9,
        chunk_gather_equal=chunk["gather_equal"],
        chunk_stats_equal=chunk["stats_equal"],
        chunk_equals_run=chunk["run_equal"],
        hd_slab_equal_bits=hd_slab["equal_bits"],
    )
    emit(dict(phase="capstone", launches=launches, run_s=run_s,
              fusion=dict(ms=fusion["event_seconds"] * 1e3, **fusion_bound),
              one_launch=one_launch, slab=slab, oracle=oracle, flip_budget=FLIP_BUDGET,
              median_radius=float(np.median(radii)),
              coloured_share=float((count > 0).mean()), chunk=chunk, ckpt_s=ckpt_s,
              hd_fusion=dict(ms=hd_fusion["event_seconds"] * 1e3, **hd_bound), hd_slab=hd_slab,
              checks=checks, seconds=time.perf_counter() - t0,
              ok=all(checks.values())))
    return 0 if all(checks.values()) else 1


def script_main(name, run, checks) -> int:
    """A port script's path on the card, in a process of its own: ``run()``
    with the launch counts set to 0 just before it and read just after, then
    ``checks(result, launches)`` (a dict of named booleans). Emits one line
    with the launches, the checks and the record; exits 1 when a check
    fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from cudadepthmapintegration_torch.kernels import (
        _build,
        coloration_cuda,
        integrate_cuda,
        sparse_cuda,
    )

    _build.load_library()
    t0 = time.perf_counter()
    integrate_cuda.launches = 0
    coloration_cuda.launches = coloration_cuda.stats_launches = 0
    sparse_cuda.launches = sparse_cuda.rows_launches = 0
    res = run()
    launches = {"integrate": integrate_cuda.launches, "coloration": coloration_cuda.launches,
                "coloration_stats": coloration_cuda.stats_launches,
                "sparse_fuse": sparse_cuda.rows_launches,
                "sparse_fuse[general]": sparse_cuda.launches - sparse_cuda.rows_launches}
    got = checks(res, launches)
    rec = res.record if hasattr(res, "record") else res
    emit(dict(phase=name, launches=launches, checks=got, record=rec,
              seconds=time.perf_counter() - t0, ok=all(got.values())))
    return 0 if all(got.values()) else 1


def pipeline_e2e_main() -> int:
    """``--pipeline-e2e``: BASELINE config 3 at full size (512^3 cells, 200
    views of 512x512; ``scripts/pipeline_e2e.py``), its phases printed as it
    runs. Checks: the JAX script's gates (median radius within 0.02 of 1,
    unit normals) and at least 90 % of the vertices coloured; the fused
    volume bit-equal to the plain version on the card over every map; one
    integrate launch an arrival of 32 maps, and the coloration kernels
    launched; the kernel alone on the staged maps beside its bound
    (``integrate_roofline``). The mesh's counts stand beside the TPU run's
    (``E2E_512.json``), not gated: that volume went through another
    staging."""
    from cudadepthmapintegration_torch.scripts import pipeline_e2e as pe

    def checks(res, launches):
        plain = pe.check_volume(res)  # after the counts were read: a comparison's launches
        grid, maps = res.grid, res.views[0].depth.shape
        plain["kernel_bound"] = integrate_roofline(grid.num_cells, len(res.views),
                                                   grid.volume_shape, maps,
                                                   plain["kernel_event_s"] * 1e3)
        res.record["tpu_record_mesh"] = E2E_TPU_MESH
        return dict(res.record["checks"],
                    launched_integrate=launches["integrate"] == -(-pe.N_VIEWS // pe.STREAM_BATCH),
                    launched_gather=launches["coloration"] > 0,
                    launched_stats=launches["coloration_stats"] > 0)

    return script_main("pipeline_e2e", pe.run, checks)


def fuzz_extended_main() -> int:
    """``--fuzz-extended``: ``scripts/fuzz_extended.py`` on ``FUZZ_SEEDS``
    and 100 seeds from 1000, every check on the card (each route of the
    integrate kernel, the coloration kernels and the occlusion gather held
    to their plain versions). Checks: no failing seed, the native float64
    checks ran, and every kernel of the fuzz launched."""
    from cudadepthmapintegration_torch.scripts import fuzz_extended as fz

    n, seed0 = FUZZ_EXTENDED
    seeds = [*FUZZ_SEEDS, *range(seed0, seed0 + n)]

    def checks(rec, launches):
        return dict(no_failing_seed=rec["failures"] == 0, seeds=rec["seed_list"] == seeds,
                    native_ran=rec["native"], launched_integrate=launches["integrate"] > 0,
                    launched_gather=launches["coloration"] > 0,
                    launched_stats=launches["coloration_stats"] > 0)

    return script_main("fuzz_extended", lambda: fz.run(seeds), checks)


def fp32_error_main() -> int:
    """``--fp32-error``: ``scripts/fp32_error_study.py`` at 8, 64, 256 and
    1000 views, the CUDA kernel at each. Checks: the JAX script's verdict
    (the float32 accumulation error at 1000 views under 1 % of rho), the
    kernel's volume bit-equal to the plain version on the card at every
    count, the share of flipped samples within ``FLIP_BUDGET`` at every
    count (the capstone's gate), one launch a count."""
    from cudadepthmapintegration_torch.scripts import fp32_error_study as fp

    def checks(rec, launches):
        return dict(verdict_pass=rec["verdict"] == "PASS",
                    counts=[r["views"] for r in rec["kernel_rows"]] == list(fp.COUNTS),
                    kernel_equals_plain=all(r["plain_equal_bits"] for r in rec["kernel_rows"]),
                    flip_frac_within_budget=all(r["flip_frac"] <= FLIP_BUDGET
                                                for r in rec["kernel_rows"]),
                    launched_integrate=launches["integrate"] == len(fp.COUNTS))

    return script_main("fp32_error", lambda: fp.run(fp.COUNTS, "cuda"), checks)


def pod_probe_main() -> int:
    """``--pod-probe``: ``scripts/pod_probe.py --local 4`` at full size (513
    points an axis, 64 views of 512x512) on four z-slabs of the card. Checks:
    P = 1, 2, 4 all ran and each P's volume equals P = 1's bit for bit,
    P = 1's equals the plain version on the same staged, culled inputs on
    the card bit for bit, the checkpoint round trip is exact, and the
    integrate kernel launched."""
    from cudadepthmapintegration_torch.scripts import pod_probe as pp

    def checks(rec, launches):
        rows = rec["phases"]["scale"]["rows"]
        return dict(rec["gates"], slab_counts=[r["p"] for r in rows] == [1, 2, 4],
                    launched_integrate=launches["integrate"] > 0)

    return script_main("pod_probe", lambda: pp.run(pp.PHASES, local=4, device="cuda"), checks)


def script_phase(flag, name, timeout=900):
    """``python3 chip_smoke.py FLAG`` in a process of its own: its lines are
    printed here, and a failed check fails the run. Returns the launches of
    its path by kernel (its last line's)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          capture_output=True, text=True, timeout=timeout)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"{flag} exited {proc.returncode}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    emit(dict(phase=f"{name}_done", seconds=time.perf_counter() - t0))
    return rec["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2

    from cudadepthmapintegration_torch import native
    from cudadepthmapintegration_torch.cli import colorize, reconstruct
    from cudadepthmapintegration_torch.core import RayPotential
    from cudadepthmapintegration_torch.io import read_mha, read_vtp, write_depth_map_vti, write_krtd
    from cudadepthmapintegration_torch.kernels import _build, coloration_cuda, integrate_cuda
    from cudadepthmapintegration_torch.ops.oracle import integrate_views_oracle
    from cudadepthmapintegration_torch.pipeline.reconstruction import ReconstructionPipeline
    from cudadepthmapintegration_torch.utils.log import Log

    # 1. Device.
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi))

    # 2. Build: the kernels, then the native host library (make -C native)
    # that the native meshing route and the codec load.
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native._load()
    native_s = time.perf_counter() - t0
    spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", _build.BUILD.log))
    emit(dict(phase="build", seconds=build_s, native_seconds=native_s,
              native_library=str(native.NATIVE_DIR / "build" / native.LIB_NAME),
              compiled=_build.BUILD.compiled, library=str(_build.BUILD.path),
              integrate_shape=library_shape("integrate.cu"),
              coloration_shape=library_shape("coloration.cu"),
              sparse_shape=library_shape("sparse_fuse.cu"),
              spill_bytes=spill,
              ptxas=[ln.strip() for ln in _build.BUILD.log.splitlines()
                     if "entry function" in ln or "registers" in ln or "spill" in ln]))
    if _build.BUILD.compiled and spill:
        raise AssertionError(f"ptxas spilled {spill} bytes")

    # 3. Integrate kernel vs plain version.
    t0 = time.perf_counter()
    bench = RayPotential(thick=0.025, rho=0.8, eta=0.03, delta=0.1)
    cases = integrate_cases()
    records = []
    for label, dims, origin, views in cases:
        grid = cube_grid(dims, origin)
        rec, vol = integrate_case(label, grid, views, bench,
                                  from_neg_zero=label.startswith("odd"))
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

    # 4. Coloration kernels vs plain versions: a 1M-point sphere sample in
    # raster order against 64 views, in the main path's vertex chunks; then
    # the statistics on crafted columns.
    views = orbit_views(N_VIEWS, MAP, MAP)
    col, inputs = coloration_phase(views)
    col["max_abs_err"] = max(col["max_abs_err"], coloration_masks_phase(views, inputs))
    col = coloration_times(col, inputs)
    del inputs
    stats_err = stats_columns_phase()
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
        cli_args = main_cli_args(tmp, paths["mesh.vtp"], paths["grid.vts"])
        # The CLIs run in process; keep each reconstruct run's result so
        # that the checkpoint phase can compare volumes.
        captured, configs = [], []
        pipeline_run = ReconstructionPipeline.run

        def capturing_run(self, *a, **k):
            captured.append(pipeline_run(self, *a, **k))
            configs.append(self.config)
            return captured[-1]

        ReconstructionPipeline.run = capturing_run
        integrate_cuda.launches = 0
        coloration_cuda.launches = coloration_cuda.stats_launches = 0
        t0 = time.perf_counter()
        rc = reconstruct.main(cli_args + ["--mhaPath", paths["vol.mha"], "--summary"])
        t_rec = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"reconstruct exited {rc}")
        col_args = ["--input", paths["mesh.vtp"], "--vti", os.path.join(tmp, "vtiList.txt"),
                    "--krtd", os.path.join(tmp, "kList.txt"), "--device", "cuda"]
        col_log = Log(verbose=False)
        t0 = time.perf_counter()
        rc = colorize.main(col_args + ["--output", paths["col.vtp"]], log=col_log)
        t_col = time.perf_counter() - t0
        launches = {"integrate": integrate_cuda.launches, "coloration": coloration_cuda.launches,
                    "coloration_stats": coloration_cuda.stats_launches}
        if rc != 0:
            raise AssertionError(f"colorize exited {rc}")
        with open(os.path.join(tmp, "summary.txt")) as f:
            summary = [ln for ln in f.read().splitlines() if ln.startswith("--- ")]
        # colorize_s less its phases is the reading of the views.
        emit(dict(phase="cli", reconstruct_s=t_rec, colorize_s=t_col,
                  colorize_phases_s=col_log.timings, launches=launches, summary=summary,
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
                (launches["coloration"] == 0, "the CLI never launched the gather kernel"),
                (launches["coloration_stats"] == 0,
                 "the CLI never launched the statistics kernel"),
            ) if bad
        ]
        if problems:
            raise AssertionError("; ".join(problems))
        cli_colors_phase(tmp, mesh)
        cli_occlusion_phase(tmp, col_args, count)

        # The CLI's volume against the plain version on the card, bit for bit.
        cli_result = captured.pop()
        plain_volume = cli_result.volume
        del mesh, vol, radii, count
        cli_plain_phase(tmp, configs[-1], plain_volume)

        # 5a. The filter API on the same dataset, against the CLI's volume;
        # the meshing routes on that volume; the views' decode by both
        # codecs; reconstruct --trace --metrics in a process of its own.
        filter_phase(tmp, configs[-1], cli_result.grid, plain_volume)
        native_mesh = mesh_backends_phase(cli_result.grid, plain_volume, 1.0)
        del cli_result
        vti_decode_phase(tmp)
        torch.cuda.empty_cache()
        trace_metrics_phase(tmp)

        # 5b. Resumable fusion on the same dataset, against the CLI run above.
        checkpoint_phase(tmp, cli_args, plain_volume, captured)
        ReconstructionPipeline.run = pipeline_run
        del plain_volume
        torch.cuda.empty_cache()

        # 5c. Multi-device fusion on four slabs of this card.
        sharded_phase(tmp, RayPotential(thick=2 * spacing, rho=0.8, eta=0.03,
                                        delta=8 * spacing), 1.0, native_mesh)
        del native_mesh
        torch.cuda.empty_cache()

    # 5d. Two processes on this card, joined by torch.distributed.
    multiprocess_phase()

    # 6. The sparse RGB-D path: its kernels vs their plain versions (2
    # voxels thick, an 8-voxel band: fuse_rgbd's defaults), then the
    # fuse_rgbd CLI, whose 8^3 blocks go through the row kernel only.
    sparse, launches["sparse_fuse[general]"] = sparse_kernel_phase(sparse_params())
    with tempfile.TemporaryDirectory(prefix="cdmi_smoke_rgbd_") as tmp:
        launches["sparse_fuse"] = fuse_rgbd_phase(tmp)

    # 7. The capstone: 1000 maps into 1024^3 cells, meshed and coloured, in
    # a process of its own (the card's memory of this one released first).
    torch.cuda.empty_cache()
    capstone = script_phase("--capstone", "capstone")

    # 8. The counterparts of the JAX side's last four top-level scripts, each
    # in a process of its own: BASELINE config 3 end to end, the extended
    # fuzz, the float32 error by view count, the z-slab scaling probe on four
    # slabs of this card.
    scripts = {name: script_phase(flag, name) for flag, name in SCRIPT_PHASES}

    def timing(rec):
        # No single PyTorch call computes any of these functions.
        return {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "roofline_share")} | {
            "library_ms": None}

    def on_paths(kernel):
        # Each port script's launches of this kernel on its own path.
        return {f"{phase}_launches": rec.get(kernel, 0) for phase, rec in scripts.items()}

    main_case = records[0]
    emit({"kernels": [
        dict(name="integrate", route="cuda",
             source="cudadepthmapintegration_torch/csrc/integrate.cu",
             replaces="cudadepthmapintegration_tpu/kernels/integrate_pallas.py:925",
             launches=launches["integrate"], capstone_launches=capstone["integrate"],
             max_abs_err=max(r["max_abs_err"] for r in records), **on_paths("integrate"),
             **timing(main_case)),
        *(dict(name=f"integrate[{r['mode']}]", route="cuda",
               source="cudadepthmapintegration_torch/csrc/integrate.cu",
               replaces=r["replaces"], launches=r["launches"], capstone_launches=0,
               max_abs_err=r["max_abs_err"], **on_paths(None), **timing(r)) for r in mode_rows),
        dict(name="coloration", route="cuda",
             source="cudadepthmapintegration_torch/csrc/coloration.cu",
             replaces="cudadepthmapintegration_tpu/kernels/coloration_pallas.py:85",
             launches=launches["coloration"], capstone_launches=capstone["coloration"],
             max_abs_err=col["max_abs_err"], **on_paths("coloration"),
             **timing(col["gather"])),
        dict(name="coloration_stats", route="cuda",
             source="cudadepthmapintegration_torch/csrc/coloration.cu",
             replaces="cudadepthmapintegration_tpu/ops/coloration.py:115,123",
             launches=launches["coloration_stats"],
             capstone_launches=capstone["coloration_stats"],
             max_abs_err=max(col["max_abs_err"], stats_err), **on_paths("coloration_stats"),
             **timing(col["stats"])),
        *(dict(name=name, route="cuda",
               source="cudadepthmapintegration_torch/csrc/sparse_fuse.cu",
               replaces="cudadepthmapintegration_tpu/kernels/gather_points.py:35",
               launches=launches[name], capstone_launches=0,
               max_abs_err=max(max(sparse[c][m]["max_abs_err"].values())
                               for c in cases for m in ("depth", "colour")),
               **on_paths(name), **timing(sparse[cases[0]]["colour"]),
               device_ms=sparse[cases[0]]["colour"]["device_ms"],
               cold_device_ms=sparse[cases[0]]["colour"]["cold_device_ms"],
               cold_device_share=sparse[cases[0]]["colour"]["cold_device_share"])
          for name, cases in (("sparse_fuse", ("fr1", "neg_zero", "straddle")),
                              ("sparse_fuse[general]", GENERAL_CASES))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:] == ["--integrate-shapes"]:
        sys.exit(integrate_shapes_main())
    if sys.argv[1:] == ["--coloration-shapes"]:
        sys.exit(coloration_shapes_main())
    if sys.argv[1:2] == ["--gather-time"] and len(sys.argv) == 3:
        sys.exit(gather_time_main(sys.argv[2]))
    if sys.argv[1:2] == ["--gather-ab"] and len(sys.argv) == 3:
        sys.exit(ab_main("gather", sys.argv[2]))
    if sys.argv[1:] == ["--sparse-cases"]:
        sys.exit(sparse_cases_main())
    if sys.argv[1:] == ["--capstone"]:
        sys.exit(capstone_main())
    if sys.argv[1:] == ["--pipeline-e2e"]:
        sys.exit(pipeline_e2e_main())
    if sys.argv[1:] == ["--fuzz-extended"]:
        sys.exit(fuzz_extended_main())
    if sys.argv[1:] == ["--fp32-error"]:
        sys.exit(fp32_error_main())
    if sys.argv[1:] == ["--pod-probe"]:
        sys.exit(pod_probe_main())
    if sys.argv[1:2] == ["--trace-metrics"] and len(sys.argv) == 3:
        sys.exit(trace_metrics_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sparse-shapes"] and len(sys.argv) in (2, 3):
        sys.exit(sparse_shapes_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--sparse-time"] and len(sys.argv) in (3, 4):
        sys.exit(sparse_time_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--sparse-ab"] and len(sys.argv) in (3, 4):
        sys.exit(ab_main("sparse", *sys.argv[2:]))
    sys.exit(main())
