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


def integrate_case(label, dims, origin, views, params):
    """Kernel vs plain version on one grid spanning 3.2 along each axis;
    returns the case record, the grid and the fused volume."""
    import torch

    from cudadepthmapintegration_torch.core import VoxelGrid
    from cudadepthmapintegration_torch.kernels.integrate_cuda import (
        integrate_views,
        integrate_views_torch,
    )
    from cudadepthmapintegration_torch.ops.integrate import projection_tables

    grid = VoxelGrid(dims=dims, origin=origin,
                     spacing=tuple(3.2 / (d - 1) for d in dims))
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
    return rec, grid, fused


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
        rec, grid, vol = integrate_case(label, dims, origin, views, bench)
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
    del pts_d, proj, colors, vol
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
        integrate_cuda.launches = 0
        coloration_cuda.launches = 0
        t0 = time.perf_counter()
        rc = reconstruct.main([
            "--gridDims", str(DIMS), "--gridOrigin", "-1.6", "-1.6", "-1.6",
            "--gridEnd", "1.6", "1.6", "1.6",
            "--rayThick", repr(2 * spacing), "--rayDelta", repr(8 * spacing),
            "--rayRho", "0.8", "--rayEta", "0.03",
            "--threshBestCost", "0.5", "--contour", "1.0",
            "--dataFolder", tmp, "--outputMeshFilename", paths["mesh.vtp"],
            "--outputGridFilename", paths["grid.vts"], "--mhaPath", paths["vol.mha"],
            "--device", "cuda", "--summary",
        ])
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
    sys.exit(main())
