"""The extended parity fuzz: hundreds of random scenes through every route of
the port.

Counterpart of the JAX package's ``scripts/fuzz_extended.py``, with its
scene generator (:func:`random_scene`, the JAX package's
``tests/test_fuzz_parity.py::random_scene`` draw for draw), its checks and
its thresholds, on PyTorch and the port's kernels:

* :func:`check`: the plain version at float64 (run on the script's device)
  against the float64 oracle to 1e-9, and ``native.integrate_f64`` against
  it to 1e-12 when the native library builds. The JAX script holds fourteen
  Pallas modes bit-identical to ``rowsel``; here they are all one kernel, so
  its counterpart holds every float32 route bit-equal, in int32 patterns, to
  the plain float32 version: the integrate kernel in one launch, the kernel
  in arrivals of 3 maps (``TSDFIntegrator``, the counterpart of
  ``group_fill``), ``ShardedTSDFIntegrator`` on 2 and 4 z-slabs of the
  device, and ``stage_pallas_views``/``run_staged_pallas`` on 4 slabs with
  frustum culling. A random grid's z cells need not divide over the slabs:
  the sharded routes fuse a grid with the z axis padded to a multiple of the
  slab count and are compared on the scene's cells, whose tables the padding
  leaves as they are. Each route, and the plain version, also stays under
  the JAX script's oracle share: fewer than 5e-3 of the voxels off by more
  than 1e-3;
* :func:`check_coloration`: random colours and points through
  ``colorize_points`` (the gather and statistics kernels on a card) against
  the plain versions of both kernels on the same device: equal arrays;
* :func:`check_marching_cubes`: a smooth random float64 field contoured by
  the device route (in float64 on the device) against
  ``backend="native"``: equal counts, points to 1e-12, triangles and normals
  bit for bit, normals of unit length;
* :func:`check_occlusion`: the occlusion test of the float64 plain route on
  the CPU against a NumPy restatement of its predicate, then the float32
  gather with ``occlusion_tol`` on the script's device against its plain
  version: equal arrays.

Run from the root of a checkout::

    python -m cudadepthmapintegration_torch.scripts.fuzz_extended [n_seeds=100] [seed0=1000] \
        [--device cuda|cpu]

Prints each failing seed with the checks it failed, a progress line every 10
seeds, ``done: F failing seeds of N``, and last the record as one JSON
object (with the card's name and power limit); exits 1 when a seed failed.
``--device cuda`` (the default) raises when there is no card; ``--device
cpu`` runs the plain versions, whose routes then agree by construction.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import native
from ..core.camera import Camera, round_half_away
from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..core.view import DepthMapView
from ..kernels.coloration_cuda import (
    color_stats_torch,
    gather_colors_torch,
    split_stats,
    stage_texels,
)
from ..kernels.integrate_cuda import integrate_views, integrate_views_torch
from ..ops.coloration import colorize_points
from ..ops.integrate import TSDFIntegrator
from ..ops.marching_cubes import marching_cubes
from ..ops.oracle import integrate_views_oracle
from ..parallel import ShardedTSDFIntegrator, make_mesh
from ._common import card_description, same_bits, script_device, staged_inputs

__all__ = [
    "check",
    "check_coloration",
    "check_marching_cubes",
    "check_occlusion",
    "main",
    "random_scene",
    "run",
]

# The JAX script's oracle share: fewer than this share of the voxels may be
# off the float64 oracle by more than ORACLE_TOL.
ORACLE_SHARE = 5e-3
ORACLE_TOL = 1e-3
STREAM_BATCH = 3  # maps an integrate call of the streamed route
SLABS = (2, 4)  # z-slab counts of the sharded route


def random_scene(seed):
    """``random_scene`` of the JAX package's tests/test_fuzz_parity.py with the
    port's classes, draw for draw from ``default_rng(seed)``: a random grid of
    6-13 points an axis, 2-4 cameras of random rotation and placement, maps of
    130-199 x 16-39 random float64 depths with holes (-1), random ray
    parameters."""
    rng = np.random.default_rng(seed)
    grid = VoxelGrid(dims=tuple(rng.integers(6, 14, 3)), origin=tuple(rng.uniform(-2, 0, 3)),
                     spacing=tuple(rng.uniform(0.1, 0.4, 3)))
    views = []
    h, w = int(rng.integers(16, 40)), int(rng.integers(130, 200))
    for _ in range(int(rng.integers(2, 5))):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        rt = np.eye(4)
        rt[:3, :3] = q
        rt[:3, 3] = rng.uniform(-1, 1, 3) + [0, 0, rng.uniform(2, 5)]
        k = np.array([[rng.uniform(30, 120), 0, w / 2 + rng.uniform(-5, 5)],
                      [0, rng.uniform(30, 120), h / 2 + rng.uniform(-5, 5)],
                      [0, 0, 1]])
        depth = rng.uniform(0.5, 6.0, (h, w))
        depth[rng.uniform(size=(h, w)) < 0.1] = -1.0
        views.append(DepthMapView(depth=depth, camera=Camera(k=k, rt=rt)))
    thick, rho, eta = (float(rng.uniform(0.02, 0.3)), float(rng.uniform(0.2, 1.5)),
                       float(rng.uniform(0.0, 1.0)))
    params = RayPotential(thick=thick, rho=rho, eta=eta,
                          delta=thick * float(rng.uniform(1.0, 4.0)))
    return grid, views, params


def _padded(grid: VoxelGrid, n: int) -> VoxelGrid:
    """``grid`` with its z cells padded to a multiple of ``n``: the first
    cells' centres, and so their tables, are the grid's own."""
    nx, ny, nz = grid.dims
    return VoxelGrid(dims=(nx, ny, nz + (-(nz - 1) % n)), origin=grid.origin,
                     spacing=grid.spacing, matrix=grid.matrix)


def _sharded(grid, views, params, n, device, staged):
    """The scene fused on ``n`` z-slabs of ``device``: by ``integrate``, or
    (``staged``) by ``stage_pallas_views(frustum_cull=True)`` and
    ``run_staged_pallas``; the scene's cells, on the device."""
    intg = ShardedTSDFIntegrator(_padded(grid, n), params,
                                 make_mesh(n_z=n, devices=[device] * n)).reset()
    if staged:
        intg.run_staged_pallas(intg.stage_pallas_views(views, frustum_cull=True))
    else:
        intg.integrate(views)
    return torch.cat(intg.slabs)[:grid.volume_shape[0]]


def _off_share(vol: torch.Tensor, exp32: np.ndarray) -> float:
    return float((np.abs(vol.cpu().numpy() - exp32) > ORACLE_TOL).mean())


def check(seed, device) -> list[str]:
    """Integration on the scene of ``seed``: the names of the checks failed."""
    bad = []
    grid, views, params = random_scene(seed)
    exp = integrate_views_oracle(grid, views, params)

    t64 = staged_inputs(grid, views, np.float64, device)
    got64 = integrate_views_torch(torch.zeros(grid.volume_shape, dtype=torch.float64,
                                              device=device), *t64, params)
    if not np.allclose(got64.cpu().numpy(), exp, atol=1e-9):
        bad.append("plain_fp64")

    if native.available():
        if not np.allclose(native.integrate_f64(grid, views, params), exp, atol=1e-12):
            bad.append("native")

    exp32 = exp.astype(np.float32)
    t32 = staged_inputs(grid, views, np.float32, device)
    zeros = torch.zeros(grid.volume_shape, dtype=torch.float32, device=device)
    plain = integrate_views_torch(zeros.clone(), *t32, params)
    if _off_share(plain, exp32) >= ORACLE_SHARE:
        bad.append("plain_fp32_vs_oracle")
    routes = {"kernel": integrate_views(zeros.clone(), *t32, params)}
    streamed = TSDFIntegrator(grid, params, device=device).reset()
    for s in range(0, len(views), STREAM_BATCH):
        streamed.integrate(views[s:s + STREAM_BATCH])
    routes[f"streamed{STREAM_BATCH}"] = streamed.volume
    for n in SLABS:
        routes[f"sharded_z{n}"] = _sharded(grid, views, params, n, device, staged=False)
    routes[f"staged_z{SLABS[-1]}"] = _sharded(grid, views, params, SLABS[-1], device,
                                              staged=True)
    for name, vol in routes.items():
        if not same_bits(vol, plain):
            bad.append(f"{name}_not_bitident")
        if _off_share(vol, exp32) >= ORACLE_SHARE:
            bad.append(f"{name}_vs_oracle")
    return bad


def _coloured_scene(seed, salt):
    """The scene of ``seed`` with random colours, and random points, drawn as
    the JAX script draws them from ``default_rng(seed ^ salt)``."""
    _grid, views, _params = random_scene(seed)
    rng = np.random.default_rng(seed ^ salt)
    for v in views:
        v.color = rng.integers(0, 256, v.depth.shape + (3,), dtype=np.uint8)
    return views, rng


def plain_colours(points, views, device, occlusion_tol=None):
    """(mean, median, count) of ``points`` against ``views`` by the plain
    versions of the gather and the statistics kernels, on ``device``, in
    float32, all views in one gather."""
    proj = np.stack([(v.camera.k4 @ v.camera.rt)[:3, :] for v in views]).astype(np.float32)
    texels = stage_texels(torch.from_numpy(np.stack([v.color for v in views])).to(device))
    depths = None
    if occlusion_tol is not None:
        depths = torch.from_numpy(np.stack([np.asarray(v.depth, np.float32)
                                            for v in views])).to(device)
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    words = gather_colors_torch(pts, torch.from_numpy(proj).to(device), texels, depths=depths,
                                occlusion_tol=occlusion_tol or 0.0)
    return tuple(t.cpu().numpy() for t in split_stats(color_stats_torch(words).cpu()))


def check_coloration(seed, device) -> list[str]:
    """Random points against the scene's views in random colours: the
    coloration route on ``device`` against the plain versions."""
    views, rng = _coloured_scene(seed, 0xC0105)
    pts = (rng.random((int(rng.integers(50, 700)), 3)) - 0.5) * 6.0
    got = colorize_points(pts, views, device=device)
    exp = plain_colours(pts, views, device)
    return [f"coloration_{name}" for name, x, y in zip(("mean", "median", "count"), got, exp)
            if not np.array_equal(x, y)]


def mc_field(seed):
    """The JAX script's smooth random field: (z, y, x) float64 values on
    ``n`` points an axis over [-1.5, 1.5] (a sphere's bias plus 1-3 random
    Gaussian bumps), the axis, and a random isovalue."""
    rng = np.random.default_rng(seed ^ 0x3C3C)
    n = int(rng.integers(6, 18))
    xs = np.linspace(-1.5, 1.5, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    vol = 1.0 - np.sqrt(gx * gx + gy * gy + gz * gz)
    for _ in range(int(rng.integers(1, 4))):
        c = rng.uniform(-1, 1, 3)
        s = rng.uniform(0.3, 1.0)
        vol += rng.uniform(-0.8, 0.8) * np.exp(
            -(((gx - c[0]) ** 2 + (gy - c[1]) ** 2 + (gz - c[2]) ** 2) / s**2))
    return vol.transpose(2, 1, 0), xs, float(rng.uniform(-0.3, 0.3))


def check_marching_cubes(seed, device) -> list[str]:
    """The random field's contour by the device route, in float64 on
    ``device``, against the native float64 walker: they share the weld-key
    contract, so the meshes must match exactly (points to 1e-12, triangles
    and normals bit for bit)."""
    if not native.available():
        return []
    vol, xs, iso = mc_field(seed)
    a = marching_cubes(torch.from_numpy(vol).to(device), iso, xs, xs, xs, backend="device",
                       compute_normals=True)
    b = marching_cubes(vol, iso, xs, xs, xs, backend="native", compute_normals=True)
    bad = []
    if a.num_points != b.num_points or a.num_triangles != b.num_triangles:
        bad.append("mc_counts")
    elif a.num_points and not (np.allclose(a.points, b.points, atol=1e-12)
                               and np.array_equal(a.triangles, b.triangles)):
        bad.append("mc_values")
    elif a.num_points:
        na, nb = a.point_data["Normals"], b.point_data["Normals"]
        if not np.array_equal(na, nb):
            bad.append("mc_normals")
        nrm = np.linalg.norm(na, axis=1)
        if not np.allclose(nrm[nrm > 0], 1.0, atol=1e-5):
            bad.append("mc_normal_length")
    return bad


def occlusion_counts_np(points, views, tol) -> np.ndarray:
    """The occlusion test restated in NumPy, a point and a view at a time: in
    bounds, depth not -1, z > 0 and z <= depth + tol (float64 projection,
    the depth read in float32)."""
    h, w = views[0].depth.shape
    exp = np.zeros(len(points), np.int32)
    for i, p in enumerate(points):
        for v in views:
            cam = v.camera.rt[:3, :3] @ p + v.camera.rt[:3, 3]
            hom = v.camera.k @ cam
            u = round_half_away(hom[0] / hom[2])
            vv = round_half_away(hom[1] / hom[2])
            if u < 0 or vv < 0 or u >= w or vv >= h:
                continue
            d = np.float32(v.depth[int(vv), int(u)])
            if d != -1.0 and hom[2] > 0 and hom[2] <= d + tol:
                exp[i] += 1
    return exp


def check_occlusion(seed, device) -> list[str]:
    """Occlusion-mode coloration: the float64 plain route on the CPU against
    :func:`occlusion_counts_np`, and the float32 route on ``device`` against
    the plain versions there."""
    views, rng = _coloured_scene(seed, 0x0CC1)
    pts = (rng.random((int(rng.integers(50, 400)), 3)) - 0.5) * 6.0
    tol = float(rng.uniform(0.0, 0.5))
    bad = []
    _, _, counts = colorize_points(pts, views, dtype=torch.float64, occlusion_tol=tol,
                                   device="cpu")
    if not np.array_equal(counts, occlusion_counts_np(pts, views, tol)):
        bad.append("occlusion_counts")
    got = colorize_points(pts, views, occlusion_tol=tol, device=device)
    exp = plain_colours(pts, views, device, occlusion_tol=tol)
    if not all(np.array_equal(x, y) for x, y in zip(got, exp)):
        bad.append("occlusion_route")
    return bad


CHECKS = (check, check_coloration, check_marching_cubes, check_occlusion)


def run(seeds=range(1000, 1100), device="cuda") -> dict:
    """Every check on each seed of ``seeds`` (the JAX script's ``n_seeds``
    from ``seed0``: ``range(seed0, seed0 + n_seeds)``); prints the failing
    seeds and the progress as the JAX script does, and returns the record:
    the seeds, the failing ones with their checks' names, the seconds, the
    device, the card and whether the native checks ran."""
    device = script_device(device, "fuzz_extended")
    card = card_description(device)
    seeds = list(seeds)
    t0 = time.perf_counter()
    failing = {}
    for i, seed in enumerate(seeds):
        bad = [name for fn in CHECKS for name in fn(seed, device)]
        if bad:
            failing[seed] = bad
            print(f"seed {seed}: FAIL {bad}", flush=True)
        if (i + 1) % 10 == 0:
            print(f"[{i + 1}/{len(seeds)}] failures so far: {len(failing)}", flush=True)
    print(f"done: {len(failing)} failing seeds of {len(seeds)}", flush=True)
    return dict(seeds=len(seeds), seed_list=seeds, failures=len(failing),
                failing={str(k): v for k, v in failing.items()},
                native=native.available(), seconds=time.perf_counter() - t0,
                device=str(device), card=card)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cudadepthmapintegration_torch.scripts.fuzz_extended",
        description="Random scenes through every route of the port.")
    p.add_argument("n_seeds", nargs="?", type=int, default=100)
    p.add_argument("seed0", nargs="?", type=int, default=1000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the hand-written kernels; default) or cpu (their plain versions)")
    a = p.parse_args(argv)
    rec = run(range(a.seed0, a.seed0 + a.n_seeds), a.device)
    print(json.dumps(rec), flush=True)
    return 1 if rec["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
