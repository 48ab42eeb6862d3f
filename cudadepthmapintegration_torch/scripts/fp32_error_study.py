"""How the float32 error of fusion grows with the number of views.

Counterpart of the JAX package's ``scripts/fp32_error_study.py``, with its
build (65^3 points at a spacing of 0.05, maps of 256x192, focal 150, orbit
height 0.7, thick 0.05, delta 0.2), its :func:`fp32_oracle`, its counts
(8, 64, 256, 1000), its table and its verdict: the largest float32
accumulation error at the last count must stay under 1 % of rho (one vote).

The reference computes in float64 (``CudaReconstruction.cu:51``); the port's
kernel accumulates in float32. For each count the table gives, against the
float64 oracle:

* ``fp32 accumulate``: :func:`fp32_oracle`, the oracle's float64 value of
  each view rounded to float32 and summed in float32 (accumulation error
  alone, no projection rounding), with the share of voxels it puts off by
  more than 1e-3. The verdict reads this row;
* the integrate route on the script's device (``--device cuda``, the
  counterpart of the JAX script's ``--tpu``: the CUDA kernel, one launch;
  ``--device cpu``: its plain version): the largest and median error, the
  share of voxels off by more than 1e-3 (``off_frac``), and the share of
  projected samples whose pixel flips (``flip_frac``): a (voxel, view)
  sample on the map in either projection whose pixel, or being on the map
  at all, differs between the kernel's float32 projection (the float32
  tables summed as ``ty + (tx + (tz + tc))``) and the float64 projection of
  the cell centre (the oracle's ``Camera.project_points``, in float64 on the
  device; the rule is ``_common.kernel_flips``). That is the share
  ``chip_smoke.py`` gates at the capstone. Each count also runs the plain
  version on the same tensors and records whether the route's volume equals
  it in int32 bit patterns (``plain_equal_bits``).

The oracle runs on the host, one call a view on a pool of threads: every
count is a prefix of the same views, so one pass over them gives the float64
and float32 sums at every count (:func:`prefix_sums`), equal bit for bit to
the oracle and to :func:`fp32_oracle` on each prefix.

Run from the root of a checkout::

    python -m cudadepthmapintegration_torch.scripts.fp32_error_study \
        [--counts 8 64 256 1000] [--device cuda|cpu]

Prints the table, the verdict and last the record as one JSON object (with
the card's name and power limit); exits 1 when the verdict fails.
``--device cuda`` (the default) raises when there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..kernels.integrate_cuda import integrate_views, integrate_views_torch
from ..ops.integrate import projection_tables
from ..ops.oracle import integrate_views_oracle
from ..testing import orbit_cameras
from ._common import card_description, kernel_flips, render_views, same_bits, script_device

__all__ = ["build", "flip_counts", "fp32_oracle", "main", "prefix_sums", "run"]

COUNTS = (8, 64, 256, 1000)
OFF_TOL = 1e-3


def build(n_views, width=256, height=192):
    """The JAX script's grid, views and ray potential."""
    grid = VoxelGrid(dims=(65, 65, 65), origin=(-1.63, -1.61, -1.59), spacing=(0.05,) * 3)
    cams = orbit_cameras(n_views, 4.0, focal=150.0, width=width, image_height=height,
                         height=0.7)
    views = render_views(cams, width, height)
    params = RayPotential(thick=0.05, rho=0.8, eta=0.03, delta=0.2)
    return grid, views, params


def fp32_oracle(grid, views, params):
    """The oracle algorithm with float32 accumulation, the kernel's precision
    class with no gather or rounding differences: each view's float64
    contribution rounded to float32 and added in float32."""
    vol = np.zeros(grid.volume_shape, np.float32)
    for v in views:
        contrib = integrate_views_oracle(grid, [v], params)
        vol += contrib.astype(np.float32)
    return vol


def prefix_sums(grid, views, params, counts):
    """Yield ``(n, float64 oracle, fp32_oracle)`` of ``views[:n]`` for each
    ``n`` of ``counts`` (ascending), from one oracle call a view."""
    exp = np.zeros(grid.volume_shape, np.float64)
    got = np.zeros(grid.volume_shape, np.float32)
    want = sorted(counts)
    # Each view's oracle runs on a thread of the pool (NumPy lets go of the
    # interpreter lock in its loops); the sums take the views in order, so
    # their bits are those of one loop.
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        contribs = pool.map(lambda v: integrate_views_oracle(grid, [v], params),
                            views[:want[-1]])
        for i, contrib in enumerate(contribs):
            exp += contrib
            got += contrib.astype(np.float32)
            while want and want[0] == i + 1:
                yield want.pop(0), exp.copy(), got.copy()


def flip_counts(grid, views, tables, device) -> tuple[np.ndarray, np.ndarray]:
    """Per view, the projected samples (on the map in either projection) and
    the flipped ones (``kernel_flips``) over every cell: the
    float32 projection is the kernel's, from ``tables`` (tx, ty, tz, tc in
    float32), the float64 one the oracle's ``Camera.project_points``, both
    computed on ``device``. Returns two int64 arrays of ``len(views)``."""
    centres = torch.from_numpy(grid.cell_centers_world(np.float64)).to(device)
    world = [centres[..., c] for c in range(3)]
    tx, ty, tz, tc = (torch.from_numpy(a).to(device) for a in tables)
    projected, flipped = [], []
    for v, view in enumerate(views):
        h, w = view.depth.shape
        rt, k = (torch.from_numpy(m).to(device) for m in (view.camera.rt, view.camera.k))
        cam = [world[0] * rt[r, 0] + world[1] * rt[r, 1] + world[2] * rt[r, 2] + rt[r, 3]
               for r in range(3)]
        hom = [cam[0] * k[r, 0] + cam[1] * k[r, 1] + cam[2] * k[r, 2] for r in range(3)]
        h32 = [ty[v, r][None, :, None] + (tx[v, r][None, None, :]
                                          + (tz[v, r][:, None, None] + tc[v, r]))
               for r in range(3)]
        _, (proj, flip) = kernel_flips(hom[0] / hom[2], hom[1] / hom[2], hom[2], h32, w, h)
        projected.append(int(proj.sum()))
        flipped.append(int(flip.sum()))
    return np.array(projected, np.int64), np.array(flipped, np.int64)


def run(counts=COUNTS, device="cuda") -> dict:
    """The study at ``counts``: prints the JAX script's table (an ``fp32
    accumulate`` row and a route row a count) and verdict, and returns the
    record."""
    device = script_device(device, "fp32_error_study")
    card = card_description(device)
    route = "cuda kernel" if device.type == "cuda" else "plain version"
    t0 = time.perf_counter()
    n_max = max(counts)
    grid, views_all, params = build(n_max)
    print(f"grid 64^3, views up to {n_max} (256x192), params {params}, {route} on {card}",
          flush=True)
    print(f"{'views':>6} {'max|err|':>12} {'med|err|':>12} {'max|err|/|sum|_max':>18}  note",
          flush=True)
    t = projection_tables(grid, views_all, np.float32)
    tables = (t.tx, t.ty, t.tz, t.tc)
    depths = np.stack([v.depth for v in views_all]).astype(np.float32)
    projected, flipped = np.cumsum(flip_counts(grid, views_all, tables, device), axis=1)
    rows, kernel_rows = [], []
    for n, exp, got in prefix_sums(grid, views_all, params, counts):
        err = np.abs(got - exp)
        scale = np.abs(exp).max()
        rows.append(dict(views=n, max_err=float(err.max()), median_err=float(np.median(err)),
                         rel_err=float(err.max() / scale), off_frac=float((err > OFF_TOL).mean()),
                         off_voxels=int((err > OFF_TOL).sum())))
        print(f"{n:6d} {err.max():12.3e} {np.median(err):12.3e} {err.max() / scale:18.3e}  "
              f"fp32 accumulate (off-frac {rows[-1]['off_frac']:.1e})", flush=True)
        args = [torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)
                for a in (*tables, depths)]
        vol = integrate_views(torch.zeros(grid.volume_shape, device=device), *args, params)
        plain = integrate_views_torch(torch.zeros_like(vol), *args, params)
        equal = same_bits(vol, plain)
        err_k = np.abs(vol.cpu().numpy() - exp)
        off = float((err_k > OFF_TOL).mean())
        flips = float(flipped[n - 1] / max(projected[n - 1], 1))
        kernel_rows.append(dict(views=n, max_err=float(err_k.max()),
                                median_err=float(np.median(err_k)),
                                rel_err=float(err_k.max() / scale), off_frac=off,
                                off_voxels=int((err_k > OFF_TOL).sum()),
                                projected_samples=int(projected[n - 1]),
                                flipped_samples=int(flipped[n - 1]), flip_frac=flips,
                                plain_equal_bits=equal))
        print(f"{n:6d} {err_k.max():12.3e} {np.median(err_k):12.3e} "
              f"{err_k.max() / scale:18.3e}  {route} (off-frac {off:.1e}, "
              f"flip-frac {flips:.1e}, {'=' if equal else '!='} plain bitwise)", flush=True)
    # Sequential float32 summation error grows ~ n * eps * max|partial sum|;
    # at the last count it should sit well below rho (one vote).
    last = rows[-1]
    budget = 0.01 * params.rho
    verdict = "PASS" if last["max_err"] < budget else "FAIL"
    print(f"{verdict}: max fp32 accumulation error at {last['views']} views = "
          f"{last['max_err']:.3e} (budget {budget:.1e} = 1% of one rho vote)", flush=True)
    return dict(rows=rows, route=route, kernel_rows=kernel_rows, budget=budget,
                verdict=verdict, voxels=grid.num_cells, seconds=time.perf_counter() - t0,
                device=str(device), card=card)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cudadepthmapintegration_torch.scripts.fp32_error_study",
        description="Float32 error of fusion against the float64 oracle, by view count.")
    p.add_argument("--counts", type=int, nargs="*", default=list(COUNTS))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the CUDA kernel; default) or cpu (its plain version)")
    a = p.parse_args(argv)
    if not a.counts or min(a.counts) < 1:
        p.error("--counts takes one or more positive view counts")
    rec = run(a.counts, a.device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
