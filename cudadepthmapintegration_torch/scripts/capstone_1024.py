"""Capstone run on one card: 1000 depth maps of 512x512 fused into a grid of
1024^3 cells, meshed whole and coloured against every view.

Counterpart of the JAX package's ``scripts/capstone_1024.py``, with its grid,
ray potential, camera rig and three modes, on PyTorch and the port's kernels:

* the maps are rendered on the device (depth and colour,
  :func:`testing.render_sphere_batch`) and stay there;
* fusion: ``ops.integrate.projection_tables`` on the host, then one
  ``kernels.integrate_cuda.integrate_views`` launch a batch of maps into one
  volume on the device. Views are added into each voxel one at a time, in
  order, so the volume is the same bit for bit for any batch size;
* the whole volume is meshed: ``ops.cell_to_point``, the contour and the
  weld on the device, gradient normals on the host, as
  ``ops.marching_cubes.extract_isosurface(..., weld_backend="device")``
  composes them (each timed on its own here);
* the mesh is coloured against every view with
  ``ops.coloration.colorize_points``, without the occlusion test: the staged
  texels of 1000 maps of 512x512 (1.05 GB) fit the coloration's staging
  budget and stay on the device.

The JAX script's TPU machinery (orientation groups, transposes, pads, pass
counts, chunked dispatch) changes no value and has no counterpart here.

Run from the root of a checkout::

    python -m cudadepthmapintegration_torch.scripts.capstone_1024 [n_views] [dims]
    python -m cudadepthmapintegration_torch.scripts.capstone_1024 hd [n_views] [dims]
    python -m cudadepthmapintegration_torch.scripts.capstone_1024 ckpt

The default mode fuses 1000 maps of 512x512 into ``dims`` 1025 (1024^3
cells), meshes and colours; ``hd`` fuses 32 maps of 1920x1080 into the same
grid; ``ckpt`` fuses 16 maps of 1920x1080 into 257^3 cells straight through,
then again with a checkpoint saved at the halfway view, the live volume
dropped and reloaded from the file, and compares the two volumes in int32
bit patterns.

``--device cuda`` (the default) runs the hand-written kernels and raises
when there is no card; ``--device cpu`` runs their plain versions, for small
sizes. Every phase prints one JSON line with the device and, on a card, its
name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..core.camera import Camera
from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential, ray_potential_np
from ..core.view import DepthMapView
from ..io.polydata import PolyData
from ..kernels import coloration_cuda, integrate_cuda
from ..kernels.integrate_cuda import integrate_views
from ..ops.cell_to_point import cell_to_point
from ..ops.coloration import _STAGED_BUDGET, colorize_points
from ..ops.integrate import projection_tables
from ..ops.marching_cubes import _device_soup, _transform_points, weld_soup_device
from ..ops.normals import normals_for_edge_keys, transform_normals
from ..pipeline.checkpoint import FusionCheckpoint, load_checkpoint, save_checkpoint
from ..testing import look_at_camera, render_sphere_batch
from ..utils.dtype import numpy_dtype
from ._common import Clock, card_description, kernel_flips, same_bits, script_device

__all__ = [
    "Result",
    "Scene",
    "capstone_scene",
    "checkpoint_drill",
    "device_tables",
    "fuse_maps",
    "main",
    "mesh_volume",
    "render_maps",
    "run",
    "sampled_oracle",
    "surface_windows",
]

N_VIEWS = 1000
DIMS = 1025  # grid points per axis: 1024^3 cells
MAP = (512, 512)  # width, height
HD_VIEWS = 32
HD_MAP = (1920, 1080)
CKPT_VIEWS = 16
CKPT_DIMS = 257
BATCH = 16  # maps an integrate launch
RENDER_BATCH = 16  # maps a render step: bounds its (B, H, W) temporaries
ISO = 1.0
ORIGIN = (-1.63, -1.61, -1.59)
EXTENT = 3.2


@dataclasses.dataclass
class Scene:
    """The capstone's grid, ray potential and cameras."""

    grid: VoxelGrid
    params: RayPotential
    cameras: list[Camera]
    width: int
    height: int


@dataclasses.dataclass
class Result:
    """What a run made, for callers that check it: the scene, the tables
    (tx, ty, tz, tc) and maps on the device, the fused volume, the mesh and
    its colour arrays (mean, median, count; None when not meshed), and the
    phases' records by name."""

    scene: Scene
    tables: tuple[torch.Tensor, ...]
    depths: torch.Tensor
    colors: torch.Tensor
    volume: torch.Tensor
    mesh: PolyData | None
    colours: tuple[np.ndarray, np.ndarray, np.ndarray] | None
    phases: dict[str, dict]


def capstone_scene(n_views: int, dims: int, width: int = MAP[0], height: int = MAP[1]) -> Scene:
    """The JAX script's grid, ray potential (2 voxels thick, an 8-voxel band)
    and cameras: view i at angle 2 pi i / n on a ring, at a distance
    uniform in [3.5, 4.5] and a height uniform in [-1, 1], with a focal
    length uniform in [250, 350] scaled by width / 512, drawn in that order
    from ``default_rng(0)``, each looking at the origin."""
    spacing = EXTENT / (dims - 1)
    grid = VoxelGrid(dims=(dims,) * 3, origin=ORIGIN, spacing=(spacing,) * 3)
    params = RayPotential(thick=2.0 * spacing, rho=0.8, eta=0.03, delta=8.0 * spacing)
    rng = np.random.default_rng(0)
    f_scale = width / 512.0  # the grid keeps its share of the image at HD
    cameras = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        r = float(rng.uniform(3.5, 4.5))
        eye = (r * np.cos(a), r * np.sin(a), float(rng.uniform(-1, 1)))
        focal = f_scale * float(rng.uniform(250, 350))
        cameras.append(look_at_camera(eye, (0, 0, 0), focal=focal, width=width, height=height))
    return Scene(grid, params, cameras, width, height)


def device_tables(scene: Scene, device) -> tuple[torch.Tensor, ...]:
    """The float32 projection tables (tx, ty, tz, tc) of every camera, built
    on the host in float64 and copied to ``device``."""
    views = [DepthMapView(depth=np.zeros((1, 1), np.float32), camera=c) for c in scene.cameras]
    t = projection_tables(scene.grid, views, np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (t.tx, t.ty, t.tz, t.tc))


def render_maps(scene: Scene, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Every camera's depth map (V, H, W) float32 and colour image
    (V, H, W, 3) uint8 of the unit sphere, rendered on ``device``."""
    cams = scene.cameras
    k_inv = torch.tensor(np.stack([np.linalg.inv(c.k) for c in cams]), dtype=torch.float32,
                         device=device)
    c_cam = torch.tensor(np.stack([c.rt[:3, 3] for c in cams]), dtype=torch.float32,
                         device=device)
    n, h, w = len(cams), scene.height, scene.width
    depths = torch.empty((n, h, w), dtype=torch.float32, device=device)
    colors = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, RENDER_BATCH):
        depths[s : s + RENDER_BATCH], colors[s : s + RENDER_BATCH] = render_sphere_batch(
            k_inv[s : s + RENDER_BATCH], c_cam[s : s + RENDER_BATCH], w, h)
    return depths, colors


def fuse_maps(
    volume: torch.Tensor,
    tables: tuple[torch.Tensor, ...],
    depths: torch.Tensor,
    params: RayPotential,
    batch: int = BATCH,
    start: int = 0,
    stop: int | None = None,
) -> torch.Tensor:
    """Add maps ``start .. stop`` into ``volume`` in place, ``batch`` maps a
    ``integrate_views`` call (0: all of them in one call), and return it."""
    stop = len(depths) if stop is None else stop
    step = batch or max(1, stop - start)
    for s in range(start, stop, step):
        e = min(s + step, stop)
        integrate_views(volume, *(t[s:e] for t in tables), depths[s:e], params)
    return volume


def surface_windows(grid: VoxelGrid, n: int = 8, size: int = 128) -> list[tuple[int, int, int]]:
    """``n`` windows of ``size`` x ``size`` cells, one a z slice, each centred
    on the unit sphere's surface, as (k, j0, i0) cell offsets: slice s lies at
    height 0.9 sin(pi (s + 0.5) / n - pi / 2) (spread over the sphere's
    extent), and its window's centre on that slice's circle at the angle
    2 pi s / n, so the windows cross the surface at n orientations. Each
    holds free space, the band where the ray potential ramps and the inside.
    """
    cz, cy, cx = grid.volume_shape
    # The sphere's centre and radius in cell units (cell k's centre is at
    # origin + (k + 0.5) * spacing).
    centre = [-o / sp - 0.5 for o, sp in zip(grid.origin, grid.spacing)]
    radius = [1.0 / sp for sp in grid.spacing]
    windows = []
    for s in range(n):
        height = 0.9 * np.sin(np.pi * (s + 0.5) / n - np.pi / 2)
        ring = np.sqrt(1.0 - height * height)
        phi = 2 * np.pi * s / n
        k = int(round(centre[2] + height * radius[2]))
        i = int(round(centre[0] + ring * np.cos(phi) * radius[0])) - size // 2
        j = int(round(centre[1] + ring * np.sin(phi) * radius[1])) - size // 2
        windows.append((min(max(k, 0), cz - 1), min(max(j, 0), cy - size),
                        min(max(i, 0), cx - size)))
    return windows


def sampled_oracle(
    scene: Scene,
    tables: tuple[np.ndarray, ...],
    depths: np.ndarray,
    fused: list[np.ndarray],
    windows: list[tuple[int, int, int]],
) -> dict:
    """The fused volume against the float64 oracle on windows of it.

    ``tables`` are the float32 (tx, ty, tz, tc) on the host, ``depths`` the
    (V, H, W) maps, ``fused`` the volume's (size, size) window at each
    (k, j0, i0) of ``windows``. For every window voxel the oracle sums the
    views in float64 from the cell centres, as
    ``ops.oracle.integrate_views_oracle`` does. Alongside, every sample is
    projected as the kernel projects it, from the float32 tables with the
    kernel's association, and counted as flipped where its pixel (or being
    on the map at all) differs from the float64 projection's.

    Returns the voxels, the share of them off the oracle by more than 1e-3
    (``off_frac``), how many of those have a flipped sample, and the largest
    error; the projected samples (on the map in either projection) and the
    share of them flipped (``flip_frac``).
    """
    grid, params = scene.grid, scene.params
    tx, ty, tz, tc = tables
    n_views, h, w = depths.shape
    xs, ys, zs = grid.cell_center_axes(np.float64)
    m = grid.matrix
    off = off_flipped = voxels = projected = flipped = 0
    max_err = 0.0
    for (k, j0, i0), vol in zip(windows, fused):
        sy, sx = vol.shape
        centres = np.stack(np.broadcast_arrays(xs[None, i0:i0 + sx], ys[j0:j0 + sy, None], zs[k]),
                           axis=-1)
        world = centres @ m[:3, :3].T + m[:3, 3]
        exp = np.zeros((sy, sx))
        has_flip = np.zeros((sy, sx), bool)
        for v, cam in enumerate(scene.cameras):
            u, vv, cam_z, hom_z = cam.project_points(world)
            # The kernel's projection: hom = ty + (tx + (tz + tc)) in float32.
            hom = [ty[v, r, j0:j0 + sy, None] + (tx[v, r, None, i0:i0 + sx]
                                                 + (tz[v, r, k] + tc[v, r]))
                   for r in range(3)]
            (px, py, on64), (proj, flip) = kernel_flips(u, vv, hom_z, hom, w, h)
            d = depths[v][np.where(on64, py, 0).astype(np.int64),
                          np.where(on64, px, 0).astype(np.int64)]
            exp += np.where(on64 & (d != -1.0), ray_potential_np(cam_z, d, params), 0.0)
            projected += int(proj.sum())
            flipped += int(flip.sum())
            has_flip |= flip
        err = np.abs(vol - exp)
        off += int((err > 1e-3).sum())
        off_flipped += int(((err > 1e-3) & has_flip).sum())
        voxels += err.size
        max_err = max(max_err, float(err.max()))
    return dict(windows=len(windows), voxels=voxels, off_voxels=off, off_frac=off / voxels,
                off_voxels_with_flip=off_flipped, max_abs_err=max_err, projected_samples=projected, flipped_samples=flipped,
                flip_frac=flipped / max(projected, 1))


class Report:
    """Prints one JSON line a phase, each with the mode, the device and the
    card's description, and keeps the records by phase name."""

    def __init__(self, device: torch.device, mode: str):
        self.device, self.mode = device, mode
        self.card = card_description(device)
        self.phases: dict[str, dict] = {}

    def __call__(self, phase: str, **fields) -> None:
        rec = dict(mode=self.mode, phase=phase, **fields, device=str(self.device),
                   card=self.card)
        self.phases[phase] = rec
        print(json.dumps(rec), flush=True)


def mesh_volume(grid: VoxelGrid, volume: torch.Tensor, iso: float, report: Report) -> PolyData:
    """The whole volume's isosurface at ``iso``: cell->point, the contour and
    weld on the volume's device, gradient normals on the host, as
    ``extract_isosurface(grid, volume, iso, weld_backend="device")`` makes
    it, each step reported with its seconds and the bytes it copied to the
    host."""
    clock = Clock(volume.device)
    with clock:
        pv = cell_to_point(volume)
    report("cell_to_point", seconds=clock.seconds, points=list(pv.shape), bytes=pv.nbytes)
    xs, ys, zs = grid.point_axes(numpy_dtype(pv.dtype))
    with clock:
        soup = _device_soup(pv, iso, xs, ys, zs)
        if soup is None:
            raise RuntimeError(f"no cell of the volume crosses {iso}")
        points, triangles, keys = weld_soup_device(*soup)
        del soup
        mesh = PolyData(_transform_points(points, grid.matrix), triangles)
    report("contour", seconds=clock.seconds, triangles=mesh.num_triangles,
           points=mesh.num_points, bytes_to_host=points.nbytes + triangles.nbytes + keys.nbytes)
    with clock:
        pv_host = pv.cpu().numpy()
        del pv
        normals = normals_for_edge_keys(pv_host, xs, ys, zs, keys, iso)
        mesh.point_data["Normals"] = transform_normals(normals, grid.matrix)
    report("normals", seconds=clock.seconds, bytes_to_host=pv_host.nbytes)
    mesh.point_data["reconstruction_scalar"] = np.full(mesh.num_points, iso, np.float64)
    mesh.active_scalars = "reconstruction_scalar"
    return mesh


def color_mesh(mesh: PolyData, scene: Scene, colors: torch.Tensor, report: Report):
    """Colour statistics of every mesh vertex against every view, from the
    rendered colour images: one copy of them to the host, then
    ``colorize_points`` on the images' device (no occlusion test)."""
    clock = Clock(colors.device)
    with clock:
        host = colors.cpu().numpy()
    copy_s = clock.seconds
    blank = np.broadcast_to(np.float32(-1.0), (scene.height, scene.width))
    views = [DepthMapView(depth=blank, camera=cam, color=host[i])
             for i, cam in enumerate(scene.cameras)]
    gathers, stats = coloration_cuda.launches, coloration_cuda.stats_launches
    with clock:
        mean, median, count = colorize_points(mesh.points, views, device=colors.device)
    n, v = mesh.num_points, len(views)
    texel_bytes = 4 * v * scene.height * scene.width
    report("coloration", seconds=clock.seconds, colors_to_host_s=copy_s,
           colors_to_host_bytes=host.nbytes, vertices=n, views=v,
           samples_per_s=n * v / clock.seconds, coloured_share=float((count > 0).mean()),
           gather_launches=coloration_cuda.launches - gathers,
           stats_launches=coloration_cuda.stats_launches - stats, occlusion_test=False,
           staged_texel_bytes=texel_bytes, staged_budget=_STAGED_BUDGET,
           regime="staged once" if texel_bytes <= _STAGED_BUDGET else "staged a chunk")
    return mean, median, count


def run(
    n_views: int = N_VIEWS,
    dims: int = DIMS,
    device="cuda",
    width: int = MAP[0],
    height: int = MAP[1],
    mesh: bool = True,
    mode: str = "default",
) -> Result:
    """The capstone: render ``n_views`` maps on ``device``, fuse them into a
    ``dims``^3-point grid and, with ``mesh``, mesh the whole volume and colour
    it against every view, ``BATCH`` maps an integrate launch. Prints one
    JSON line a phase."""
    device = script_device(device, "the capstone")
    report = Report(device, mode)
    clock = Clock(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with clock:
        scene = capstone_scene(n_views, dims, width, height)
        tables = device_tables(scene, device)
    grid = scene.grid
    report("cameras_tables", seconds=clock.seconds, views=n_views, dims=dims,
           cells=grid.num_cells, table_bytes=sum(t.nbytes for t in tables))
    with clock:
        depths, colors = render_maps(scene, device)
    report("render", seconds=clock.seconds, event_seconds=clock.event_seconds, maps=n_views,
           map=[width, height], maps_per_s=n_views / clock.seconds,
           bytes=depths.nbytes + colors.nbytes)
    volume = torch.zeros(grid.volume_shape, dtype=torch.float32, device=device)
    launches = integrate_cuda.launches
    with clock:
        fuse_maps(volume, tables, depths, scene.params)
    updates = grid.num_cells * n_views
    fused_s = clock.event_seconds or clock.seconds
    report("fusion", seconds=clock.seconds, event_seconds=clock.event_seconds,
           launches=integrate_cuda.launches - launches, batch=BATCH,
           cells=grid.num_cells, views=n_views, map=[width, height], voxel_updates=updates,
           g_voxel_updates_per_s=updates / fused_s / 1e9,
           wall_g_voxel_updates_per_s=updates / clock.seconds / 1e9)
    surface = colours = None
    if mesh:
        surface = mesh_volume(grid, volume, ISO, report)
        colours = color_mesh(surface, scene, colors, report)
    report("memory", peak_allocated_bytes=(torch.cuda.max_memory_allocated(device)
                                           if device.type == "cuda" else None))
    return Result(scene, tables, depths, colors, volume, surface, colours, report.phases)


def checkpoint_drill(
    device="cuda",
    n_views: int = CKPT_VIEWS,
    dims: int = CKPT_DIMS,
    width: int = HD_MAP[0],
    height: int = HD_MAP[1],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The resume drill: fuse the maps straight through, then again with a
    checkpoint (``pipeline.checkpoint``) saved at the halfway view, the live
    volume dropped, the file reloaded and checked against the grid and ray
    potential, and the rest fused. Raises unless the two volumes are equal
    in int32 bit patterns; returns (straight, resumed)."""
    device = script_device(device, "the capstone")
    if n_views < 2:
        raise ValueError(f"the drill needs at least 2 views, got {n_views}")
    report = Report(device, "ckpt")
    scene = capstone_scene(n_views, dims, width, height)
    tables = device_tables(scene, device)
    depths, _ = render_maps(scene, device)
    shape, params = scene.grid.volume_shape, scene.params
    straight = fuse_maps(torch.zeros(shape, dtype=torch.float32, device=device), tables, depths,
                         params)
    half = n_views // 2
    volume = fuse_maps(torch.zeros(shape, dtype=torch.float32, device=device), tables, depths,
                       params, stop=half)
    clock = Clock(device)
    with tempfile.TemporaryDirectory(prefix="cdmi_capstone_") as tmp:
        path = os.path.join(tmp, "capstone_ckpt.npz")
        with clock:
            save_checkpoint(path, FusionCheckpoint(volume=volume.cpu().numpy(), views_fused=half,
                                                   grid=scene.grid, params=params))
            del volume  # the live volume is dropped: only the file is left
            ck = load_checkpoint(path)
            if not ck.matches(scene.grid, params):
                raise RuntimeError("the checkpoint's grid or ray potential drifted")
            if ck.views_fused != half:
                raise RuntimeError(f"the checkpoint holds {ck.views_fused} views, not {half}")
            volume = torch.from_numpy(ck.volume).to(device)
        file_bytes = os.path.getsize(path)
    fuse_maps(volume, tables, depths, params, start=half)
    same = same_bits(straight, volume)
    report("checkpoint", views=n_views, dims=dims, map=[width, height], saved_at_view=half,
           save_reload_s=clock.seconds, file_bytes=file_bytes, bit_equal=same)
    if not same:
        raise RuntimeError("the resumed volume differs from the straight run")
    return straight, volume


def _ints(parser, words, names, defaults):
    if len(words) > len(names):
        parser.error(f"too many arguments: {' '.join(words)}")
    try:
        return [int(w) for w in words] + list(defaults[len(words):])
    except ValueError:
        parser.error(f"{' '.join(names)} must be integers, got {' '.join(words)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cudadepthmapintegration_torch.scripts.capstone_1024",
        description="Fuse sphere depth maps rendered on the device into a 1024^3-cell grid, "
                    "mesh the whole volume and colour it against every view.")
    p.add_argument("words", nargs="*", metavar="ARG",
                   help="[n_views] [dims] | hd [n_views] [dims] | ckpt")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the hand-written kernels; default) or cpu (their plain versions)")
    a = p.parse_args(argv)
    mode = a.words[0] if a.words and a.words[0] in ("hd", "ckpt") else "default"
    words = a.words[1:] if mode != "default" else a.words
    if mode == "ckpt":
        if words:
            p.error("ckpt takes no further arguments")
        checkpoint_drill(a.device, CKPT_VIEWS, CKPT_DIMS, *HD_MAP)
    elif mode == "hd":
        n_views, dims = _ints(p, words, ("n_views", "dims"), (HD_VIEWS, DIMS))
        run(n_views, dims, a.device, *HD_MAP, mesh=False, mode="hd")
    else:
        n_views, dims = _ints(p, words, ("n_views", "dims"), (N_VIEWS, DIMS))
        run(n_views, dims, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
