"""``fuse_rgbd`` CLI — incremental RGB-D sequence fusion (BASELINE config 5).

Streams a TUM-format RGB-D sequence, a ScanNet ``.sens`` stream or any
vti/krtd dataset through the sparse block-hashed TSDF grid
(``ops/sparse_grid.py``) frame by frame and writes the extracted mesh. The
port of ``cudadepthmapintegration_tpu/cli/fuse_rgbd.py``: the same flags,
messages and exit codes, plus ``--device cuda|cpu`` (default cuda: with no
CUDA device the run stops with an error). This has no reference-CLI
counterpart (the reference only batch-fuses into a dense grid).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.ray_potential import RayPotential
from ..utils.log import Log
from ._device import add_device_flag, device_error

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fuse_rgbd",
        description="Incremental RGB-D fusion with sparse block allocation "
        "on PyTorch and CUDA.",
    )
    p.add_argument("--tum", type=str, default=None,
                   help="TUM-format dataset directory (depth.txt + "
                        "groundtruth.txt [+ rgb.txt])")
    p.add_argument("--sens", type=str, default=None,
                   help="ScanNet-format .sens sensor stream")
    p.add_argument("--vti", type=str, default=None,
                   help="Alternative input: file listing depth-map .vti paths")
    p.add_argument("--krtd", type=str, default=None,
                   help="With --vti: file listing .krtd camera paths")
    p.add_argument("--voxelSize", type=float, default=0.01,
                   help="Voxel edge length in meters (default 0.01)")
    p.add_argument("--rayThick", type=float, default=None,
                   help="Ray potential thickness (default 2*voxelSize)")
    p.add_argument("--rayRho", type=float, default=0.8)
    p.add_argument("--rayEta", type=float, default=0.03)
    p.add_argument("--rayDelta", type=float, default=None,
                   help="Truncation band (default 8*voxelSize)")
    p.add_argument("--threshBestCost", type=float, default=None,
                   help="Optional best-cost depth threshold")
    p.add_argument("--contour", type=float, default=0.0,
                   help="Isovalue for mesh extraction (default 0)")
    p.add_argument("--maxFrames", type=int, default=None)
    p.add_argument("--frameStride", type=int, default=1,
                   help="Fuse every Nth frame (default 1)")
    p.add_argument("--capacity", type=int, default=1 << 15,
                   help="Sparse block pool capacity (default 32768)")
    p.add_argument("--pixelStride", type=int, default=4,
                   help="Pixel subsampling for block allocation (default 4)")
    p.add_argument("--blockBudget", type=int, default=None,
                   help="Streaming working-set cap: when more blocks than "
                        "this are allocated, the ones farthest from the "
                        "current camera are evicted (their values reset if "
                        "re-observed). Bounds memory for unbounded "
                        "sequences; omit to keep everything.")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Checkpoint the sparse grid to this file every "
                        "--checkpointEvery fused frames; re-running with "
                        "the same path RESUMES after the last checkpointed "
                        "frame (the JAX package's fuse_rgbd reads and writes "
                        "the same format)")
    p.add_argument("--checkpointEvery", type=int, default=50,
                   help="Fused frames between checkpoints (default 50)")
    p.add_argument("--intrinsics", type=str, default="fr1",
                   choices=["fr1", "fr2", "fr3", "custom"],
                   help="TUM camera calibration preset, or 'custom' with "
                        "--fx/--fy/--cx/--cy (default fr1)")
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--output", type=str, required=True,
                   help="Output mesh path (.vtp)")
    p.add_argument("--colorize", action="store_true",
                   help="Attach mean/median vertex colors via a second "
                        "streaming pass over the frames (exact projective "
                        "coloration)")
    p.add_argument("--occlusionTol", type=float, default=None,
                   help="With --colorize: reject samples occluded in their "
                        "own frame (camera z > frame depth + tol; use at "
                        "least --voxelSize). Runs the plain PyTorch "
                        "occlusion-testing gather instead of the kernel.")
    p.add_argument("--onlineColor", action="store_true",
                   help="Accumulate vertex colors ONLINE in a per-block "
                        "color pool during fusion (single pass; works with "
                        "--blockBudget eviction where a second pass over "
                        "evicted geometry is impossible)")
    add_device_flag(p)
    p.add_argument("--verbose", action="store_true")
    return p


def _open_dataset(args):
    """The input sequence, or an error string."""
    if args.tum is not None:
        from ..io.tum import TUMDataset, TUMIntrinsics

        if args.intrinsics == "custom":
            vals = (args.fx, args.fy, args.cx, args.cy)
            if any(v is None for v in vals):
                return "Error : --intrinsics custom requires --fx --fy --cx --cy"
            intr = TUMIntrinsics(*vals)
        else:
            intr = TUMIntrinsics.freiburg(int(args.intrinsics[-1]))
        return TUMDataset(args.tum, intrinsics=intr)
    if args.sens is not None:
        from ..io.scannet import ScanNetSensDataset

        return ScanNetSensDataset(args.sens)
    from ..io.dataset import DepthMapDataset

    return DepthMapDataset(args.vti, args.krtd)


def main(argv: list[str] | None = None, log: Log | None = None) -> int:
    """Run the CLI; returns the exit code. ``log`` (default: a new
    ``Log(verbose=--verbose)``) collects the phase timers ``Fuse frames``,
    ``Extract mesh`` and, with ``--colorize``, ``Colorize``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    log = log or Log(verbose=args.verbose)
    n_inputs = sum(x is not None for x in (args.tum, args.vti, args.sens))
    if n_inputs != 1:
        print("Error : give exactly one of --tum / --vti / --sens", file=sys.stderr)
        return 1
    if args.vti is not None and args.krtd is None:
        print("Error : --vti requires --krtd", file=sys.stderr)
        return 1
    if ".vtp" not in args.output:
        print("Error : Bad output extension.", file=sys.stderr)
        return 1
    if args.colorize and args.onlineColor:
        print(
            "Error : --colorize and --onlineColor are exclusive (both "
            "write MeanColoration)",
            file=sys.stderr,
        )
        return 1

    params = RayPotential(
        thick=args.rayThick if args.rayThick is not None else 2 * args.voxelSize,
        rho=args.rayRho,
        eta=args.rayEta,
        delta=args.rayDelta if args.rayDelta is not None else 8 * args.voxelSize,
    )
    try:
        params.validate()
    except ValueError as e:
        print(f"Error arguments. ({e})", file=sys.stderr)
        return 1
    err = device_error(args.device)
    if err:
        print(err, file=sys.stderr)
        return 1

    try:
        dataset = _open_dataset(args)
    except (OSError, ValueError) as e:
        print(f"Error : {e}", file=sys.stderr)
        return 1
    if isinstance(dataset, str):
        print(dataset, file=sys.stderr)
        return 1

    from ..ops.sparse_grid import SparseTSDFGrid
    from ..pipeline.streaming import prefetch_views

    sparse = None
    next_index = 0
    fused_indices = []
    if args.checkpoint is not None and os.path.exists(args.checkpoint):
        try:
            sparse, extra = SparseTSDFGrid.load(args.checkpoint, device=args.device)
            next_index = int(extra.get("next_index", 0))
            fused_indices = list(extra.get("fused_indices", []))
            log.info(
                f"resumed {args.checkpoint}: {sparse.frames_fused} frames "
                f"fused, continuing at source frame {next_index}"
            )
        except (OSError, ValueError, KeyError) as e:
            print(f"Error : cannot resume checkpoint {args.checkpoint} ({e})", file=sys.stderr)
            return 1
        if sparse.voxel_size != args.voxelSize or sparse.with_color != args.onlineColor:
            print(
                "Error : checkpoint configuration does not match the "
                "command line (voxelSize/onlineColor)",
                file=sys.stderr,
            )
            return 1
    if sparse is None:
        sparse = SparseTSDFGrid(
            voxel_size=args.voxelSize,
            params=params,
            capacity=args.capacity,
            pixel_stride=args.pixelStride,
            with_color=args.onlineColor,
            device=args.device,
        )
    n = len(dataset)
    if args.maxFrames is not None:
        n = min(n, args.maxFrames * args.frameStride)

    def save_ckpt(cursor):
        sparse.save(args.checkpoint, extra={"next_index": cursor, "fused_indices": fused_indices})

    t0 = time.perf_counter()
    fused_since_ckpt = 0
    with log.phase("Fuse frames"):
        for i, frame in enumerate(prefetch_views(dataset)):
            if i >= n:
                break
            if i < next_index or i % args.frameStride:
                continue
            sparse.integrate_frame(frame, threshold_best_cost=args.threshBestCost)
            if args.blockBudget is not None and sparse.num_allocated > args.blockBudget:
                rt = frame.camera.rt
                cam = -rt[:3, :3].T @ rt[:3, 3]
                sparse.evict_far_from(cam, radius=float("inf"), keep_at_most=args.blockBudget)
            if args.colorize:
                fused_indices.append(i)
            if args.checkpoint is not None:
                fused_since_ckpt += 1
                if fused_since_ckpt >= args.checkpointEvery:
                    save_ckpt(i + 1)
                    fused_since_ckpt = 0
            log.progress(i + 1, n)
        if args.checkpoint is not None and fused_since_ckpt:
            save_ckpt(n)
    dt = time.perf_counter() - t0
    log.info("")
    log.info(
        f"fused {sparse.frames_fused} frames in {dt:.1f}s "
        f"({sparse.frames_fused / max(dt, 1e-9):.1f} fps), "
        f"{sparse.num_allocated} blocks allocated"
    )
    if sparse.num_allocated == 0:
        print("Error : no depth observations found", file=sys.stderr)
        return 1

    with log.phase("Extract mesh"):
        if args.onlineColor:
            mesh = sparse.extract_colored_mesh(iso=args.contour)
        else:
            mesh = sparse.extract_mesh(iso=args.contour)
    if args.colorize and fused_indices:
        from ..ops.coloration import colorize_mesh

        # Second streaming pass: frames are RE-READ from the dataset in
        # view_chunk batches, so host memory stays O(one batch) instead of
        # retaining every fused frame. For .sens input, colorize through the
        # NATIVE color camera (intrinsic_color + full-res image) instead of
        # the depth-resampled color.
        color_source = dataset.color_views() if hasattr(dataset, "color_views") else dataset
        if args.occlusionTol is not None and hasattr(dataset, "color_views"):
            # Native .sens color views carry a placeholder depth (no
            # occlusion evidence); occlusion testing needs the
            # depth-geometry views (depth-resampled color).
            log.info(
                "--occlusionTol: colorizing through the depth camera "
                "(occlusion needs per-frame depth)\n"
            )
            color_source = dataset

        class _LazyFusedViews:
            def __len__(self_inner):
                return len(fused_indices)

            def __getitem__(self_inner, j):
                return color_source[fused_indices[j]]

        with log.phase("Colorize"):
            mesh = colorize_mesh(
                mesh, _LazyFusedViews(), view_chunk=32,
                occlusion_tol=args.occlusionTol, device=args.device,
            )
    from ..io.polydata import write_vtp

    write_vtp(args.output, mesh)
    log.info(f"wrote {mesh.num_triangles} triangles to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
