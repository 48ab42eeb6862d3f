"""``cudareconstruction`` CLI.

Flag-for-flag equivalent of ``Reconstruction/main.cxx:216-343`` (names,
defaults, and validation rules preserved):

  --gridDims N [N N]        --gridSpacing SX SY SZ   --gridOrigin OX OY OZ
  --gridEnd EX EY EZ        --gridVecX/Y/Z VX VY VZ
  --dataFolder PATH         --depthMapFile NAME (default vtiList.txt)
  --KRTFile NAME (default kList.txt)
  --rayThick (2) --rayRho (0.8) --rayEta (0.03) --rayDelta (0.3)
  --threshBestCost (0.14)   --contour (1.0)
  --outputMeshFilename X.vtp  --outputGridFilename X.vts
  --verbose --summary --forceCubicVoxel

plus ``--dtype``, ``--streamBatch``, ``--mhaPath``, ``--checkpoint``,
``--trace DIR``, ``--metrics FILE`` and ``--device cuda|cpu`` (default cuda:
with no CUDA device the run stops with an error).

Validation parity: dims/spacing mutually exclusive (main.cxx:249-254); a
single --gridDims value broadcasts to 3 (main.cxx:257-261); delta >= thick and
0 <= eta <= 1 (main.cxx:270-276); .vtp/.vts extension checks (main.cxx:286-
293); orthogonal grid vectors (main.cxx:363-382); dims<->spacing inference
from gridEnd (main.cxx:309-331). A missing --gridEnd is a clean error
instead of undefined behavior (main.cxx:310-312 reads it unconditionally).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from ..io.dataset import DepthMapDataset
from ..pipeline.reconstruction import ReconstructionConfig, ReconstructionPipeline
from ..utils.log import Log
from ._device import add_device_flag, device_error

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cudareconstruction",
        description="Depth-map fusion (TSDF ray potential) + isosurface "
        "extraction on PyTorch and CUDA.",
    )
    p.add_argument("--gridDims", type=int, nargs="+", default=None,
                   help="Input grid dimensions (required unless gridSpacing)")
    p.add_argument("--gridSpacing", type=float, nargs="+", default=None,
                   help="Input grid spacing")
    p.add_argument("--gridOrigin", type=float, nargs=3, required=True,
                   help="Input grid origin (required)")
    p.add_argument("--gridEnd", type=float, nargs=3, default=None,
                   help="Define the end of the grid")
    p.add_argument("--gridVecX", type=float, nargs=3, default=[1.0, 0.0, 0.0],
                   help="Input grid direction X (default 1 0 0)")
    p.add_argument("--gridVecY", type=float, nargs=3, default=[0.0, 1.0, 0.0],
                   help="Input grid direction Y (default 0 1 0)")
    p.add_argument("--gridVecZ", type=float, nargs=3, default=[0.0, 0.0, 1.0],
                   help="Input grid direction Z (default 0 0 1)")
    p.add_argument("--outputGridFilename", type=str, required=True,
                   help="Output grid filename (.vts) (required)")
    p.add_argument("--outputMeshFilename", type=str, required=True,
                   help="Output mesh filename (.vtp) (required)")
    p.add_argument("--dataFolder", type=str, required=True,
                   help="Folder which contains all data (required)")
    p.add_argument("--depthMapFile", type=str, default="vtiList.txt",
                   help="File which contains all the depth map path "
                        "(default vtiList.txt)")
    p.add_argument("--KRTFile", type=str, default="kList.txt",
                   help="File which contains all the KRTD path "
                        "(default kList.txt)")
    p.add_argument("--rayThick", type=float, default=2.0,
                   help="Ray potential thickness threshold (default 2)")
    p.add_argument("--rayRho", type=float, default=0.8,
                   help="Ray potential rho (default 0.8)")
    p.add_argument("--rayEta", type=float, default=0.03,
                   help="0 < Eta < 1 : percentage of rho (default 0.03)")
    p.add_argument("--rayDelta", type=float, default=0.3,
                   help="Has to be superior to Thick (default 0.3)")
    p.add_argument("--threshBestCost", type=float, default=0.14,
                   help="Threshold applied on depth map (default 0.14)")
    p.add_argument("--contour", type=float, default=1.0,
                   help="Isocontour value (default 1.0)")
    p.add_argument("--verbose", action="store_true",
                   help="Display debug information on console")
    p.add_argument("--summary", action="store_true",
                   help="Write a summary file on dataFolder")
    p.add_argument("--forceCubicVoxel", action="store_true",
                   help="Set all voxel spacings to the min of the three")
    # Extensions (not in the reference CLI):
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"],
                   help="Fusion compute dtype (default float32; the CUDA "
                        "kernel takes float32 only)")
    add_device_flag(p)
    p.add_argument("--streamBatch", type=int, default=32,
                   help="Views per host->device transfer and kernel launch "
                        "(default 32)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Fault-tolerant fusion: checkpoint view-range units "
                        "to this file; re-running with the same path "
                        "RESUMES after a crash")
    p.add_argument("--trace", type=str, default=None,
                   help="Capture a torch.profiler trace of the run (host ops "
                        "and, on the card, CUDA kernels and copies) into this "
                        "directory as Chrome trace JSON (the NSight "
                        "counterpart, reference README:43-50)")
    p.add_argument("--metrics", type=str, default=None,
                   help="Write a JSON metrics report (voxel updates/s, "
                        "views/s, HBM roofline fraction) to this path")
    p.add_argument("--mhaPath", type=str, default="meta_image_volume.mha",
                   help="Path of the always-written meta-image volume; "
                        "'' disables (reference hardcodes cwd)")
    return p


def _validate(args) -> str | None:
    """Returns an error string, or None. Mirrors ReadArguments."""
    if args.gridSpacing is not None and args.gridDims is not None:
        return "Error : Spacing and dimensions can't be both set"
    if args.gridDims is not None and len(args.gridDims) == 1:
        args.gridDims = args.gridDims * 3
    if args.gridDims is not None and len(args.gridDims) != 3:
        return "Error : gridDims takes 1 or 3 values"
    if args.gridSpacing is not None and len(args.gridSpacing) != 3:
        return "Error : gridSpacing takes 3 values"
    if args.rayDelta < args.rayThick:
        return "Error arguments. (rayDelta must be >= rayThick)"
    if not (0.0 <= args.rayEta <= 1.0):
        return "Error arguments. (rayEta must be within [0, 1])"
    # Exact suffix, not substring: the reference's check (main.cxx:286-293)
    # is a contains() on the whole path, which accepts e.g. "a.vts.bak".
    if not args.outputGridFilename.endswith(".vts") or not args.outputMeshFilename.endswith(".vtp"):
        return "Error : Bad output extension."
    if args.gridDims is None and args.gridSpacing is None:
        return "Error : one of gridDims / gridSpacing is required"
    if args.gridEnd is None and (args.gridDims is None or args.gridSpacing is None):
        return "Error : gridEnd is required unless both dims and spacing are given"
    return None


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    err = _validate(args)
    if err:
        print(err, file=sys.stderr)
        parser.print_help(sys.stderr)
        return 1
    err = device_error(args.device)
    if err:
        print(err, file=sys.stderr)
        return 1

    log = Log(verbose=args.verbose)
    config = ReconstructionConfig(
        grid_dims=tuple(args.gridDims) if args.gridDims else None,
        grid_spacing=tuple(args.gridSpacing) if args.gridSpacing else None,
        grid_origin=tuple(args.gridOrigin),
        grid_end=tuple(args.gridEnd) if args.gridEnd else None,
        grid_vec_x=tuple(args.gridVecX),
        grid_vec_y=tuple(args.gridVecY),
        grid_vec_z=tuple(args.gridVecZ),
        ray_thick=args.rayThick,
        ray_rho=args.rayRho,
        ray_eta=args.rayEta,
        ray_delta=args.rayDelta,
        threshold_best_cost=args.threshBestCost,
        contour_value=args.contour,
        force_cubic_voxel=args.forceCubicVoxel,
        dtype=args.dtype,
        device=args.device,
        stream_batch=args.streamBatch,
        write_mha_path=args.mhaPath or None,
        checkpoint_path=args.checkpoint,
    )

    try:
        dataset = DepthMapDataset.from_folder(
            args.dataFolder, args.depthMapFile, args.KRTFile
        )
    except (OSError, ValueError) as e:
        print(f"Error : {e}", file=sys.stderr)
        return 1

    pipeline = ReconstructionPipeline(config, log)
    trace_ctx = contextlib.nullcontext()
    if args.trace:
        from ..utils.profiling import trace

        trace_ctx = trace(args.trace)
    try:
        with trace_ctx:
            result = pipeline.run(
                dataset,
                output_mesh_path=args.outputMeshFilename,
                output_grid_path=args.outputGridFilename,
            )
    except ValueError as e:
        print(f"Error : {e}", file=sys.stderr)
        return 1

    if args.metrics:
        import torch

        from ..utils.profiling import FusionMetrics

        chip = torch.cuda.get_device_name() if args.device == "cuda" else ""
        m = FusionMetrics(seconds=result.execution_time, chip=chip)
        # One volume read+write sweep per kernel launch, as the integrator
        # counts them.
        m.add_fusion(result.grid.num_cells, result.views_fused,
                     passes=max(1, result.volume_sweeps))
        with open(args.metrics, "w") as f:
            f.write(m.json() + "\n")
        log.info(f"** Metrics written to {args.metrics}")

    if args.summary:
        summary_path = os.path.join(args.dataFolder, "summary.txt")
        pipeline.write_summary(summary_path, result, argv or sys.argv)
        log.info(f"** Summary written to {summary_path}")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
