"""``coloration`` CLI — flag parity with ``Coloration/main.cxx:104-135``:

  --input X.vtp --output Y.vtp --krtd kList.txt --vti vtiList.txt [--verbose]

plus ``--zTest``, ``--occlusionTol``, ``--dtype``, ``--compatIntMean`` and
``--device cuda|cpu`` (default cuda: with no CUDA device the run stops with
an error).
"""

from __future__ import annotations

import argparse
import sys

from ..pipeline.coloration import ColorationConfig, ColorationPipeline
from ..utils.log import Log
from ._device import add_device_flag, device_error

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="coloration",
        description="Project mesh vertices into calibrated color images and "
        "attach mean/median color + visibility count.",
    )
    p.add_argument("--input", type=str, required=True,
                   help="(required) Path to a .vtp file")
    p.add_argument("--output", type=str, required=True,
                   help="(required) Path of the output file (.vtp)")
    p.add_argument("--krtd", type=str, required=True,
                   help="(required) File which contains all krtd paths")
    p.add_argument("--vti", type=str, required=True,
                   help="(required) File which contains all vti paths")
    p.add_argument("--verbose", action="store_true",
                   help="(optional) Display debug information")
    # Extensions (not in the reference CLI):
    p.add_argument("--zTest", action="store_true",
                   help="Reject samples from cameras behind the vertex "
                        "(the reference never does; opt-in fix)")
    p.add_argument("--occlusionTol", type=float, default=None,
                   help="Reject samples occluded in their own view: "
                        "camera z must not exceed the view's depth at the "
                        "pixel by more than this tolerance (world units; "
                        "the reference samples through occluders). Use at "
                        "least the voxel size — mesh vertices sit up to "
                        "half a voxel off the true surface.")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"],
                   help="Projection compute dtype (default float32; float64 "
                        "runs with --device cpu only, with or without "
                        "--occlusionTol: the CUDA kernels take float32)")
    add_device_flag(p)
    p.add_argument("--compatIntMean", action="store_true",
                   help="Reference-parity int mean numerator "
                        "(MeshColoration.cxx:176-178)")
    return p


def main(argv: list[str] | None = None, log: Log | None = None) -> int:
    """Run the CLI; returns the exit code. ``log`` (default: a new
    ``Log(verbose=--verbose)``) collects the phase timers ``Read input``,
    ``Process coloration`` and ``Write output image``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    err = device_error(args.device)
    if err:
        print(err, file=sys.stderr)
        return 1
    log = log or Log(verbose=args.verbose)
    config = ColorationConfig(
        vti_list=args.vti,
        krtd_list=args.krtd,
        z_test=args.zTest,
        dtype=args.dtype,
        device=args.device,
        compat_int_mean=args.compatIntMean,
        occlusion_tol=args.occlusionTol,
    )
    try:
        ColorationPipeline(config, log).run(args.input, args.output)
    except (OSError, ValueError) as e:
        print(f"Error during coloration process... ({e})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
