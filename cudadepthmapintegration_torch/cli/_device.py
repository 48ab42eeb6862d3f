"""The ``--device`` flag shared by the CLIs."""

from __future__ import annotations

import argparse

import torch

__all__ = ["add_device_flag", "device_error"]


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Where the volume and the kernels run: cuda (the "
                        "hand-written CUDA kernels) or cpu (their plain "
                        "PyTorch versions); default cuda")


def device_error(device: str) -> str | None:
    """An error message when ``device`` cannot serve the run, else None.
    There is no fallback from cuda to cpu."""
    if device == "cuda" and not torch.cuda.is_available():
        return ("Error : --device cuda needs a CUDA device and none is "
                "available (run with --device cpu to use the CPU)")
    return None
