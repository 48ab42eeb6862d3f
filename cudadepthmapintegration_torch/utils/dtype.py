"""Conversions between numpy and torch floating dtypes.

The host side (projection tables, readers, writers) works in numpy and the
device side in torch; a dtype given as ``"float32"``, ``np.float32`` or
``torch.float32`` names the same type on both.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["numpy_dtype", "torch_dtype"]


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32`` / ``"float32"`` / ``np.float32`` -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def numpy_dtype(dtype) -> np.dtype:
    """The numpy counterpart of a torch dtype (or of any name of one)."""
    return np.dtype(str(torch_dtype(dtype)).removeprefix("torch."))
