"""KRTD camera-file parsing and writing.

Format (``Sources/Helper.h:105-168``): three rows of K (3x3), a blank line,
three rows of R (3x3), a blank line, one row of T (3 values). Anything after
(the distortion row 'D') is ignored by the reference and by us. The RT matrix
is packed as [R | T] with bottom row (0, 0, 0, 1).
"""

from __future__ import annotations

import os

import numpy as np

from ..core.camera import Camera

__all__ = ["read_krtd", "write_krtd"]


def _read_row(line: str, n: int) -> list[float]:
    vals = [float(tok) for tok in line.split()[:n]]
    if len(vals) != n:
        raise ValueError(f"expected {n} values, got {len(vals)!r} in line {line!r}")
    return vals


def read_krtd(path: str | os.PathLike) -> Camera:
    """Parse a .krtd file into a Camera.

    Mirrors ``help::ReadKrtdFile``: K rows at lines 0-2, blank line, R rows at
    lines 4-6, blank line, T at line 8; distortion ignored.
    """
    with open(path, "r") as f:
        lines = f.read().splitlines()
    if len(lines) < 9:
        raise ValueError(f"krtd file too short ({len(lines)} lines): {path}")
    k = np.array([_read_row(lines[i], 3) for i in range(3)], dtype=np.float64)
    r = np.array([_read_row(lines[i], 3) for i in range(4, 7)], dtype=np.float64)
    t = np.array(_read_row(lines[8], 3), dtype=np.float64)
    rt = np.eye(4, dtype=np.float64)
    rt[:3, :3] = r
    rt[:3, 3] = t
    return Camera(k=k, rt=rt)


def write_krtd(path: str | os.PathLike, camera: Camera) -> None:
    """Write a camera in .krtd layout (with a zero distortion row)."""

    def fmt(row) -> str:
        return " ".join(repr(float(v)) for v in row)

    with open(path, "w") as f:
        for row in camera.k:
            f.write(fmt(row) + "\n")
        f.write("\n")
        for row in camera.rt[:3, :3]:
            f.write(fmt(row) + "\n")
        f.write("\n")
        f.write(fmt(camera.rt[:3, 3]) + "\n")
        f.write("\n0\n")
