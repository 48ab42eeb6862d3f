"""MetaImage (.mha) volume writer.

Replaces ``vtkMetaImageWriter`` used to always dump the fused volume as
``meta_image_volume.mha`` (``Reconstruction/main.cxx:157-161``, with
compression on). MetaImage = ASCII header + raw (optionally zlib) blob.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["write_mha", "read_mha"]

_MET_TYPES = {
    np.dtype(np.uint8): "MET_UCHAR",
    np.dtype(np.int16): "MET_SHORT",
    np.dtype(np.uint16): "MET_USHORT",
    np.dtype(np.int32): "MET_INT",
    np.dtype(np.float32): "MET_FLOAT",
    np.dtype(np.float64): "MET_DOUBLE",
}
_MET_TO_NUMPY = {v: k for k, v in _MET_TYPES.items()}


def write_mha(
    path: str,
    volume_zyx: np.ndarray,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    compress: bool = True,
) -> None:
    """Write a (nz, ny, nx) volume; dims in the header are (nx, ny, nz)."""
    vol = np.ascontiguousarray(volume_zyx)
    nz, ny, nx = vol.shape
    payload = vol.tobytes()
    if compress:
        payload = zlib.compress(payload)
    header = (
        "ObjectType = Image\n"
        "NDims = 3\n"
        "BinaryData = True\n"
        "BinaryDataByteOrderMSB = False\n"
        f"CompressedData = {'True' if compress else 'False'}\n"
        + (f"CompressedDataSize = {len(payload)}\n" if compress else "")
        + "TransformMatrix = 1 0 0 0 1 0 0 0 1\n"
        f"Offset = {origin[0]} {origin[1]} {origin[2]}\n"
        "CenterOfRotation = 0 0 0\n"
        f"ElementSpacing = {spacing[0]} {spacing[1]} {spacing[2]}\n"
        f"DimSize = {nx} {ny} {nz}\n"
        f"ElementType = {_MET_TYPES[vol.dtype]}\n"
        "ElementDataFile = LOCAL\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)


def read_mha(path: str) -> tuple[np.ndarray, dict]:
    """Read a LOCAL-data .mha; returns ((nz, ny, nx) array, header dict)."""
    with open(path, "rb") as f:
        raw = f.read()
    # Header lines end at 'ElementDataFile = LOCAL\n'
    marker = b"ElementDataFile = LOCAL\n"
    idx = raw.index(marker) + len(marker)
    header: dict[str, str] = {}
    for line in raw[: idx - 1].decode("ascii").splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            header[k.strip()] = v.strip()
    nx, ny, nz = (int(v) for v in header["DimSize"].split())
    dtype = _MET_TO_NUMPY[header["ElementType"]]
    payload = raw[idx:]
    if header.get("CompressedData", "False") == "True":
        payload = zlib.decompress(payload)
    vol = np.frombuffer(payload, dtype=dtype)[: nx * ny * nz].reshape(nz, ny, nx)
    return vol.copy(), header
