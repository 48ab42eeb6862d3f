"""Minimal, dependency-free reader/writer for the VTK XML file family.

The reference relies on VTK for all I/O (``vtkXMLImageDataReader`` at
``Sources/ReconstructionData.cxx:223-229``, writers at
``Reconstruction/main.cxx:157-198`` and ``Coloration/main.cxx:87-90``). This
module implements the subset of the VTK XML container format needed for full
interop without VTK:

* DataArray formats: ``ascii``, ``binary`` (inline base64, optionally
  zlib-compressed), and ``appended`` (raw or base64, optionally compressed);
* header types UInt32 / UInt64;
* little-endian byte order (the only order we emit; big-endian inputs raise).

Writing emits ``appended`` + ``raw`` encoding (VTK's default fast path) with
optional zlib compression, which stock VTK readers accept.
"""

from __future__ import annotations

import base64
import xml.etree.ElementTree as ET
import zlib
from dataclasses import dataclass, field

import numpy as np

from .. import native

__all__ = [
    "VTK_TO_NUMPY",
    "NUMPY_TO_VTK",
    "DataArraySpec",
    "decode_data_array",
    "parse_vtk_xml",
    "VtkXmlWriter",
]

VTK_TO_NUMPY = {
    "Int8": np.int8,
    "UInt8": np.uint8,
    "Int16": np.int16,
    "UInt16": np.uint16,
    "Int32": np.int32,
    "UInt32": np.uint32,
    "Int64": np.int64,
    "UInt64": np.uint64,
    "Float32": np.float32,
    "Float64": np.float64,
}
NUMPY_TO_VTK = {np.dtype(v): k for k, v in VTK_TO_NUMPY.items()}

_HEADER_DTYPE = {"UInt32": np.uint32, "UInt64": np.uint64}


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


@dataclass
class _FileContext:
    """Parsed container state shared by all DataArrays of one file."""

    header_type: str = "UInt32"
    compressed: bool = False
    appended: bytes | None = None
    appended_encoding: str = "raw"


def _split_appended(raw: bytes) -> tuple[bytes, bytes | None, str]:
    """Separate the (possibly non-XML) <AppendedData> payload from the XML.

    Files with ``encoding="raw"`` appended data are not well-formed XML, so the
    payload is excised byte-wise before parsing.
    """
    start = raw.find(b"<AppendedData")
    if start < 0:
        return raw, None, "raw"
    tag_end = raw.index(b">", start)
    tag = raw[start : tag_end + 1].decode("ascii", "replace")
    encoding = "base64" if 'encoding="base64"' in tag else "raw"
    close = raw.rfind(b"</AppendedData>")
    if close < 0:
        raise ValueError("unterminated <AppendedData> section")
    payload = raw[tag_end + 1 : close]
    underscore = payload.find(b"_")
    if underscore < 0:
        raise ValueError("appended data payload missing leading underscore")
    payload = payload[underscore + 1 :]
    xml_bytes = raw[: tag_end + 1] + b"</AppendedData>" + raw[close + len(b"</AppendedData>") :]
    return xml_bytes, payload, encoding


def parse_vtk_xml(path: str) -> tuple[ET.Element, _FileContext]:
    """Parse a VTK XML file; returns the root element and decoding context."""
    with open(path, "rb") as f:
        raw = f.read()
    xml_bytes, appended, appended_encoding = _split_appended(raw)
    root = ET.fromstring(xml_bytes)
    if root.tag != "VTKFile":
        raise ValueError(f"not a VTKFile: root tag {root.tag!r} in {path}")
    byte_order = root.get("byte_order", "LittleEndian")
    if byte_order != "LittleEndian":
        raise ValueError(f"unsupported byte order {byte_order!r} in {path}")
    ctx = _FileContext(
        header_type=root.get("header_type", "UInt32"),
        compressed=root.get("compressor", "") != "",
        appended=appended,
        appended_encoding=appended_encoding,
    )
    return root, ctx


def _decompress_blocks(buf: bytes, header_dtype) -> bytes:
    """Decode VTK's compressed block stream: header ints
    [nblocks, block_size, last_block_size, csize_0..csize_{n-1}] followed by
    the concatenated zlib blocks. The native codec inflates them when the
    native library is available, Python ``zlib`` otherwise: the same bytes
    either way."""
    itemsize = np.dtype(header_dtype).itemsize
    nblocks = int(np.frombuffer(buf[:itemsize], dtype=header_dtype)[0])
    header_len = (3 + nblocks) * itemsize
    header = np.frombuffer(buf[:header_len], dtype=header_dtype)
    csizes = header[3:]
    if nblocks > 0 and native.available():
        total = int(header[1]) * (nblocks - 1) + int(header[2])
        return native.zlib_decode_blocks(buf[header_len:], csizes.astype(np.int64), total)
    out = []
    off = header_len
    for cs in csizes:
        cs = int(cs)
        out.append(zlib.decompress(buf[off : off + cs]))
        off += cs
    return b"".join(out)


def _decode_binary_inline(text: str, ctx: _FileContext) -> bytes:
    """Inline base64 DataArray payload.

    Uncompressed: one base64 stream of header+data. Compressed: the header is
    base64-encoded separately from the block stream (VTK quirk), so decode the
    header first to learn how much block data follows.
    """
    compact = "".join(text.split())
    if not ctx.compressed:
        blob = base64.b64decode(compact)
        itemsize = np.dtype(_HEADER_DTYPE[ctx.header_type]).itemsize
        return blob[itemsize:]
    itemsize = np.dtype(_HEADER_DTYPE[ctx.header_type]).itemsize
    # Base64 length of the first header int alone:
    first_b64 = 4 * ((itemsize + 2) // 3)
    nblocks = int(
        np.frombuffer(
            base64.b64decode(compact[:first_b64])[:itemsize],
            dtype=_HEADER_DTYPE[ctx.header_type],
        )[0]
    )
    header_len = (3 + nblocks) * itemsize
    header_b64 = 4 * ((header_len + 2) // 3)
    header = base64.b64decode(compact[:header_b64])[:header_len]
    data = base64.b64decode(compact[header_b64:])
    return _decompress_blocks(header + data, _HEADER_DTYPE[ctx.header_type])


def _decode_appended(offset: int, ctx: _FileContext) -> bytes:
    assert ctx.appended is not None
    header_dtype = _HEADER_DTYPE[ctx.header_type]
    itemsize = np.dtype(header_dtype).itemsize
    buf = ctx.appended
    if ctx.appended_encoding == "base64":
        # Each array is an independent base64 stream starting at `offset`.
        if not ctx.compressed:
            head = base64.b64decode(_b64_slice(buf, offset, itemsize))
            nbytes = int(np.frombuffer(head[:itemsize], dtype=header_dtype)[0])
            blob = base64.b64decode(
                _b64_slice(buf, offset, itemsize + nbytes)
            )
            return blob[itemsize : itemsize + nbytes]
        head1 = base64.b64decode(_b64_slice(buf, offset, itemsize))
        nblocks = int(np.frombuffer(head1[:itemsize], dtype=header_dtype)[0])
        header_len = (3 + nblocks) * itemsize
        header_b64 = 4 * ((header_len + 2) // 3)
        header = base64.b64decode(buf[offset : offset + header_b64])[:header_len]
        csizes = np.frombuffer(header, dtype=header_dtype)[3:]
        total = int(csizes.sum())
        data = base64.b64decode(
            _b64_slice(buf, offset + header_b64, total)
        )
        return _decompress_blocks(header + data[:total], header_dtype)
    # raw encoding
    if not ctx.compressed:
        nbytes = int(
            np.frombuffer(buf[offset : offset + itemsize], dtype=header_dtype)[0]
        )
        return buf[offset + itemsize : offset + itemsize + nbytes]
    return _decompress_blocks(buf[offset:], header_dtype)


def _b64_slice(buf: bytes, offset: int, raw_len: int) -> bytes:
    """Slice enough base64 characters from `buf[offset:]` to cover raw_len
    decoded bytes (rounded up to a 4-char group)."""
    n = 4 * ((raw_len + 2) // 3)
    return buf[offset : offset + n]


def decode_data_array(elem: ET.Element, ctx: _FileContext) -> np.ndarray:
    """Decode one <DataArray> element to a 1-D (or (N, C)) numpy array."""
    dtype = VTK_TO_NUMPY[elem.get("type")]
    ncomp = int(elem.get("NumberOfComponents", "1"))
    fmt = elem.get("format", "ascii")
    if fmt == "ascii":
        arr = np.array((elem.text or "").split(), dtype=dtype)
    elif fmt == "binary":
        blob = _decode_binary_inline(elem.text or "", ctx)
        arr = np.frombuffer(blob, dtype=dtype).copy()
    elif fmt == "appended":
        blob = _decode_appended(int(elem.get("offset", "0")), ctx)
        arr = np.frombuffer(blob, dtype=dtype).copy()
    else:
        raise ValueError(f"unsupported DataArray format {fmt!r}")
    if ncomp > 1:
        arr = arr.reshape(-1, ncomp)
    return arr


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


@dataclass
class DataArraySpec:
    name: str
    data: np.ndarray  # flattened (N,) or (N, C)
    dtype: np.dtype | None = None


@dataclass
class VtkXmlWriter:
    """Builds a VTK XML file with appended raw-encoded arrays.

    Usage: construct, add DataArray elements via :meth:`data_array_xml` while
    building the XML body as text, then :meth:`write` the final file.
    """

    compress: bool = False
    header_type: str = "UInt64"
    _appended: bytearray = field(default_factory=bytearray)

    def data_array_xml(
        self,
        data: np.ndarray,
        name: str | None = None,
        indent: str = "      ",
    ) -> str:
        arr = np.ascontiguousarray(data)
        ncomp = arr.shape[1] if arr.ndim == 2 else 1
        vtk_type = NUMPY_TO_VTK[arr.dtype]
        offset = len(self._appended)
        self._appended += self._encode(arr.tobytes())
        name_attr = f' Name="{name}"' if name else ""
        ncomp_attr = f' NumberOfComponents="{ncomp}"' if ncomp > 1 else ""
        return (
            f'{indent}<DataArray type="{vtk_type}"{name_attr}{ncomp_attr} '
            f'format="appended" offset="{offset}"/>\n'
        )

    def _encode(self, payload: bytes) -> bytes:
        hdt = _HEADER_DTYPE[self.header_type]
        if not self.compress:
            return np.array([len(payload)], dtype=hdt).tobytes() + payload
        block = 32768
        nblocks = max(1, -(-len(payload) // block))
        last = len(payload) - (nblocks - 1) * block
        chunks = [
            zlib.compress(payload[i * block : min((i + 1) * block, len(payload))])
            for i in range(nblocks)
        ]
        header = np.array(
            [nblocks, block, last] + [len(c) for c in chunks], dtype=hdt
        ).tobytes()
        return header + b"".join(chunks)

    def write(self, path: str, vtk_type: str, body_xml: str) -> None:
        compressor = (
            ' compressor="vtkZLibDataCompressor"' if self.compress else ""
        )
        head = (
            f'<VTKFile type="{vtk_type}" version="1.0" byte_order="LittleEndian" '
            f'header_type="{self.header_type}"{compressor}>\n'
        )
        tail = '  <AppendedData encoding="raw">\n_'
        with open(path, "wb") as f:
            f.write(b'<?xml version="1.0"?>\n')
            f.write(head.encode())
            f.write(body_xml.encode())
            f.write(tail.encode())
            f.write(bytes(self._appended))
            f.write(b"\n  </AppendedData>\n</VTKFile>\n")
