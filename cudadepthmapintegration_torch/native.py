"""ctypes binding to the native host library (``native/build/libcdmi_native.so``).

The library is the repository's C++ host layer, built from ``native/`` by
its Makefile; it is not part of either Python package. It provides:

* the VTK-XML payload codec (base64 and zlib block streams), behind the
  reader at ``Sources/ReconstructionData.cxx:223-229``;
* a float64 TSDF integrator, the CPU counterpart of the reference CUDA
  kernel (``Reconstruction/CudaReconstruction.cu:158-212``), threaded over
  z-slabs;
* a float64 marching-cubes table walker (``Reconstruction/main.cxx:
  169-173``) that shares the port's lookup tables (``ops/mc_tables.py``).

The library is built on first use: ``make -C native`` runs under an
exclusive ``fcntl.flock`` on ``native/build/.lock``, so processes that load
at the same time build it once. It builds into a private output and renames
the file into place, so no process, this package's or another's, loads a
half-written library of its build.
A failed build is remembered with make's output: :func:`available` then
returns False, and every other function raises ``RuntimeError`` with that
output. Nothing falls back in here; callers that have another route (the
``.vti`` reader) ask :func:`available` first.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "base64_decode",
    "base64_encode",
    "zlib_decode_blocks",
    "integrate_f64",
    "marching_cubes_f64",
]

# The native/ tree the library is built from; tests point it elsewhere.
NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
LIB_NAME = "libcdmi_native.so"
MAKE_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None

_i64 = ctypes.c_int64
_dbl = ctypes.c_double
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _declare(lib: ctypes.CDLL) -> None:
    lib.cdmi_base64_decode.restype = _i64
    lib.cdmi_base64_decode.argtypes = [ctypes.c_char_p, _i64, _p_u8, _i64]
    lib.cdmi_base64_encode.restype = _i64
    lib.cdmi_base64_encode.argtypes = [_p_u8, _i64, ctypes.c_char_p, _i64]
    lib.cdmi_zlib_decode_blocks.restype = _i64
    lib.cdmi_zlib_decode_blocks.argtypes = [_p_u8, _p_i64, _i64, _p_u8, _i64]
    lib.cdmi_zlib_encode_blocks.restype = _i64
    lib.cdmi_zlib_encode_blocks.argtypes = [_p_u8, _i64, _i64, _p_u8, _i64, _p_i64, _i64]
    lib.cdmi_integrate_f64.restype = None
    lib.cdmi_integrate_f64.argtypes = [
        _p_f64, _p_f64, _p_f64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _dbl, _dbl, _dbl, _dbl, _dbl, _dbl,
        _dbl, _dbl, _dbl, _dbl,
        _p_f64, ctypes.c_int,
    ]
    lib.cdmi_marching_cubes_f64.restype = _i64
    lib.cdmi_marching_cubes_f64.argtypes = [
        _p_f64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _dbl,
        _p_f64, _p_f64, _p_f64,
        _p_i32, _p_i32, _p_i32, _p_i32,
        _p_f64, _p_i64, _i64,
    ]


def _make_into_place(native_dir: Path, lib_path: Path) -> None:
    """Build the library into a private output (``make OUT=...``), then
    rename it over ``lib_path``: another process, locked or not (the JAX
    package's loader runs make without a lock), never sees a half-written
    library of this build."""
    private = lib_path.parent / f".tmp-{os.getpid()}"
    private.mkdir(exist_ok=True)
    out = private / LIB_NAME
    cmd = ["make", "-C", str(native_dir), f"OUT={out.relative_to(native_dir)}"]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=MAKE_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, lib_path)
    finally:
        shutil.rmtree(private, ignore_errors=True)


def _build_and_open(native_dir: Path) -> ctypes.CDLL:
    """Under the build lock: build the library if it is missing, then open
    it. A library that is there but does not open (a build outside the lock
    was writing it) is built again. Raises RuntimeError with make's output
    if the build fails."""
    build = native_dir / "build"
    lib_path = build / LIB_NAME
    try:
        build.mkdir(parents=True, exist_ok=True)
        lock_file = open(build / ".lock", "w")
    except OSError as e:
        raise RuntimeError(f"cannot take the build lock in {build}: {e}") from e
    with lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if not lib_path.exists():
            _make_into_place(native_dir, lib_path)
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            _make_into_place(native_dir, lib_path)
            try:
                lib = ctypes.CDLL(str(lib_path))
            except OSError as e:
                raise RuntimeError(f"cannot load {lib_path}: {e}") from e
    _declare(lib)
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises RuntimeError with the
    reason (make's output) when it cannot be had. A failure is kept: it is
    not retried in this process."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            try:
                _lib = _build_and_open(NATIVE_DIR)
                return _lib
            except RuntimeError as e:
                _error = str(e)
        raise RuntimeError(f"native library unavailable: {_error}")


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def base64_decode(text: bytes | str) -> bytes:
    lib = _load()
    if isinstance(text, str):
        text = text.encode("ascii")
    cap = (len(text) // 4 + 1) * 3
    out = np.empty(cap, np.uint8)
    n = lib.cdmi_base64_decode(text, len(text), out, cap)
    if n < 0:
        raise ValueError("invalid base64 input")
    return out[:n].tobytes()


def base64_encode(data: bytes) -> str:
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    cap = (len(data) + 2) // 3 * 4 + 4
    out = ctypes.create_string_buffer(cap)
    n = lib.cdmi_base64_encode(src, len(data), out, cap)
    if n < 0:
        raise ValueError("base64 encode overflow")
    return out.raw[:n].decode("ascii")


def zlib_decode_blocks(blocks: bytes, csizes, total_out: int) -> bytes:
    """Inflate concatenated zlib blocks of compressed sizes ``csizes`` into
    ``total_out`` bytes (VTK's compressed block stream, headers removed)."""
    lib = _load()
    src = np.frombuffer(blocks, np.uint8)
    cs = np.ascontiguousarray(csizes, np.int64)
    out = np.empty(total_out, np.uint8)
    n = lib.cdmi_zlib_decode_blocks(src, cs, len(cs), out, total_out)
    if n < 0:
        raise ValueError("zlib block decode failed")
    return out[:n].tobytes()


def integrate_f64(grid, views, params, initial=None, n_threads=None) -> np.ndarray:
    """Native float64 CPU fusion into a (cz, cy, cx) volume: the call shape
    of ``ops.oracle.integrate_views_oracle`` (views already thresholded)."""
    from .core.camera import compose_projection

    lib = _load()
    n_threads = n_threads or (os.cpu_count() or 1)
    cz, cy, cx = grid.volume_shape
    out = (
        np.zeros((cz, cy, cx), np.float64)
        if initial is None
        else np.array(initial, np.float64, order="C")  # a copy
    )
    h, w = views[0].depth.shape
    proj = np.empty((len(views), 12), np.float64)
    cam_rows = np.empty((len(views), 4), np.float64)
    depths = np.empty((len(views), h * w), np.float64)
    for i, v in enumerate(views):
        p, c = compose_projection(v.camera, grid)
        proj[i] = p[:3, :].reshape(-1)
        cam_rows[i] = c
        depths[i] = np.asarray(v.depth, np.float64).reshape(-1)
    ox, oy, oz = grid.origin
    sx, sy, sz = grid.spacing
    lib.cdmi_integrate_f64(
        proj, cam_rows, depths,
        len(views), int(h), int(w), cx, cy, cz,
        ox, oy, oz, sx, sy, sz,
        float(params.thick), float(params.rho),
        float(params.eta), float(params.delta),
        out, int(n_threads),
    )
    return out


def marching_cubes_f64(point_volume, iso, xs, ys, zs):
    """Native float64 marching-cubes walk of a (nz, ny, nx) point volume;
    returns (verts (T, 3, 3), keys (T, 3)) in the grid frame, keys being the
    canonical edge ids of ``ops/mc_tables.py``."""
    from .ops.mc_tables import CORNER_OFFSETS, EDGE_CANONICAL, EDGE_CORNERS, TRI_TABLE

    lib = _load()
    pv = np.ascontiguousarray(point_volume, np.float64)
    nz, ny, nx = pv.shape
    xs, ys, zs = (np.ascontiguousarray(a, np.float64) for a in (xs, ys, zs))
    tables = [np.ascontiguousarray(t, np.int32).reshape(-1)
              for t in (TRI_TABLE, EDGE_CORNERS, CORNER_OFFSETS, EDGE_CANONICAL)]
    cap = 1024
    while True:
        verts = np.empty((cap, 3, 3), np.float64)
        keys = np.empty((cap, 3), np.int64)
        n = lib.cdmi_marching_cubes_f64(
            pv.reshape(-1), nz, ny, nx, float(iso), xs, ys, zs, *tables,
            verts.reshape(-1), keys.reshape(-1), cap,
        )
        if n <= cap:
            return verts[:n], keys[:n]
        cap = int(n) + 64
