"""Build the hand-written CUDA kernels at first use and load them.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into one shared library with
a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/libcdmi_torch_<hash>.so *.o

``<hash>`` is a content hash of the sources (``*.cu`` and the ``*.cuh``
headers they include), so an edited source rebuilds.
``--fmad=false`` is part of the kernels' contract: it keeps every
multiply-add unfused, as the parity rules require.

The library lives in the build directory (:func:`build_dir`):
``$CDMI_TORCH_BUILD_DIR`` when that is set, else
``cudadepthmapintegration_torch/build/`` (ignored by git) when it can be
written, else ``~/.cache/cdmi_torch`` (a read-only install). Built once per
source hash, it persists across runs, as the JAX package's compile cache
does (``cli/_cache.py`` there).

Nothing here runs at import: the CPU tests import the kernel modules on a
machine with neither a GPU nor ``nvcc``. A failed build raises with nvcc's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD", "BuildInfo", "build_dir", "check", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
PKG_BUILD_DIR = _PKG / "build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)
LINK_FLAGS = (*_ARCH, "-shared")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of csrc/*.cu: name -> argtypes. Each takes the device
# index and the stream last and returns the cudaError_t of its launch.
_ENTRIES = {
    "cdmi_integrate": [_P] * 5 + [_I] * 6 + [_F] * 5 + [_I, _P],
    "cdmi_gather_colors": [_P] * 5 + [_I] * 5 + [_F] + [_I, _P],
    "cdmi_color_stats": [_P, _I] + [_P] * 3 + [_I] * 2 + [_I, _P],
    "cdmi_sparse_fuse": [_P] * 9 + [_I] * 7 + [_F] * 6 + [_I, _P],
    "cdmi_sparse_fuse_rows": [_P] * 9 + [_I] * 7 + [_F] * 6 + [_I, _P],
}


@dataclasses.dataclass
class BuildInfo:
    """What :func:`load_library` did: the library path, whether it was
    compiled in this process, the seconds that took, and nvcc's output
    (``-Xptxas -v`` lists each kernel's registers and spills)."""

    path: Path | None = None
    compiled: bool = False
    seconds: float = 0.0
    log: str = ""


BUILD = BuildInfo()


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*sources, *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the library is built and looked for."""
    override = os.environ.get("CDMI_TORCH_BUILD_DIR")
    if override:
        return Path(override).expanduser()
    probe = PKG_BUILD_DIR if PKG_BUILD_DIR.exists() else PKG_BUILD_DIR.parent
    if os.access(probe, os.W_OK | os.X_OK):
        return PKG_BUILD_DIR
    return Path.home() / ".cache" / "cdmi_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "cannot be built"
    )


def _run_failed(cmd: list[str], rc: int, output: str) -> RuntimeError:
    return RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{output}")


def _compile(sources: list[Path], out: Path) -> str:
    """One nvcc per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.parent / f"{tag}.so.tmp"
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise _run_failed(cmd, proc.returncode, log)
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise _run_failed(link, proc.returncode, proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out = build_dir() / f"libcdmi_torch_{_digest(sources)}.so"
        if not out.exists():
            t0 = time.perf_counter()
            BUILD.log = _compile(sources, out)
            BUILD.seconds = time.perf_counter() - t0
            BUILD.compiled = True
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD.path = out
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a ``cudaError_t``) for its
    launch: a refused launch never runs, and a later synchronize would not
    report it."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
