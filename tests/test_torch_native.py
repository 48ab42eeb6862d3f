"""The port's binding to the native host library against the JAX package's.

Both bind the same ``native/build/libcdmi_native.so``, so every result is
**byte-equal** (codec) or **bit-equal** (float64 fusion and marching cubes)
between them; the fusion is also held to the port's float64 oracle within
1e-12, as tests/test_native.py holds the JAX binding.

The port builds the library under a file lock: four processes that load it
at once from a fresh copy of ``native/`` run ``make`` once. It builds into a
private file and renames it into place, and builds again over a library
that does not load (half written by a build outside the lock). A build that
fails is kept with make's output, and an explicit native call raises it.

The module fixture ``native_libraries`` (``tests/_native_guard.py``) loads
both packages' libraries before these tests; a failure the JAX loader kept
from a half-written library is cleared and loaded again.
"""

import base64 as pybase64
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch import interop, native
from _native_guard import load_both, native_libraries  # noqa: F401  (module fixture)
from cudadepthmapintegration_torch.ops import integrate_views_oracle
from cudadepthmapintegration_torch.ops.marching_cubes import extract_isosurface
from cudadepthmapintegration_tpu import native as jax_native
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.testing import sphere_scene

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)


def sphere_field(n):
    xs = np.linspace(-1.6, 1.6, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return (np.sqrt(gx**2 + gy**2 + gz**2) - 1.0).transpose(2, 1, 0), xs


@pytest.mark.parametrize("n", [0, 1, 2, 3, 100, 1000])
def test_base64_equals_jax_and_python(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    enc = native.base64_encode(data)
    assert enc == jax_native.base64_encode(data) == pybase64.b64encode(data).decode()
    assert native.base64_decode(enc) == jax_native.base64_decode(enc) == data


def test_base64_whitespace_and_junk():
    assert native.base64_decode("aGVs\nbG8=") == b"hello"
    with pytest.raises(ValueError):
        native.base64_decode("a!b")


def test_zlib_blocks_equal_jax_and_python():
    payload = np.random.default_rng(1).integers(0, 50, 100000, dtype=np.uint8).tobytes()
    block = 32768
    chunks = [zlib.compress(payload[i : i + block]) for i in range(0, len(payload), block)]
    sizes = np.array([len(c) for c in chunks], np.int64)
    got = native.zlib_decode_blocks(b"".join(chunks), sizes, len(payload))
    assert got == jax_native.zlib_decode_blocks(b"".join(chunks), sizes, len(payload)) == payload


@pytest.fixture(scope="module")
def fused():
    views = sphere_scene(n_views=4, width=64, height=48)
    grid = VoxelGrid(dims=(17, 15, 13), origin=(-1.6, -1.5, -1.4), spacing=(0.2,) * 3)
    return grid, views


def test_integrate_f64_equals_jax_and_oracle(fused):
    grid, views = fused
    t_grid, t_views, t_params = (interop.grid_from(grid), interop.views_from(views),
                                 interop.params_from(PARAMS))
    got = native.integrate_f64(t_grid, t_views, t_params)
    exp = jax_native.integrate_f64(grid, views, PARAMS)
    assert got.dtype == np.float64 and got.shape == grid.volume_shape
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_allclose(got, integrate_views_oracle(t_grid, t_views, t_params),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got, native.integrate_f64(t_grid, t_views, t_params, n_threads=1))


def test_integrate_f64_resume(fused):
    grid, views = fused
    t_grid, t_views, t_params = (interop.grid_from(grid), interop.views_from(views),
                                 interop.params_from(PARAMS))
    part = native.integrate_f64(t_grid, t_views[:2], t_params)
    kept = part.copy()
    resumed = native.integrate_f64(t_grid, t_views[2:], t_params, initial=part)
    np.testing.assert_array_equal(part, kept)  # the seed is copied, not written
    np.testing.assert_array_equal(
        resumed, jax_native.integrate_f64(grid, views[2:], PARAMS, initial=kept))
    np.testing.assert_allclose(resumed, native.integrate_f64(t_grid, t_views, t_params),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [21, 41])  # 41: past the walker's first capacity
def test_marching_cubes_f64_equals_jax(n):
    vals, xs = sphere_field(n)
    verts, keys = native.marching_cubes_f64(vals, 0.0, xs, xs, xs)
    jverts, jkeys = jax_native.marching_cubes_f64(vals, 0.0, xs, xs, xs)
    assert verts.shape[1:] == (3, 3) and keys.shape == verts.shape[:2]
    if n == 41:
        assert verts.shape[0] > 1024
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(keys, jkeys)


def test_available():
    assert native.available()


LOADER = """
import sys
from pathlib import Path
import cudadepthmapintegration_torch.native as native
native.NATIVE_DIR = Path(sys.argv[1])
assert native.available()
print(native.base64_encode(b"lock"))
"""


def test_concurrent_loads_build_once(tmp_path):
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src, ignore=shutil.ignore_patterns("build"))
    makefile = src / "Makefile"
    # Count the builds: the library's recipe also appends a line to a log,
    # and waits long enough for every process to arrive while it builds.
    makefile.write_text(makefile.read_text().replace(
        "\t$(CXX)", "\techo build >> make_runs.log\n\tsleep 3\n\t$(CXX)", 1))
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == pybase64.b64encode(b"lock").decode()
    assert (src / "make_runs.log").read_text().splitlines() == ["build"]
    assert (src / "build" / native.LIB_NAME).exists()


@pytest.fixture()
def failed_build(tmp_path, monkeypatch):
    """The loader pointed at an empty tree, where make finds no Makefile."""
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setattr(native, "NATIVE_DIR", empty)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    return empty


def test_failed_build_raises_with_make_output(failed_build):
    vol = torch.zeros((5, 4, 3))
    vol[2:, :, :] = 1.0
    grid = interop.grid_from(VoxelGrid(dims=(4, 5, 6), origin=(0, 0, 0), spacing=(1, 1, 1)))
    with pytest.raises(RuntimeError, match="(?s)make -C .*failed.*No targets specified"):
        extract_isosurface(grid, vol, 0.5, backend="native")
    assert not native.available()
    # The failure is kept: every explicit call raises it, make does not rerun.
    with pytest.raises(RuntimeError, match="No targets specified"):
        native.base64_encode(b"x")
    assert not (failed_build / "build" / native.LIB_NAME).exists()


def test_unusable_build_dir_raises(failed_build, tmp_path):
    # native/build is a file: no lock can be taken there, so nothing loads,
    # and the reader falls back to Python zlib instead of failing.
    (failed_build / "build").write_text("not a directory")
    assert not native.available()
    with pytest.raises(RuntimeError, match="cannot take the build lock"):
        native.integrate_f64(None, [], None)
    payload = zlib.compress(b"abc" * 100)
    header = np.array([1, 300, 300, len(payload)], np.uint32).tobytes()
    from cudadepthmapintegration_torch.io.vtkxml import _decompress_blocks

    assert _decompress_blocks(header + payload, np.uint32) == b"abc" * 100


# Bytes of a library cut short: part of the ELF header, which dlopen refuses.
CUT = 16


def test_half_written_library_is_built_again(tmp_path, monkeypatch):
    """A library cut short (another build writing it in place) does not load:
    the loader builds a whole one into place and loads that. The cut keeps
    the ELF header's first bytes only, where ``dlopen`` refuses the file; a
    longer cut can map past the file's end and fault instead of failing."""
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src, ignore=shutil.ignore_patterns("build"))
    whole = (native.NATIVE_DIR / "build" / native.LIB_NAME).read_bytes()
    (src / "build").mkdir()
    (src / "build" / native.LIB_NAME).write_bytes(whole[:CUT])
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available()
    assert native.base64_encode(b"whole") == pybase64.b64encode(b"whole").decode()
    assert (src / "build" / native.LIB_NAME).stat().st_size > CUT
    # The private output is gone: only the library and the lock remain.
    assert sorted(p.name for p in (src / "build").iterdir()) == [".lock", native.LIB_NAME]


def test_guard_recovers_a_kept_jax_failure(tmp_path, monkeypatch):
    """The JAX loader meets a half-written library, fails to load it and
    keeps the failure; ``load_both`` clears it and loads the whole one."""
    whole = (native.NATIVE_DIR / "build" / native.LIB_NAME).read_bytes()
    cut = tmp_path / native.LIB_NAME
    cut.write_bytes(whole[:CUT])
    real_path = jax_native._LIB_PATH
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(cut))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    assert not jax_native.available()
    monkeypatch.setattr(jax_native, "_LIB_PATH", real_path)
    assert not jax_native.available()  # the failure is kept
    load_both()
    assert jax_native.available()
    data = b"recovered"
    assert jax_native.base64_encode(data) == native.base64_encode(data)
