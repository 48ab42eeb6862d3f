"""The port's readers and writers against the JAX package's.

Tolerance: none. Both packages hold the same numpy code for every format,
so each writer must give the same bytes on the same inputs and each reader
the same arrays from the same file, including the vendored VTK goldens.
"""

import os

import numpy as np
import pytest

from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch import io as tio
from cudadepthmapintegration_torch.io.vti import ImageData as TImageData
from cudadepthmapintegration_torch.io.vti import write_vti as t_write_vti
from cudadepthmapintegration_tpu import io as jio
from cudadepthmapintegration_tpu.io.vti import ImageData as JImageData
from cudadepthmapintegration_tpu.io.vti import write_vti as j_write_vti
from cudadepthmapintegration_tpu.testing import sphere_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _mesh(pkg):
    rng = np.random.default_rng(0)
    m = pkg.PolyData(rng.standard_normal((40, 3)), rng.integers(0, 40, (25, 3)))
    m.point_data["Normals"] = rng.standard_normal((40, 3)).astype(np.float32)
    m.point_data["MeanColoration"] = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    m.point_data["NbProjectedDepthMap"] = rng.integers(0, 9, 40).astype(np.int32)
    m.point_data["reconstruction_scalar"] = np.full(40, 1.0)
    m.active_scalars = "reconstruction_scalar"
    return m


def _write_vtp(pkg, path, compress):
    pkg.write_vtp(path, _mesh(pkg), compress=compress)


def _write_vts(pkg, path, compress):
    rng = np.random.default_rng(1)
    pkg.write_vts(
        path, rng.standard_normal((4, 5, 6, 3)),
        point_arrays={"p": rng.standard_normal(120)},
        cell_arrays={"reconstruction_scalar": rng.standard_normal(60)},
        compress=compress,
    )


def _write_mha(pkg, path, compress):
    vol = np.random.default_rng(2).standard_normal((5, 6, 7))
    pkg.write_mha(path, vol, origin=(-1.0, 0.5, 2.0), spacing=(0.1, 0.2, 0.3),
                  compress=compress)


def _write_depth_vti(pkg, path, compress):
    view = sphere_scene(n_views=1, width=24, height=16)[0]
    pkg.write_depth_map_vti(path, view.depth, view.color, view.best_cost,
                            compress=compress)


def _write_vti(pkg, path, compress):
    rng = np.random.default_rng(3)
    image_cls = TImageData if pkg is tio else JImageData
    write = t_write_vti if pkg is tio else j_write_vti
    img = image_cls((6, 4, 1), origin=(0.5, -1.0, 0.0), spacing=(0.5, 2.0, 1.0))
    img.point_data["Depths"] = rng.standard_normal(24)
    img.point_data["Color"] = rng.integers(0, 256, (24, 3), dtype=np.uint8)
    write(path, img, compress=compress)


def _write_krtd(pkg, path, compress):
    del compress
    cam = sphere_scene(n_views=2)[1].camera
    pkg.write_krtd(path, cam if pkg is jio else interop.camera_from(cam))


WRITERS = {
    "vtp": _write_vtp, "vts": _write_vts, "mha": _write_mha,
    "depth.vti": _write_depth_vti, "vti": _write_vti, "krtd": _write_krtd,
}


CASES = [(fmt, c) for fmt in sorted(WRITERS) for c in (False, True)
         if not (fmt == "krtd" and c)]  # krtd is text only


@pytest.mark.parametrize("fmt,compress", CASES)
def test_writers_give_the_same_bytes(tmp_path, fmt, compress):
    jpath, tpath = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    WRITERS[fmt](jio, jpath, compress)
    WRITERS[fmt](tio, tpath, compress)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


@pytest.mark.parametrize(
    "name", sorted(n for n in os.listdir(GOLDEN) if n.endswith((".vti", ".vtp", ".mha")))
)
def test_goldens_read_back_equal(name):
    path = os.path.join(GOLDEN, name)
    ext = name.rsplit(".", 1)[-1]
    if ext == "vti":
        a, b = jio.read_vti(path), tio.read_vti(path)
        _assert_same(a.point_data, b.point_data)
        assert (a.dims, a.origin, a.spacing) == (b.dims, b.origin, b.spacing)
        da, db = jio.read_depth_map(path), tio.read_depth_map(path)
        _assert_same(da.depth, db.depth)
        _assert_same(da.color, db.color)
    elif ext == "vtp":
        a, b = jio.read_vtp(path), tio.read_vtp(path)
        _assert_same(a.points, b.points)
        _assert_same(a.triangles, b.triangles)
        _assert_same(a.point_data, b.point_data)
    elif ext == "mha":
        (va, ma), (vb, mb) = jio.read_mha(path), tio.read_mha(path)
        _assert_same(va, vb)
        assert ma == mb


def test_dataset_reads_the_same_views(tmp_path):
    views = sphere_scene(n_views=3, width=32, height=24)
    for i, v in enumerate(views):
        jio.write_depth_map_vti(str(tmp_path / f"f{i}.vti"), v.depth, v.color, v.best_cost)
        jio.write_krtd(str(tmp_path / f"f{i}.krtd"), v.camera)
    (tmp_path / "vtiList.txt").write_text("".join(f"f{i}.vti\n" for i in range(3)))
    (tmp_path / "kList.txt").write_text("".join(f"f{i}.krtd\n" for i in range(3)))
    a = jio.DepthMapDataset.from_folder(str(tmp_path))
    b = tio.DepthMapDataset.from_folder(str(tmp_path))
    assert len(a) == len(b) == 3
    for va, vb in zip(a, b):
        for attr in ("depth", "color", "best_cost"):
            _assert_same(getattr(va, attr), getattr(vb, attr))
        _assert_same(va.camera.k, vb.camera.k)
        _assert_same(va.camera.rt, vb.camera.rt)
