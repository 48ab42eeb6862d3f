"""The sparse fuse kernels' plain versions against the JAX package, on the CPU.

``kernels/sparse_cuda.py``'s ``sparse_fuse_torch`` and
``sparse_accumulate_color_torch`` are what the CUDA kernels of
``csrc/sparse_fuse.cu`` are held to, bit for bit, on the card
(``chip_smoke.py`` phase ``sparse_kernel``). Here they are held against the
JAX package's ``_sparse_integrate`` and ``_sparse_accumulate_color``
(``ops/sparse_grid.py``), run with its XLA gather and with its Pallas point
gather in interpreter mode, on the same inputs made with numpy: blocks in
front of the camera, across its plane, behind it and off the image, in the
library's 8^3 blocks (the row kernel's shape) and in (4, 6, 5) blocks (the
general kernel's). Tolerances, and why (those of tests/test_torch_sparse.py):

* ``pool`` within **2e-5** on all but **2e-4** of the voxels. The allowance
  is for pixel flips: XLA on the CPU contracts the lattice's multiply-adds
  into fused multiply-adds and the port does not, so a voxel projecting onto
  a half-pixel boundary may read a neighbouring pixel;
* ``weight_pool`` within **2e-5** and ``color_pool`` within **5e-3**: the JAX
  package's own cross-program tolerances (tests/test_gather_points.py);
* pools of -0.0 by **bit pattern**: every voxel of a touched block adds its
  potential or +0.0, and -0.0 + 0.0 is +0.0, so neither package leaves a
  -0.0 word in a touched block, and an invalid sample leaves +0.0 in both.

The wrapper's choice of kernel by block shape and its refusals of what the
kernels do not take are pure Python and tested here too.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.core.camera import compose_projection
from cudadepthmapintegration_torch.kernels import sparse_cuda as sc
from cudadepthmapintegration_torch.kernels._build import CSRC
from cudadepthmapintegration_torch.testing import look_at_camera
from cudadepthmapintegration_tpu.core import RayPotential
from cudadepthmapintegration_tpu.ops.sparse_grid import (
    _sparse_accumulate_color,
    _sparse_integrate,
)

KP.INTERPRET = True

PARAMS = RayPotential(thick=0.06, rho=0.8, eta=0.03, delta=0.2)
T_PARAMS = interop.params_from(PARAMS)
VOXEL = 0.1
BAND = max(PARAMS.delta, VOXEL)  # SparseTSDFGrid.color_band
W, H = 64, 48
EYE = (0.3, -2.0, 0.4)
FLIP_ALLOWANCE = 2e-4
NEG_ZERO = -(1 << 31)  # the int32 bits of -0.0


def frame(block_shape, seed=0):
    """One frame's inputs as numpy arrays, in the sparse path's layout.

    Blocks (x, y, z coordinates in block units): a cube of 8 around the
    target, 8 around the camera (across its plane and behind it) and 2 far
    to the side (off the image), at shuffled slots of a pool with spare
    slots; pools of random values; a depth map around the target's distance
    with -1 holes; a random RGB image."""
    rng = np.random.default_rng(seed)
    bz, by, bx = block_shape
    extent = np.array([bx, by, bz], np.float64) * VOXEL
    eye_block = np.floor(np.asarray(EYE) / extent).astype(np.int64)
    coords = [(x, y, z) for x in (-1, 0) for y in (-1, 0) for z in (-1, 0)]
    coords += [tuple(int(c) for c in eye_block + (dx, dy, dz))
               for dx in (0, 1) for dy in (-1, 0) for dz in (0, 1)]
    coords += [(int(8 / extent[0]), 0, 0), (-int(8 / extent[0]), 1, 0)]
    n = len(coords)
    capacity = n + 5
    slots = rng.permutation(capacity)[:n].astype(np.int32)
    origins = (np.array(coords, np.float64) * extent).astype(np.float32)
    cam = look_at_camera(EYE, (0.0, 0.0, 0.0), focal=50.0, width=W, height=H)
    p, cam_row = compose_projection(cam, None)
    proj_rows = np.vstack([p[:3, :], cam_row[None, :]]).astype(np.float32)
    axes = np.zeros((3, max(block_shape)), np.float32)
    for a, m in enumerate((bx, by, bz)):
        axes[a, :m] = (np.arange(m) + 0.5) * VOXEL
    depth = rng.uniform(1.4, 2.6, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = -1.0
    return dict(
        pool=rng.standard_normal((capacity, *block_shape)).astype(np.float32),
        color_pool=rng.uniform(0, 300, (capacity, *block_shape, 3)).astype(np.float32),
        weight_pool=rng.uniform(0, 2, (capacity, *block_shape)).astype(np.float32),
        slots=slots, origins=origins, proj_rows=proj_rows, axes=axes, depth=depth,
        rgb=rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
    )


def run_port(f):
    """The port's plain versions; returns the three pools as numpy."""
    t = {k: torch.from_numpy(v.copy()) for k, v in f.items()}
    args = (t["slots"], t["origins"], t["proj_rows"], t["axes"], t["depth"])
    sc.sparse_fuse_torch(t["pool"], *args, T_PARAMS)
    sc.sparse_accumulate_color_torch(t["color_pool"], t["weight_pool"], *args, t["rgb"], BAND)
    return {k: t[k].numpy() for k in ("pool", "color_pool", "weight_pool")}


def run_jax(f, use_pallas):
    """The JAX package's per-frame device work; returns the pools as numpy."""
    j = {k: jnp.asarray(v) for k, v in f.items() if k != "rgb"}
    common = (j["slots"], j["proj_rows"], j["origins"], j["axes"], j["depth"])
    pool = _sparse_integrate(j["pool"], *common, h=H, w=W, thick=PARAMS.thick, rho=PARAMS.rho,
                             eta=PARAMS.eta, delta=PARAMS.delta, use_pallas=use_pallas)
    color, weight = _sparse_accumulate_color(
        j["color_pool"], j["weight_pool"], *common, jnp.asarray(f["rgb"].astype(np.float32)),
        h=H, w=W, band=BAND, use_pallas=use_pallas)
    return {k: np.asarray(v) for k, v in
            (("pool", pool), ("color_pool", color), ("weight_pool", weight))}


def geometry(f, block_shape):
    """Per voxel of the touched blocks (the port's projection): valid
    sample (in the image and in front, with a depth), and behind the
    camera."""
    t = {k: torch.from_numpy(f[k]) for k in ("origins", "proj_rows", "axes", "depth")}
    ui, vi, zcam = sc._project(t["origins"], t["proj_rows"], t["axes"], block_shape, H, W)
    (d,) = sc.gather_pixels_torch((t["depth"],), ui.reshape(-1), vi.reshape(-1))
    valid = (ui.reshape(-1) >= 0) & (d != -1.0)
    return valid.reshape(ui.shape).numpy(), (zcam < 0).numpy(), (ui >= 0).numpy()


BLOCK_SHAPES = [(8, 8, 8), (4, 6, 5)]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("block_shape", BLOCK_SHAPES, ids=["8x8x8", "4x6x5"])
def test_plain_versions_match_jax(block_shape, use_pallas):
    f = frame(block_shape)
    got, exp = run_port(f), run_jax(f, use_pallas)
    valid, behind, in_image = geometry(f, block_shape)
    # The frame has every kind of voxel: valid, behind the camera, in front
    # but off the image, and in the image on a hole of the depth map.
    assert valid.any() and behind.any() and (~behind & ~in_image).any()
    assert (in_image & ~valid).any()
    err = np.abs(got["pool"] - exp["pool"])
    assert (err > 2e-5).mean() <= FLIP_ALLOWANCE
    np.testing.assert_allclose(got["weight_pool"], exp["weight_pool"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["color_pool"], exp["color_pool"], rtol=0, atol=5e-3)
    # The frame changed the touched blocks and nothing else.
    touched = np.zeros(len(f["pool"]), bool)
    touched[f["slots"]] = True
    assert (got["pool"][touched] != f["pool"][touched]).any()
    for k in ("pool", "color_pool", "weight_pool"):
        np.testing.assert_array_equal(got[k][~touched], f[k][~touched])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("block_shape", BLOCK_SHAPES, ids=["8x8x8", "4x6x5"])
def test_negative_zero_pools_leave_positive_zero(block_shape, use_pallas):
    f = frame(block_shape, seed=1)
    for k in ("pool", "color_pool", "weight_pool"):
        f[k] = np.full_like(f[k], -0.0)
    got, exp = run_port(f), run_jax(f, use_pallas)
    valid = geometry(f, block_shape)[0]
    for out in (got, exp):
        for k in ("pool", "color_pool", "weight_pool"):
            bits = out[k][f["slots"]].view(np.int32)
            assert not (bits == NEG_ZERO).any(), k
        # An invalid sample adds +0.0 into every pool: the word is +0.0.
        assert (out["pool"][f["slots"]][~valid].view(np.int32) == 0).all()
        assert (out["weight_pool"][f["slots"]][~valid].view(np.int32) == 0).all()
        assert (out["color_pool"][f["slots"]][~valid].view(np.int32) == 0).all()
        # Untouched slots keep their -0.0.
        untouched = np.setdiff1d(np.arange(len(f["pool"])), f["slots"])
        assert (out["pool"][untouched].view(np.int32) == NEG_ZERO).all()
    assert valid.any() and (~valid).any()


@pytest.mark.parametrize("block_shape,kind", [
    ((8, 8, 8), "rows"), ((4, 6, 5), "general"), ((8, 8, 4), "general"),
    ((4, 8, 8), "general"), ((16, 16, 16), "general"),
])
def test_kernel_is_chosen_by_block_shape(block_shape, kind):
    assert sc.kernel_for(block_shape) == kind
    assert sc.kernel_for(list(block_shape)) == kind


@pytest.mark.parametrize("instance", ["", "COLOR_"], ids=["depth", "colour"])
def test_row_kernel_launch_shape_fits_a_cta(instance):
    """The build-time shapes of the row kernel's two instances: voxels a
    thread divide an x-row of 8, and a CTA of blocks x 512 / voxels threads
    is at most 1,024 (the source's static_asserts, checked before any
    build)."""
    text = (CSRC / "sparse_fuse.cu").read_text()
    shape = {k: int(v) for k, v in re.findall(r"#define CDMI_SPARSE_(\w+) (\d+)", text)}
    assert set(shape) == {"VX", "BLOCKS", "COLOR_VX", "COLOR_BLOCKS"}
    vx, blocks = shape[f"{instance}VX"], shape[f"{instance}BLOCKS"]
    assert sc.ROW_BLOCK[2] % vx == 0
    assert blocks * 512 // vx <= 1024


def kernel_args(block_shape=(8, 8, 8)):
    """Arguments of ``_check_args`` as the kernels take them (CPU tensors)."""
    f = frame(block_shape)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    color = (t["color_pool"], t["weight_pool"], t["rgb"])
    return [t["pool"], t["slots"], t["origins"], t["proj_rows"], t["axes"], t["depth"], color]


def misaligned(x):
    """``x``'s values in a tensor whose data sits 4 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(x.numel() + 4, dtype=x.dtype)
    off = (-(flat.data_ptr() // 4) + 1) % 4
    out = flat[off : off + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4
    return out


REFUSALS = {
    "float64 pool": (0, lambda a: a.double(), "takes pool as torch.float32"),
    "int64 slots": (1, lambda a: a.long(), "takes slots as torch.int32"),
    "float64 origins": (2, lambda a: a.double(), "takes origins as torch.float32"),
    "non-contiguous depth": (5, lambda a: torch.cat([a, a], 1)[:, ::2],
                             "needs a contiguous depth"),
    "non-contiguous color_pool": (6, lambda c: (c[0].transpose(1, 2), *c[1:]), "color_pool"),
    "float32 rgb": (6, lambda c: (*c[:2], c[2].float()), "uint8"),
    "misaligned pool": (0, misaligned, "pool aligned to 16 bytes"),
    "misaligned weight_pool": (6, lambda c: (c[0], misaligned(c[1]), c[2]),
                               "weight_pool aligned to 16 bytes"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_kernel_arguments_are_refused(case):
    index, change, message = REFUSALS[case]
    args = kernel_args()
    args[index] = change(args[index])
    with pytest.raises(ValueError, match=re.escape(message)):
        sc._check_args(*args, for_kernel=True)


def test_kernel_arguments_accepted():
    names = sc._check_args(*kernel_args(), for_kernel=True)
    assert set(names) == {"pool", "slots", "origins", "proj_rows", "axes", "depth",
                          "color_pool", "weight_pool", "rgb"}
    # The general kernel reads words one at a time: any alignment will do.
    args = kernel_args((4, 6, 5))
    args[0] = misaligned(args[0])
    sc._check_args(*args, for_kernel=True)
    # The plain versions take what the kernels refuse.
    args = kernel_args()
    args[0] = args[0].double()
    sc._check_args(*args)
