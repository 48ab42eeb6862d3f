"""The sparse fuse kernels' plain versions against the JAX package, on the CPU.

``kernels/sparse_cuda.py``'s ``sparse_fuse_torch`` and
``sparse_accumulate_color_torch`` are what the CUDA kernels of
``csrc/sparse_fuse.cu`` are held to, bit for bit, on the card
(``chip_smoke.py`` phase ``sparse_kernel``). Here they are held against the
JAX package's ``_sparse_integrate`` and ``_sparse_accumulate_color``
(``ops/sparse_grid.py``), run with its XLA gather and with its Pallas point
gather in interpreter mode, on the same inputs made with numpy: blocks in
front of the camera, across its plane, behind it and off the image, in the
library's 8^3 blocks (the row kernel's shape) and in blocks of (4, 6, 5),
4^3, 16^3 and (3, 5, 7) (the general kernel's; the last is a shape whose
voxels do not come in whole 16-byte vectors). Tolerances, and why (those of
tests/test_torch_sparse.py):

* ``pool`` within **2e-5** on all but **2e-4** of the voxels. The allowance
  is for pixel flips: XLA on the CPU contracts the lattice's multiply-adds
  into fused multiply-adds and the port does not, so a voxel projecting onto
  a half-pixel boundary may read a neighbouring pixel;
* ``weight_pool`` within **2e-5** and ``color_pool`` within **5e-3**: the JAX
  package's own cross-program tolerances (tests/test_gather_points.py);
* pools of -0.0 by **bit pattern**: every voxel of a touched block adds its
  potential or +0.0, and -0.0 + 0.0 is +0.0, so neither package leaves a
  -0.0 word in a touched block, and an invalid sample leaves +0.0 in both.

The general kernel's order of evaluation (products formed once, each
thread's voxels found by multiply-high divisions and steps, the row sums in
the plain version's order) is emulated in float32 and held to the plain
versions bit for bit. The wrapper's choice of kernel by block shape and its
refusals of what the kernels do not take are pure Python and tested here
too.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.core.camera import compose_projection
from cudadepthmapintegration_torch.core.ray_potential import ray_potential_torch
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


BLOCK_SHAPES = [(8, 8, 8), (4, 6, 5), (4, 4, 4), (16, 16, 16), (3, 5, 7)]
SHAPE_IDS = ["x".join(map(str, b)) for b in BLOCK_SHAPES]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("block_shape", BLOCK_SHAPES, ids=SHAPE_IDS)
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
@pytest.mark.parametrize("block_shape", BLOCK_SHAPES, ids=SHAPE_IDS)
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
    shape = source_shape("SPARSE")
    assert set(shape) == {"VX", "BLOCKS", "COLOR_VX", "COLOR_BLOCKS"}
    vx, blocks = shape[f"{instance}VX"], shape[f"{instance}BLOCKS"]
    assert sc.ROW_BLOCK[2] % vx == 0
    assert blocks * 512 // vx <= 1024


def source_shape(prefix):
    """The ``#define CDMI_<prefix>_*`` launch shapes of csrc/sparse_fuse.cu,
    by the rest of their names (``CDMI_SPARSE_GEN_*`` apart from
    ``CDMI_SPARSE_*``)."""
    text = (CSRC / "sparse_fuse.cu").read_text()
    pattern = rf"#define CDMI_{prefix}_(?!GEN_)(\w+) (\d+)"
    return {k: int(v) for k, v in re.findall(pattern, text)}


@pytest.mark.parametrize("instance", ["", "COLOR_"], ids=["depth", "colour"])
def test_general_kernel_launch_shape_fits_a_cta(instance):
    """The general kernel's build-time shapes: whole warps, at most 512
    threads a CTA (the source's static_assert), and the CTA's shared memory
    (the products of blocks whose edges sum to ``MAX_EDGE_SUM``, a float4
    and a slot for each of up to THREADS blocks) within the 48 KB a launch
    gets without opting in."""
    shape = source_shape("SPARSE_GEN")
    assert set(shape) == {"VX", "THREADS", "COLOR_VX", "COLOR_THREADS"}
    vx, threads = shape[f"{instance}VX"], shape[f"{instance}THREADS"]
    assert vx >= 1 and threads % 32 == 0 and threads <= 512
    assert 16 * sc.MAX_EDGE_SUM + 20 * threads <= 48 << 10
    text = (CSRC / "sparse_fuse.cu").read_text()
    assert f"constexpr int kMaxEdgeSum = {sc.MAX_EDGE_SUM};" in text


def divide(n, d):
    """The general kernel's ``divide``: the high half of ``n * m``, ``m =
    floor((2^64 - 1) / d) + 1``, and ``n`` itself for ``d == 1``."""
    return n if d == 1 else (n * ((2**64 - 1) // d + 1)) >> 64


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 15, 30, 105, 256, 1023, 2047, 4096, 65537,
                               (1 << 31) - 1])
def test_multiply_high_division_is_exact(d):
    """Exact for every 32-bit ``n``: checked at 0, at each side of every
    multiple of ``d`` up to 2^16 and at the multiples nearest 2^31 and
    2^32."""
    qs = list(range(1 << 16)) + [((1 << 31) // d) + e for e in (-1, 0, 1)] + [
        ((1 << 32) - 1) // d + e for e in (-1, 0)]
    for q in qs:
        for n in (q * d - 1, q * d, q * d + d - 1):
            if 0 <= n < 1 << 32:
                assert divide(n, d) == n // d, (n, d)


def general_kernel_order(f, vx, threads, colour):
    """The general kernel of csrc/sparse_fuse.cu at ``vx`` voxels a thread
    and ``threads`` a CTA, step by step in float32 on the CPU: the products
    P[r,c] * axes[c,n] and each block's base_r formed once; the threads'
    blocks and first voxels by ``divide``, the next voxels by steps of i
    carried into j and k; h_r = ((base_r + z term) + y term) + x term.
    Returns the pools it leaves (``pool``, or with ``colour`` the colour
    and weight pools)."""
    t = {k: torch.from_numpy(v.copy()) for k, v in f.items()}
    bz, by, bx = t["pool"].shape[1:]
    nvox = bz * by * bx
    p = t["proj_rows"]
    prod = [p[:, c][None, :] * t["axes"][c, :n][:, None] for c, n in enumerate((bx, by, bz))]
    o = t["origins"]
    base = ((p[:, 0] * o[:, :1] + p[:, 1] * o[:, 1:2]) + p[:, 2] * o[:, 2:]) + p[:, 3]
    per_block = -(-nvox // vx)
    n_threads = len(f["slots"]) * per_block
    blocks, flat, ijk = [], [], []
    for cta in range(-(-n_threads // threads)):
        g0 = cta * threads
        b_lo = divide(g0, per_block)
        nb = divide(min(g0 + threads, n_threads) - 1, per_block) - b_lo + 1
        assert nb <= threads  # the CTA's blocks fit s_base and s_slot
        for g in range(g0, min(g0 + threads, n_threads)):
            b = divide(g, per_block)
            assert 0 <= b - b_lo < nb
            f0 = (g - b * per_block) * vx
            kj = divide(f0, bx)
            i, k = f0 - kj * bx, divide(kj, by)
            j = kj - k * by
            for v in range(vx):
                if f0 + v < nvox:
                    blocks.append(b)
                    flat.append(f0 + v)
                    ijk.append((i, j, k))
                i += 1
                if i == bx:
                    i, j = 0, j + 1
                    if j == by:
                        j, k = 0, k + 1
    blocks, flat = torch.tensor(blocks), torch.tensor(flat)
    i, j, k = torch.tensor(ijk).T
    # Every voxel of every block once, each at its own (i, j, k).
    assert sorted(zip(blocks.tolist(), flat.tolist())) == [
        (b, x) for b in range(len(f["slots"])) for x in range(nvox)]
    assert torch.equal((k * by + j) * bx + i, flat)
    h = ((base[blocks] + prod[2][k]) + prod[1][j]) + prod[0][i]
    h0, h1, h2, zc = h.T
    u = sc.round_half_away(h0 / h2)
    vv = sc.round_half_away(h1 / h2)
    valid = (h2 >= 0) & (u >= 0) & (vv >= 0) & (u < W) & (vv < H)
    pix = torch.where(valid, vv * W + u, 0.0).long()
    d = torch.where(valid, t["depth"].reshape(-1)[pix], -1.0)
    near = valid & (d != -1.0)
    word = t["slots"].long()[blocks] * nvox + flat
    zero = torch.zeros(())
    if not colour:
        pool = t["pool"].reshape(-1)
        pool[word] = pool[word] + torch.where(near, ray_potential_torch(zc, d, T_PARAMS), zero)
        return {"pool": t["pool"].numpy()}
    band = torch.tensor(BAND, dtype=torch.float32)
    wadd = torch.where(near, torch.clamp_min(1.0 - torch.abs(zc - d) / band, 0.0), zero)
    rgb = torch.where(valid[:, None], t["rgb"].reshape(-1, 3)[pix].float(), zero)
    cp, wp = t["color_pool"].reshape(-1, 3), t["weight_pool"].reshape(-1)
    cp[word] = cp[word] + rgb * wadd[:, None]
    wp[word] = wp[word] + wadd
    return {"color_pool": t["color_pool"].numpy(), "weight_pool": t["weight_pool"].numpy()}


# The general kernel's order on the test shapes and on shapes whose last
# thread of a block holds fewer than VX voxels, down to a voxel a block.
ORDER_SHAPES = [*BLOCK_SHAPES, (1, 4, 5), (2, 2, 2), (3, 3, 3), (1, 1, 1), (1, 1, 9)]


@pytest.mark.parametrize("pools", ["random", "neg_zero"])
@pytest.mark.parametrize("block_shape", ORDER_SHAPES,
                         ids=["x".join(map(str, b)) for b in ORDER_SHAPES])
def test_general_kernel_order_bitwise(block_shape, pools):
    """The general kernel's evaluation order at the built launch shapes
    of both instances equals the plain versions bit for bit, from random
    pools and from pools of -0.0."""
    f = frame(block_shape, seed=2)
    if pools == "neg_zero":
        for k in ("pool", "color_pool", "weight_pool"):
            f[k] = np.full_like(f[k], -0.0)
    shape = source_shape("SPARSE_GEN")
    got = general_kernel_order(f, shape["VX"], shape["THREADS"], colour=False)
    got.update(general_kernel_order(f, shape["COLOR_VX"], shape["COLOR_THREADS"], colour=True))
    exp = run_port(f)
    for k in ("pool", "color_pool", "weight_pool"):
        np.testing.assert_array_equal(got[k].view(np.int32), exp[k].view(np.int32), err_msg=k)
    assert not (got["pool"] == f["pool"]).all()


@pytest.mark.parametrize("vx,threads", [(1, 128), (2, 32), (3, 64), (8, 512), (16, 96)])
def test_general_kernel_order_at_other_launch_shapes(vx, threads):
    """The order holds at the sweep's other shapes too, on blocks whose
    voxels do not fill a thread's last vector."""
    f = frame((3, 5, 7), seed=3)
    got = general_kernel_order(f, vx, threads, colour=False)
    got.update(general_kernel_order(f, vx, threads, colour=True))
    exp = run_port(f)
    for k in ("pool", "color_pool", "weight_pool"):
        np.testing.assert_array_equal(got[k].view(np.int32), exp[k].view(np.int32), err_msg=k)


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
# What the general kernel refuses besides: misaligned pools, at a shape
# whose words move as vectors and at one whose words move one at a time.
GENERAL_REFUSALS = {
    "misaligned pool": (0, misaligned, "pool aligned to 16 bytes"),
    "misaligned color_pool": (6, lambda c: (misaligned(c[0]), *c[1:]),
                              "color_pool aligned to 16 bytes"),
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


@pytest.mark.parametrize("block_shape", [(4, 6, 5), (3, 5, 7)], ids=["4x6x5", "3x5x7"])
@pytest.mark.parametrize("case", sorted(GENERAL_REFUSALS))
def test_general_kernel_refuses_misaligned_pools(case, block_shape):
    index, change, message = GENERAL_REFUSALS[case]
    args = kernel_args(block_shape)
    args[index] = change(args[index])
    with pytest.raises(ValueError, match=re.escape(message)):
        sc._check_args(*args, for_kernel=True)
    # The plain versions take any alignment.
    sc._check_args(*args)


def test_general_kernel_refuses_what_it_cannot_index():
    """Blocks whose edges sum past ``MAX_EDGE_SUM`` (the products in
    shared memory), and a call of 2^31 voxels or more."""
    wide = sc.MAX_EDGE_SUM - 2
    args = [torch.zeros((1, 1, 1, wide)), torch.zeros(1, dtype=torch.int32), torch.zeros(1, 3),
            torch.zeros(4, 4), torch.zeros(3, wide), torch.zeros(2, 2), None]
    sc._check_args(*args, for_kernel=True)
    args[0] = torch.zeros((1, 1, 2, wide))
    with pytest.raises(ValueError, match="edges sum to at most 2048"):
        sc._check_args(*args, for_kernel=True)
    n = (1 << 31) // 4096
    args = [torch.zeros((1, 16, 16, 16)), torch.zeros(n - 1, dtype=torch.int32),
            torch.zeros(n - 1, 3), torch.zeros(4, 4), torch.zeros(3, 16), torch.zeros(2, 2), None]
    sc._check_args(*args, for_kernel=True)
    args[1:3] = torch.zeros(n, dtype=torch.int32), torch.zeros(n, 3)
    with pytest.raises(ValueError, match="fewer than 2\\^31 voxels a call"):
        sc._check_args(*args, for_kernel=True)


def test_kernel_arguments_accepted():
    names = sc._check_args(*kernel_args(), for_kernel=True)
    assert set(names) == {"pool", "slots", "origins", "proj_rows", "axes", "depth",
                          "color_pool", "weight_pool", "rgb"}
    # The general kernel takes the same arguments at any other block shape.
    for block_shape in ((4, 6, 5), (4, 4, 4), (16, 16, 16), (3, 5, 7)):
        sc._check_args(*kernel_args(block_shape), for_kernel=True)
    # The plain versions take what the kernels refuse.
    args = kernel_args()
    args[0] = args[0].double()
    sc._check_args(*args)
