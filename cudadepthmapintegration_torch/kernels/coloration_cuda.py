"""Coloration kernels (``csrc/coloration.cu``) and their plain versions.

A mesh's colour statistics over every view take two kernels:

* :func:`gather_colors` projects every vertex into every view and writes one
  packed word a (view, vertex) sample into a (V, N) buffer:
  ``r | g << 8 | b << 16 | 1 << 24`` when the sample is valid, 0 when it is
  not. It replaces the Pallas kernel ``_colorize_kernel`` of
  ``cudadepthmapintegration_tpu/kernels/coloration_pallas.py`` and, with a
  depth batch, the occlusion test of the JAX package's XLA ``_gather_chunk``.
  :func:`unpack_samples` gives back that package's contract, samples
  (V, N, 3) uint8 and valid (V, N) bool, with 0 in every channel of an
  invalid sample.
* :func:`color_stats` reduces a (V, N) buffer of words to the mean, the
  exact median and the count of each vertex's valid samples. It replaces the
  XLA reductions ``_batch_sum_count`` and ``_median_from_samples`` of
  ``cudadepthmapintegration_tpu/ops/coloration.py`` with the uchar
  truncation ``colorize_points`` applies after them.

Words are int32 tensors (torch has few uint32 operations); the kernels read
them as uint32, and bit 31 is never set. Colours reach the gather as one
RGBX word a texel (:func:`stage_texels`).

Dispatch: CPU tensors go to the plain PyTorch versions
(:func:`gather_colors_torch`, :func:`color_stats_torch`); CUDA tensors
launch the kernels or raise. Nothing falls back.

Both gathers compute, per (vertex, view), bit for bit alike:

* ``hom_r = ((p_r0 * x + p_r1 * y) + p_r2 * z) + p_r3`` with no fused
  multiply-add;
* ``u, v = round_half_away(h0 / h2, h1 / h2)`` with IEEE division;
* valid when ``0 <= u < w`` and ``0 <= v < h`` (view 0's size) and, only
  under ``z_test``, ``h2 > 0``. The reference has no z test. With ``depths``
  a sample is also rejected unless ``h2 > 0``, the depth ``d`` at its pixel
  is not -1 and ``h2 <= d + occlusion_tol``.
"""

from __future__ import annotations

import torch

from .integrate_cuda import round_half_away

__all__ = [
    "STATS_BYTES",
    "color_stats",
    "color_stats_torch",
    "gather_colors",
    "gather_colors_torch",
    "launches",
    "split_stats",
    "stage_texels",
    "stats_launches",
    "unpack_samples",
]

# Kernel launches by gather_colors and by color_stats since each counter
# was last set to 0.
launches = 0
stats_launches = 0

VALID_BIT = 1 << 24
# Bytes a vertex of color_stats' output: count (int32), mean and median
# (3 uint8 each).
STATS_BYTES = 10
# The statistics kernel sums a channel's samples in 32 bits.
MAX_STATS_VIEWS = ((1 << 32) - 1) // 255


def stage_texels(colors: torch.Tensor) -> torch.Tensor:
    """(V, h, w, 3) uint8 colours -> (V, h, w) int32 RGBX words, ``r | g << 8
    | b << 16``, on the colours' device: the layout the gather reads, one
    4-byte load a texel. Two device ops (a zero fill and a copy); the words
    are the little-endian view of the padded bytes."""
    if colors.dim() != 4 or colors.shape[3] != 3 or colors.dtype != torch.uint8:
        raise ValueError(
            f"colors must be (V, h, w, 3) uint8, got {tuple(colors.shape)} {colors.dtype}"
        )
    rgbx = colors.new_zeros((*colors.shape[:3], 4))
    rgbx[..., :3] = colors
    return rgbx.view(torch.int32)[..., 0]


def unpack_samples(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(V, N) words -> samples (V, N, 3) uint8 and valid (V, N) bool, with 0
    in every channel of an invalid sample."""
    samples = torch.stack([(words >> s) & 0xFF for s in (0, 8, 16)], dim=-1)
    return samples.to(torch.uint8), (words & VALID_BIT) != 0


def _check_gather_args(points, proj, texels, depths, out, view_offset):
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(points.shape)}")
    if texels.dim() != 3 or texels.dtype != torch.int32:
        raise ValueError(
            f"texels must be (V, h, w) int32 (stage_texels), got "
            f"{tuple(texels.shape)} {texels.dtype}"
        )
    n_views = texels.shape[0]
    if tuple(proj.shape) != (n_views, 3, 4):
        raise ValueError(f"proj has shape {tuple(proj.shape)}, expected {(n_views, 3, 4)}")
    if proj.dtype != points.dtype:
        raise ValueError(f"proj is {proj.dtype}, the points {points.dtype}")
    if depths is not None and (tuple(depths.shape) != tuple(texels.shape)
                               or not depths.is_floating_point()):
        raise ValueError(
            f"depths must be float {tuple(texels.shape)}, got {tuple(depths.shape)} {depths.dtype}"
        )
    if out is not None:
        if out.dim() != 2 or out.dtype != torch.int32 or out.shape[1] != points.shape[0]:
            raise ValueError(
                f"out must be (V_total, {points.shape[0]}) int32, got "
                f"{tuple(out.shape)} {out.dtype}"
            )
        if not 0 <= view_offset <= out.shape[0] - n_views:
            raise ValueError(
                f"views {view_offset}..{view_offset + n_views} do not fit the "
                f"{out.shape[0]} rows of out"
            )
    for name, t in (("proj", proj), ("texels", texels), ("depths", depths), ("out", out)):
        if t is not None and t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, the points on {points.device}")


def project_points(
    points: torch.Tensor, proj: torch.Tensor, h: int, w: int, z_test: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project (N, 3) points through (V, 3, 4) rows of ``K4 @ RT``.

    Returns the pixel index ``v * w + u`` (V, N) int64 (0 where invalid),
    the validity mask (V, N) and the homogeneous z (V, N)."""
    x, y, z = (points[None, :, c] for c in range(3))  # (1, N)
    p = proj[:, :, :, None]  # (V, 3, 4, 1)
    hom = [((p[:, r, 0] * x + p[:, r, 1] * y) + p[:, r, 2] * z) + p[:, r, 3]
           for r in range(3)]  # each (V, N)
    u = round_half_away(hom[0] / hom[2])
    v = round_half_away(hom[1] / hom[2])
    valid = (u >= 0) & (v >= 0) & (u < w) & (v < h)
    if z_test:
        valid &= hom[2] > 0
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    ui = torch.where(valid, u, zero).to(torch.int64)
    vi = torch.where(valid, v, zero).to(torch.int64)
    return vi * w + ui, valid, hom[2]


def _rows(points, n_views, out, view_offset):
    """The (V, N) rows of ``out`` this call writes, or a fresh buffer."""
    if out is None:
        return torch.empty((n_views, points.shape[0]), dtype=torch.int32, device=points.device)
    return out[view_offset : view_offset + n_views]


def gather_colors_torch(
    points: torch.Tensor,
    proj: torch.Tensor,
    texels: torch.Tensor,
    z_test: bool = False,
    depths: torch.Tensor | None = None,
    occlusion_tol: float = 0.0,
    out: torch.Tensor | None = None,
    view_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel, any float dtype and device.

    ``points`` (N, 3), ``proj`` (V, 3, 4) rows of ``K4 @ RT``, ``texels``
    (V, h, w) int32 from :func:`stage_texels`; ``depths`` (V, h, w) turns on
    the occlusion test with ``occlusion_tol`` (in the points' dtype). Writes
    the (V, N) int32 words into rows ``view_offset ..`` of ``out`` (a
    (V_total, N) int32 buffer), or into a fresh buffer, and returns them."""
    _check_gather_args(points, proj, texels, depths, out, view_offset)
    n_views, h, w = texels.shape
    idx, valid, z = project_points(points, proj, h, w, z_test)
    if depths is not None:
        d = torch.take_along_dim(depths.reshape(n_views, h * w), idx, dim=1).to(z.dtype)
        tol = torch.tensor(occlusion_tol, dtype=z.dtype, device=z.device)
        valid &= (z > 0) & (d != -1.0) & (z <= d + tol)
    texel = torch.take_along_dim(texels.reshape(n_views, h * w), idx, dim=1)
    rows = _rows(points, n_views, out, view_offset)
    torch.mul(texel | VALID_BIT, valid, out=rows)
    return rows


def gather_colors(
    points: torch.Tensor,
    proj: torch.Tensor,
    texels: torch.Tensor,
    z_test: bool = False,
    depths: torch.Tensor | None = None,
    occlusion_tol: float = 0.0,
    out: torch.Tensor | None = None,
    view_offset: int = 0,
) -> torch.Tensor:
    """The (V, N) int32 sample words of every (view, vertex), written into
    rows ``view_offset ..`` of ``out`` or into a fresh buffer.

    CPU tensors run :func:`gather_colors_torch`. CUDA tensors launch the
    gather kernel of ``csrc/coloration.cu`` on the current stream and count
    it in :data:`launches`; points, proj and depths must be float32, and
    every input contiguous and on one device."""
    global launches
    if points.device.type == "cpu":
        return gather_colors_torch(points, proj, texels, z_test, depths, occlusion_tol,
                                   out, view_offset)
    if points.device.type != "cuda":
        raise ValueError(f"no coloration kernel for device {points.device}")
    _check_gather_args(points, proj, texels, depths, out, view_offset)
    for name, t in (("points", points), ("proj", proj), ("depths", depths)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"the coloration kernel takes float32 {name}, got {t.dtype}")
    for name, t in (("points", points), ("proj", proj), ("texels", texels),
                    ("depths", depths), ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"the coloration kernel needs a contiguous {name}")
    n_views, h, w = texels.shape
    if h * w >= 1 << 31:
        raise ValueError(f"colour images of {h}x{w} exceed the kernel's 2^31 pixels")
    n = points.shape[0]
    rows = _rows(points, n_views, out, view_offset)
    from ._build import check, load_library

    lib = load_library()
    dev = points.device.index  # always set on a CUDA tensor
    # The library sets the device it launches on; the guard restores the
    # caller's current device afterwards.
    with torch.cuda.device(dev):
        err = lib.cdmi_gather_colors(
            points.data_ptr(), proj.data_ptr(), texels.data_ptr(),
            None if depths is None else depths.data_ptr(), rows.data_ptr(),
            n, n_views, h, w, int(z_test), float(occlusion_tol),
            dev, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "cdmi_gather_colors")
    launches += 1
    return rows


def split_stats(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views of a (STATS_BYTES * N,) uint8 statistics buffer: mean (N, 3)
    uint8, median (N, 3) uint8, count (N,) int32. The buffer holds the
    counts first, so a host copy of it splits the same way."""
    n = buf.shape[0] // STATS_BYTES
    if buf.dtype != torch.uint8 or buf.shape != (STATS_BYTES * n,):
        raise ValueError(f"a statistics buffer is (10 N,) uint8, got {tuple(buf.shape)} {buf.dtype}")
    count = buf[: 4 * n].view(torch.int32)
    return buf[4 * n : 7 * n].view(n, 3), buf[7 * n :].view(n, 3), count


def _check_words(words):
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError(f"words must be (V, N) int32, got {tuple(words.shape)} {words.dtype}")


def _median_from_samples(samples: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked median over the view axis: samples (V, N, 3) uint8,
    valid (V, N) bool -> median (N, 3) float32.

    Invalid -> +inf, sort ascending over views, then the two middle *valid*
    entries are at (count-1)//2 and count//2 (Helper.h:174-187)."""
    count = valid.sum(dim=0)
    big = torch.where(valid[..., None], samples.to(torch.float32), torch.inf)
    srt = torch.sort(big, dim=0).values  # (V, N, 3)
    lo = torch.clamp((count - 1) // 2, min=0)
    hi = count // 2

    def take(i):
        return torch.gather(srt, 0, i[None, :, None].expand(1, -1, 3))[0]

    med = 0.5 * (take(lo) + take(hi))
    return torch.where(count[:, None] > 0, med, 0.0)


def color_stats_torch(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the statistics kernel, on any device: the
    sort-based median, int64 sums and a float64 mean, each truncated to
    uchar as the reference's vtk arrays do (``MeshColoration.cxx:180,185``).

    ``words`` (V, N) int32 -> a (STATS_BYTES * N,) uint8 buffer
    (:func:`split_stats`)."""
    _check_words(words)
    samples, valid = unpack_samples(words)
    cnt = valid.sum(dim=0)
    sums = (samples.to(torch.int64) * valid[..., None]).sum(dim=0)
    buf = torch.empty((STATS_BYTES * words.shape[1],), dtype=torch.uint8, device=words.device)
    mean, median, count = split_stats(buf)
    mean.copy_((sums / cnt.clamp(min=1)[:, None].to(torch.float64)).clamp(0, 255))
    median.copy_(_median_from_samples(samples, valid).clamp(0, 255))
    count.copy_(cnt)
    return buf


def color_stats(words: torch.Tensor) -> torch.Tensor:
    """Mean, exact median and count of each vertex's valid samples, over the
    V rows of a (V, N) int32 word buffer, as one (STATS_BYTES * N,) uint8
    buffer (:func:`split_stats`), so that one copy brings all three to the
    host.

    CPU tensors run :func:`color_stats_torch`. A CUDA buffer launches the
    statistics kernel of ``csrc/coloration.cu`` on the current stream and
    counts it in :data:`stats_launches`; its rows may lie apart (a column
    slice of a wider buffer) but each row must be contiguous, and V is at
    most ``MAX_STATS_VIEWS``."""
    global stats_launches
    if words.device.type == "cpu":
        return color_stats_torch(words)
    if words.device.type != "cuda":
        raise ValueError(f"no coloration kernel for device {words.device}")
    _check_words(words)
    n_views, n = words.shape
    if n_views > MAX_STATS_VIEWS:
        raise ValueError(f"{n_views} views exceed the statistics kernel's {MAX_STATS_VIEWS}")
    if n > 1 and words.stride(1) != 1:
        raise ValueError("the statistics kernel needs each row of words contiguous")
    ld = words.stride(0) if n_views > 1 else n
    if ld < n or ld >= 1 << 31:
        raise ValueError(f"rows of words {ld} apart do not fit the kernel")
    buf = torch.empty((STATS_BYTES * n,), dtype=torch.uint8, device=words.device)
    mean, median, count = split_stats(buf)
    from ._build import check, load_library

    lib = load_library()
    dev = words.device.index
    with torch.cuda.device(dev):
        err = lib.cdmi_color_stats(
            words.data_ptr(), ld, mean.data_ptr(), median.data_ptr(), count.data_ptr(),
            n, n_views, dev, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "cdmi_color_stats")
    stats_launches += 1
    return buf
