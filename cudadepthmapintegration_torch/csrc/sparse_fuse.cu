// Sparse TSDF update of one RGB-D frame, the pixel gather fused in. Two
// kernels, chosen by the block shape alone (kernels/sparse_cuda.py,
// kernel_for): the row kernel for the library's 8^3 blocks, the general
// kernel (VX consecutive voxels of a block a thread) for any other shape.
//
// Replaces: cudadepthmapintegration_tpu/kernels/gather_points.py,
//   gather_pixels_pallas / _gather_kernel (the windowed point gather), and
//   the device work around it in ops/sparse_grid.py: _sparse_integrate and
//   _sparse_accumulate_color (lattice projection, bounds test, ray potential,
//   colour falloff, scatter into the block pools).
//
// What bounds it on an H100: memory traffic, on paper. Each voxel reads and
//   writes its pool word (8 bytes; 32 with the colour and weight pools) and
//   makes one data-dependent read of the depth map (plus 3 bytes of colour);
//   the arithmetic is a dozen flops and two IEEE divisions (three with
//   colour). One 640x480 frame into ~5,600 blocks of 8^3 moves 24 MB (117 MB
//   with colour): 7 us (35 us) at 3.35 TB/s. In practice a voxel's chain of
//   dependent steps (slot, projection, divisions, depth gather, pool
//   read-modify-write) sets the time unless many are in flight at once.
//
// What the design does about it: a TPU gather is slow, so the Pallas kernel
//   gathers through row-select matmuls over Morton-ordered tiles. On Hopper a
//   pixel read is one cached load (__ldg), so the gather is fused into the
//   update and nothing is staged: the projected pixel, the depth and the
//   colour never leave registers. Slots are unique within a frame, so no
//   atomics are needed. The row kernel then shapes the work for the card:
//   * a thread takes an x-row of VX voxels of one block and a CTA takes
//     BLOCKS sparse blocks, fixed at build time for each of the two
//     instances (CDMI_SPARSE_* below): the depth-only kernel takes whole
//     rows (8 voxels, 2 blocks a CTA), the colour kernel rows of 2 voxels
//     (1 block a CTA): at 8 voxels its three extra pools need ~115
//     registers, and the few warps an SM then holds left HBM idle between
//     their loads and stores;
//   * what a CTA's threads share is computed once, into shared memory: each
//     block's slot and base_r, and the products P[r,c] * axes[c,n], the same
//     for every block; a row forms its two row terms once;
//   * the row's pool, weight and colour words are loaded first, as 16-byte
//     vectors (a row of 8 voxels is 32 bytes of pool and 96 of colour, at
//     16-byte aligned offsets: the wrapper holds the pools' bases to 16
//     bytes), so that they are in flight during the divisions and the
//     gather; then the row's VX projections, then its VX depth (and colour)
//     gathers together, then the updates, stored back as 16-byte vectors.
//   The general kernel serves every other block shape (4^3, 16^3, (4, 6, 5),
//   (3, 5, 7), ...). It replaces a kernel of one CTA a block and one thread a
//   voxel, in which every thread formed its block's four base_r and twelve
//   products, split its flat index by three runtime integer divisions and
//   only then loaded its pool words, one at a time: on one fr1 frame into
//   (4, 6, 5) blocks it reached under half of its byte bound with colour
//   and under a fifth depth only, and 2^3 or 3^3 blocks left a CTA one warp.
//   Its design:
//   * a thread takes VX consecutive voxels of one block in flat (k, j, i)
//     order, a block ceil(nvox / VX) threads, and a CTA the next THREADS
//     threads of the call whatever blocks they fall in: every warp is full
//     but the grid's last, for any shape, and no block is too large for a
//     CTA;
//   * as in the row kernel, each block's slot and base_r and the products
//     P[r,c] * axes[c,n] (one float4 over r, for bz + by + bx offsets) are
//     formed once a CTA in shared memory; a voxel adds its three float4 in
//     the plain version's order;
//   * the thread's block and first voxel (i, j, k) come from three exact
//     multiply-high divisions by constants formed on the host, and the next
//     voxels by steps of i, carried into j and k;
//   * the pool, weight and colour words are loaded before the projections,
//     as 16-byte vectors where nvox is a multiple of 4 (a block's pool base
//     slot * nvox * 4 bytes is then a multiple of 16 and its colour base a
//     multiple of 48), else 8-byte or word loads, in one kernel template.
//   `python3 chip_smoke.py --sparse-shapes` builds this file once per
//   launch shape of each kernel with -D (the row kernel's (VX, BLOCKS) on
//   the fr1 frame's 8^3 blocks, the general kernel's (VX, THREADS) on the
//   same frame's (4, 6, 5) blocks), holds each build to the plain versions
//   bit for bit and times it by device time with the L2 flushed; the
//   defaults are the fastest of each sweep (PERF.md section 6).
//
// Parity with ops/sparse_grid.py (bit for bit with the plain version
// kernels/sparse_cuda.py, which follows the JAX order of operations):
//   * lattice association base_r = ((P[r,0]*ox + P[r,1]*oy) + P[r,2]*oz)
//     + P[r,3], h_r = ((base_r + P[r,2]*az[k]) + P[r,1]*ay[j]) + P[r,0]*ax[i]
//     (sparse_grid.py:75-87), not the dense kernel's ty + (tx + (tz + tc));
//     the row kernel forms the row term t_r = (base_r + P[r,2]*az[k]) +
//     P[r,1]*ay[j] once and h_r = t_r + P[r,0]*ax[i], the general kernel
//     each h_r in full from the products in shared memory: the same rounded
//     operations in the same order;
//   * IEEE division, no fused multiply-add, round half away from zero
//     (common.cuh); bounds tested on the float u, v with h2 >= 0 kept;
//   * -1 is the invalid-depth sentinel; an invalid sample adds +0.0f, and
//     every word is stored, so a -0.0 word becomes +0.0 as in the plain
//     version;
//   * colour weight: near = valid && d != -1, falloff = max(0, 1 - |zcam -
//     d| / band), wadd = near ? falloff : 0; the pools add rgb * wadd and
//     wadd (sparse_grid.py:205-209). The row kernel reads a pixel's colour
//     whenever the pixel is in the map; where d == -1, wadd is 0 and rgb * 0
//     is the +0.0 the plain version adds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// The row kernel's launch shapes: voxels a thread along an x-row of an 8^3
// block, and sparse blocks a CTA; for the depth-only instance and for the
// colour instance.
#ifndef CDMI_SPARSE_VX
#define CDMI_SPARSE_VX 8
#endif
#ifndef CDMI_SPARSE_BLOCKS
#define CDMI_SPARSE_BLOCKS 2
#endif
#ifndef CDMI_SPARSE_COLOR_VX
#define CDMI_SPARSE_COLOR_VX 2
#endif
#ifndef CDMI_SPARSE_COLOR_BLOCKS
#define CDMI_SPARSE_COLOR_BLOCKS 1
#endif
// The general kernel's launch shapes: consecutive voxels a thread, and
// threads a CTA; for the depth-only instance and for the colour instance.
#ifndef CDMI_SPARSE_GEN_VX
#define CDMI_SPARSE_GEN_VX 8
#endif
#ifndef CDMI_SPARSE_GEN_THREADS
#define CDMI_SPARSE_GEN_THREADS 128
#endif
#ifndef CDMI_SPARSE_GEN_COLOR_VX
#define CDMI_SPARSE_GEN_COLOR_VX 2
#endif
#ifndef CDMI_SPARSE_GEN_COLOR_THREADS
#define CDMI_SPARSE_GEN_COLOR_THREADS 256
#endif

namespace {

using cdmi::ray_potential;
using cdmi::round_half_away;

constexpr int kB = 8;  // the row kernel's blocks are kB^3 voxels
constexpr int kBlockVoxels = kB * kB * kB;
// The general kernel keeps bz + by + bx products in shared memory: 32 KB.
constexpr int kMaxEdgeSum = 2048;


// N consecutive floats at p into v[0..N), as 16-byte vectors where N
// allows, else 8-byte ones, else words; p is aligned to the vector.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = t.x;
      v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = v[q];
  }
}

template <bool kColor, int VX, int kBlocks>
__global__ void __launch_bounds__(kBlocks * kB * kB * (kB / VX)) sparse_fuse_rows_kernel(
    float* __restrict__ pool,             // (cap, 8, 8, 8), in place
    const int* __restrict__ slots,        // (B,) unique pool slots
    const float* __restrict__ origins,    // (B, 3) block origins, xyz
    const float* __restrict__ proj,       // (4, 4) rows 0..2 of P + z row
    const float* __restrict__ axes,       // (3, bmax) voxel-centre offsets
    const float* __restrict__ depth,      // (h, w), h * w < 2^31
    const uint8_t* __restrict__ rgb,      // (h, w, 3), kColor only
    float* __restrict__ color_pool,       // (cap, 8, 8, 8, 3), kColor
    float* __restrict__ weight_pool,      // (cap, 8, 8, 8), kColor
    int n_blocks, int bmax, int h, int w, float thick, float rho, float delta,
    float rho_over_thick, float neg_eta_rho, float band) {
  static_assert(VX > 0 && kB % VX == 0, "voxels a thread must divide 8");
  constexpr int kParts = kB / VX;  // threads an x-row
  constexpr int kThreads = kBlocks * kB * kB * kParts;
  static_assert(kThreads <= 1024, "a CTA holds at most 1,024 threads");
  // Once a CTA: prod[c][r][n] = P[r,c] * axes[c,n] (the same for every
  // block), and each block's slot and base_r.
  __shared__ float s_prod[3][4][kB];
  __shared__ float s_base[kBlocks][4];
  __shared__ int s_slot[kBlocks];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kBlocks;
  for (int q = t; q < 3 * 4 * kB; q += kThreads) {
    const int c = q / (4 * kB), r = (q / kB) % 4, n = q % kB;
    s_prod[c][r][n] = __fmul_rn(__ldg(proj + 4 * r + c), __ldg(axes + c * bmax + n));
  }
  if (t < 4 * kBlocks && b0 + t / 4 < n_blocks) {
    const int lb = t / 4, r = t % 4;
    const float* o = origins + 3 * (b0 + lb);
    const float* p = proj + 4 * r;
    s_base[lb][r] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(__ldg(p), __ldg(o)),
                            __fmul_rn(__ldg(p + 1), __ldg(o + 1))),
                  __fmul_rn(__ldg(p + 2), __ldg(o + 2))),
        __ldg(p + 3));
    if (r == 0) s_slot[lb] = __ldg(slots + b0 + lb);
  }
  __syncthreads();

  // Threads run x-part fastest, then y, z and block: thread t of a block's
  // threads covers its voxels t * VX .. t * VX + VX - 1.
  const int part = t % kParts;
  const int row = t / kParts;
  const int lb = row / (kB * kB);
  const int k = (row / kB) % kB;
  const int j = row % kB;
  if (b0 + lb >= n_blocks) return;
  const int i0 = part * VX;
  const int64_t vox = (int64_t)s_slot[lb] * kBlockVoxels + (k * kB + j) * kB + i0;

  // The row's pool words first, so that they arrive during the arithmetic.
  float acc[VX], wsum[VX], csum[3 * VX];
  load_floats<VX>(pool + vox, acc);
  if constexpr (kColor) {
    load_floats<VX>(weight_pool + vox, wsum);
    load_floats<3 * VX>(color_pool + 3 * vox, csum);
  }

  float tr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    tr[r] = __fadd_rn(__fadd_rn(s_base[lb][r], s_prod[2][r][k]), s_prod[1][r][j]);
  }
  const float wf = (float)w;
  const float hf = (float)h;
  float zc[VX], d[VX];
  int pix[VX];
  bool valid[VX];
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    const float h0 = __fadd_rn(tr[0], s_prod[0][0][i0 + i]);
    const float h1 = __fadd_rn(tr[1], s_prod[0][1][i0 + i]);
    const float h2 = __fadd_rn(tr[2], s_prod[0][2][i0 + i]);
    zc[i] = __fadd_rn(tr[3], s_prod[0][3][i0 + i]);
    const float u = round_half_away(__fdiv_rn(h0, h2));
    const float v = round_half_away(__fdiv_rn(h1, h2));
    valid[i] = h2 >= 0.0f && u >= 0.0f && v >= 0.0f && u < wf && v < hf;
    pix[i] = valid[i] ? (int)v * w + (int)u : 0;
  }
  // The row's gathers, independent of each other, in flight together.
  float c[3 * VX];
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    d[i] = valid[i] ? __ldg(depth + pix[i]) : -1.0f;
    if constexpr (kColor) {
      const uint8_t* px = rgb + 3 * (int64_t)pix[i];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[3 * i + ch] = valid[i] ? (float)__ldg(px + ch) : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    const bool near = valid[i] && d[i] != -1.0f;
    const float diff = __fsub_rn(zc[i], d[i]);
    const float contrib =
        near ? ray_potential(diff, thick, rho, delta, rho_over_thick, neg_eta_rho)
             : 0.0f;
    acc[i] = __fadd_rn(acc[i], contrib);
    if constexpr (kColor) {
      const float wadd =
          near ? fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(fabsf(diff), band))) : 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        csum[3 * i + ch] = __fadd_rn(csum[3 * i + ch], __fmul_rn(c[3 * i + ch], wadd));
      }
      wsum[i] = __fadd_rn(wsum[i], wadd);
    }
  }
  // Every word is stored: an invalid sample's +0.0 turns -0.0 into +0.0.
  store_floats<VX>(pool + vox, acc);
  if constexpr (kColor) {
    store_floats<VX>(weight_pool + vox, wsum);
    store_floats<3 * VX>(color_pool + 3 * vox, csum);
  }
}

// Exact unsigned division by a divisor fixed at launch, for every 32-bit n:
// n / d is the high half of n * m with m = floor((2^64 - 1) / d) + 1, formed
// once on the host (m * d = 2^64 + e with 0 <= e <= d, so the error term
// n * e / 2^64 stays below 1 / d). d == 1 is taken apart: its m overflows.
struct DivBy {
  unsigned long long m;
  unsigned d;
};

DivBy divider(unsigned d) { return {d > 1 ? ~0ULL / d + 1 : 0ULL, d}; }

__device__ __forceinline__ unsigned divide(unsigned n, DivBy q) {
  return q.d == 1 ? n : (unsigned)__umul64hi((unsigned long long)n, q.m);
}

// Words a vector of the general kernel moves when a thread's VX voxels come
// in whole vectors: 4 (16 bytes) where VX allows, else 2, else 1.
__host__ __device__ constexpr int chunk_words(int vx) {
  return vx % 4 == 0 ? 4 : (vx % 2 == 0 ? 2 : 1);
}

// The general kernel: blocks of any shape. A thread takes VX consecutive
// voxels of one block in its flat (k, j, i) order; a block has per_block.d =
// ceil(nvox / VX) threads, and a CTA takes the next kThreads threads of the
// call, whatever blocks they fall in. With kVec (nvox a multiple of
// chunk_words(VX), pools 16-byte aligned) the words move as vectors of that
// many; else a word at a time.
template <bool kColor, int VX, int kThreads, bool kVec>
__global__ void __launch_bounds__(kThreads) sparse_fuse_kernel(
    float* __restrict__ pool,             // (cap, bz, by, bx), in place
    const int* __restrict__ slots,        // (B,) unique pool slots
    const float* __restrict__ origins,    // (B, 3) block origins, xyz
    const float* __restrict__ proj,       // (4, 4) rows 0..2 of P + z row
    const float* __restrict__ axes,       // (3, bmax) voxel-centre offsets
    const float* __restrict__ depth,      // (h, w), h * w < 2^31
    const uint8_t* __restrict__ rgb,      // (h, w, 3), kColor only
    float* __restrict__ color_pool,       // (cap, bz, by, bx, 3), kColor
    float* __restrict__ weight_pool,      // (cap, bz, by, bx), kColor
    int n_threads, int nvox, int bz, int by, int bx, int bmax, DivBy per_block, DivBy div_bx,
    DivBy div_by, int h, int w, float thick, float rho, float delta, float rho_over_thick,
    float neg_eta_rho, float band) {
  static_assert(VX > 0 && kThreads % 32 == 0 && kThreads <= 512, "launch shape");
  constexpr int C = kVec ? chunk_words(VX) : 1;
  // Once a CTA: the products P[r,c] * axes[c,n] as one float4 over r, for
  // x (n < bx), then y, then z (dynamic, (bx + by + bz) float4); and the
  // slot and base_r of each block the CTA's threads fall in (at most
  // kThreads blocks, one when a block has kThreads threads or more).
  extern __shared__ float4 s_prod[];
  __shared__ float4 s_base[kThreads];
  __shared__ int s_slot[kThreads];
  const int t = threadIdx.x;
  const unsigned g0 = blockIdx.x * kThreads;
  const unsigned b_lo = divide(g0, per_block);
  const unsigned g_end = min(g0 + kThreads, (unsigned)n_threads);
  const int nb = (int)(divide(g_end - 1, per_block) - b_lo) + 1;
  for (int q = t; q < bx + by + bz; q += kThreads) {
    const int c = q < bx ? 0 : (q < bx + by ? 1 : 2);
    const float a = __ldg(axes + c * bmax + q - (c == 0 ? 0 : (c == 1 ? bx : bx + by)));
    s_prod[q] = make_float4(__fmul_rn(__ldg(proj + c), a), __fmul_rn(__ldg(proj + 4 + c), a),
                            __fmul_rn(__ldg(proj + 8 + c), a), __fmul_rn(__ldg(proj + 12 + c), a));
  }
  for (int q = t; q < nb; q += kThreads) {
    const float* o = origins + 3 * (int64_t)(b_lo + q);
    const float ox = __ldg(o), oy = __ldg(o + 1), oz = __ldg(o + 2);
    float base[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* p = proj + 4 * r;
      base[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(p), ox), __fmul_rn(__ldg(p + 1), oy)),
                                    __fmul_rn(__ldg(p + 2), oz)),
                          __ldg(p + 3));
    }
    s_base[q] = make_float4(base[0], base[1], base[2], base[3]);
    s_slot[q] = __ldg(slots + b_lo + q);
  }
  __syncthreads();

  const unsigned g = g0 + t;
  if (g >= (unsigned)n_threads) return;
  const unsigned b = divide(g, per_block);
  const int f0 = (int)(g - b * per_block.d) * VX;  // the thread's first voxel
  const int lb = (int)(b - b_lo);
  const int64_t vox = (int64_t)s_slot[lb] * nvox + f0;

  // The thread's pool words first, so that they arrive during the
  // arithmetic. A chunk lies wholly in the block or wholly past its end.
  float acc[VX] = {}, wsum[VX] = {}, csum[3 * VX] = {};
#pragma unroll
  for (int q = 0; q < VX; q += C) {
    if (f0 + q < nvox) {
      load_floats<C>(pool + vox + q, acc + q);
      if constexpr (kColor) {
        load_floats<C>(weight_pool + vox + q, wsum + q);
        load_floats<3 * C>(color_pool + 3 * (vox + q), csum + 3 * q);
      }
    }
  }

  // The first voxel's (i, j, k) by two divisions, the next ones by steps.
  const unsigned kj = divide(f0, div_bx);
  int i = f0 - (int)kj * bx;
  int k = (int)divide(kj, div_by);
  int j = (int)kj - k * by;
  const float4 base = s_base[lb];
  const float wf = (float)w;
  const float hf = (float)h;
  float zc[VX], d[VX];
  int pix[VX];
  bool valid[VX];
#pragma unroll
  for (int v = 0; v < VX; ++v) {
    const bool in = f0 + v < nvox;
    const float4 pz = s_prod[bx + by + (in ? k : 0)];
    const float4 py = s_prod[bx + (in ? j : 0)];
    const float4 px = s_prod[in ? i : 0];
    const float h0 = __fadd_rn(__fadd_rn(__fadd_rn(base.x, pz.x), py.x), px.x);
    const float h1 = __fadd_rn(__fadd_rn(__fadd_rn(base.y, pz.y), py.y), px.y);
    const float h2 = __fadd_rn(__fadd_rn(__fadd_rn(base.z, pz.z), py.z), px.z);
    zc[v] = __fadd_rn(__fadd_rn(__fadd_rn(base.w, pz.w), py.w), px.w);
    const float u = round_half_away(__fdiv_rn(h0, h2));
    const float vv = round_half_away(__fdiv_rn(h1, h2));
    valid[v] = in && h2 >= 0.0f && u >= 0.0f && vv >= 0.0f && u < wf && vv < hf;
    pix[v] = valid[v] ? (int)vv * w + (int)u : 0;
    if (++i == bx) {
      i = 0;
      if (++j == by) {
        j = 0;
        ++k;
      }
    }
  }
  // The thread's gathers, independent of each other, in flight together.
  float c[3 * VX];
#pragma unroll
  for (int v = 0; v < VX; ++v) {
    d[v] = valid[v] ? __ldg(depth + pix[v]) : -1.0f;
    if constexpr (kColor) {
      const uint8_t* px = rgb + 3 * (int64_t)pix[v];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[3 * v + ch] = valid[v] ? (float)__ldg(px + ch) : 0.0f;
    }
  }
#pragma unroll
  for (int v = 0; v < VX; ++v) {
    const bool near = valid[v] && d[v] != -1.0f;
    const float diff = __fsub_rn(zc[v], d[v]);
    const float contrib =
        near ? ray_potential(diff, thick, rho, delta, rho_over_thick, neg_eta_rho) : 0.0f;
    acc[v] = __fadd_rn(acc[v], contrib);
    if constexpr (kColor) {
      const float wadd =
          near ? fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(fabsf(diff), band))) : 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        csum[3 * v + ch] = __fadd_rn(csum[3 * v + ch], __fmul_rn(c[3 * v + ch], wadd));
      }
      wsum[v] = __fadd_rn(wsum[v], wadd);
    }
  }
  // Every word of the block is stored: an invalid sample's +0.0 turns -0.0
  // into +0.0.
#pragma unroll
  for (int q = 0; q < VX; q += C) {
    if (f0 + q < nvox) {
      store_floats<C>(pool + vox + q, acc + q);
      if constexpr (kColor) {
        store_floats<C>(weight_pool + vox + q, wsum + q);
        store_floats<3 * C>(color_pool + 3 * (vox + q), csum + 3 * q);
      }
    }
  }
}

// The general kernel's launch: the vector instance where the block's
// voxels come in whole chunks, else the word instance.
template <bool kColor, int VX, int kThreads>
void launch_general(float* pool, const int* slots, const float* origins, const float* proj,
                    const float* axes, const float* depth, const uint8_t* rgb,
                    float* color_pool, float* weight_pool, int n_blocks, int bz, int by,
                    int bx, int bmax, int h, int w, float thick, float rho, float delta,
                    float rho_over_thick, float neg_eta_rho, float band, cudaStream_t s) {
  const int nvox = bz * by * bx;
  const int per_block = (nvox + VX - 1) / VX;
  const int n_threads = n_blocks * per_block;
  const int grid = (n_threads + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float4) * (bx + by + bz);
  auto kernel = sparse_fuse_kernel<kColor, VX, kThreads, false>;
  if constexpr (chunk_words(VX) > 1) {
    if (nvox % chunk_words(VX) == 0) kernel = sparse_fuse_kernel<kColor, VX, kThreads, true>;
  }
  kernel<<<grid, kThreads, smem, s>>>(
      pool, slots, origins, proj, axes, depth, rgb, color_pool, weight_pool, n_threads, nvox,
      bz, by, bx, bmax, divider(per_block), divider(bx), divider(by), h, w, thick, rho, delta,
      rho_over_thick, neg_eta_rho, band);
}

template <bool kColor, int VX, int kBlocks>
void launch_rows(float* pool, const int* slots, const float* origins, const float* proj,
                 const float* axes, const float* depth, const uint8_t* rgb, float* color_pool,
                 float* weight_pool, int n_blocks, int bmax, int h, int w, float thick,
                 float rho, float delta, float rho_over_thick, float neg_eta_rho, float band,
                 cudaStream_t s) {
  const int grid = (n_blocks + kBlocks - 1) / kBlocks;
  sparse_fuse_rows_kernel<kColor, VX, kBlocks><<<grid, kBlocks * kB * kB * (kB / VX), 0, s>>>(
      pool, slots, origins, proj, axes, depth, rgb, color_pool, weight_pool, n_blocks, bmax,
      h, w, thick, rho, delta, rho_over_thick, neg_eta_rho, band);
}

}  // namespace

// Both entries launch on `stream` of `device` and return the launch's
// cudaError_t. With rgb == nullptr only the TSDF pool is updated.

// The row kernel: 8^3 blocks only (else cudaErrorInvalidValue), pools
// aligned to 16 bytes (else cudaErrorMisalignedAddress).
extern "C" int cdmi_sparse_fuse_rows(
    void* pool, const void* slots, const void* origins, const void* proj,
    const void* axes, const void* depth, const void* rgb, void* color_pool,
    void* weight_pool, int n_blocks, int bz, int by, int bx, int bmax, int h,
    int w, float thick, float rho, float delta, float rho_over_thick,
    float neg_eta_rho, float band, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bz != kB || by != kB || bx != kB || bmax < kB) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)pool | (uintptr_t)color_pool | (uintptr_t)weight_pool) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n_blocks > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (rgb != nullptr) {
      launch_rows<true, CDMI_SPARSE_COLOR_VX, CDMI_SPARSE_COLOR_BLOCKS>(
          (float*)pool, (const int*)slots, (const float*)origins, (const float*)proj,
          (const float*)axes, (const float*)depth, (const uint8_t*)rgb, (float*)color_pool,
          (float*)weight_pool, n_blocks, bmax, h, w, thick, rho, delta, rho_over_thick,
          neg_eta_rho, band, s);
    } else {
      launch_rows<false, CDMI_SPARSE_VX, CDMI_SPARSE_BLOCKS>(
          (float*)pool, (const int*)slots, (const float*)origins, (const float*)proj,
          (const float*)axes, (const float*)depth, nullptr, nullptr, nullptr, n_blocks, bmax,
          h, w, thick, rho, delta, rho_over_thick, neg_eta_rho, band, s);
    }
  }
  return (int)cudaGetLastError();
}

// The general kernel: blocks of any shape whose edges sum to at most
// kMaxEdgeSum (the products in shared memory), bmax >= every edge, fewer than
// 2^31 voxels a call (else cudaErrorInvalidValue), pools aligned to 16 bytes
// (else cudaErrorMisalignedAddress).
extern "C" int cdmi_sparse_fuse(
    void* pool, const void* slots, const void* origins, const void* proj,
    const void* axes, const void* depth, const void* rgb, void* color_pool,
    void* weight_pool, int n_blocks, int bz, int by, int bx, int bmax, int h,
    int w, float thick, float rho, float delta, float rho_over_thick,
    float neg_eta_rho, float band, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bz < 1 || by < 1 || bx < 1 || bmax < bz || bmax < by || bmax < bx ||
      bz + by + bx > kMaxEdgeSum || (int64_t)n_blocks * bz * by * bx >= (int64_t(1) << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)pool | (uintptr_t)color_pool | (uintptr_t)weight_pool) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n_blocks > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (rgb != nullptr) {
      launch_general<true, CDMI_SPARSE_GEN_COLOR_VX, CDMI_SPARSE_GEN_COLOR_THREADS>(
          (float*)pool, (const int*)slots, (const float*)origins, (const float*)proj,
          (const float*)axes, (const float*)depth, (const uint8_t*)rgb, (float*)color_pool,
          (float*)weight_pool, n_blocks, bz, by, bx, bmax, h, w, thick, rho, delta,
          rho_over_thick, neg_eta_rho, band, s);
    } else {
      launch_general<false, CDMI_SPARSE_GEN_VX, CDMI_SPARSE_GEN_THREADS>(
          (float*)pool, (const int*)slots, (const float*)origins, (const float*)proj,
          (const float*)axes, (const float*)depth, nullptr, nullptr, nullptr, n_blocks, bz, by,
          bx, bmax, h, w, thick, rho, delta, rho_over_thick, neg_eta_rho, band, s);
    }
  }
  return (int)cudaGetLastError();
}
