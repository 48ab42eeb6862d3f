// Sparse TSDF update of one RGB-D frame, the pixel gather fused in. Two
// kernels, chosen by the block shape alone (kernels/sparse_cuda.py,
// kernel_for): the row kernel for the library's 8^3 blocks, the general
// kernel (a voxel a thread) for any other shape.
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
//   `python3 chip_smoke.py --sparse-shapes` builds this file once per
//   (VX, BLOCKS) with -D, holds each build to the plain versions bit for bit
//   and times it by device time with the L2 flushed; the defaults are the
//   fastest of its 12 shapes for each instance (PERF.md section 6).
//
// Parity with ops/sparse_grid.py (bit for bit with the plain version
// kernels/sparse_cuda.py, which follows the JAX order of operations):
//   * lattice association base_r = ((P[r,0]*ox + P[r,1]*oy) + P[r,2]*oz)
//     + P[r,3], h_r = ((base_r + P[r,2]*az[k]) + P[r,1]*ay[j]) + P[r,0]*ax[i]
//     (sparse_grid.py:75-87), not the dense kernel's ty + (tx + (tz + tc));
//     the row kernel forms the row term t_r = (base_r + P[r,2]*az[k]) +
//     P[r,1]*ay[j] once and h_r = t_r + P[r,0]*ax[i]: the same rounded
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

namespace {

using cdmi::ray_potential;
using cdmi::round_half_away;

constexpr int kB = 8;  // the row kernel's blocks are kB^3 voxels
constexpr int kBlockVoxels = kB * kB * kB;


// N consecutive floats at p, as 16-byte vectors where N allows, else 8-byte
// ones, else words; p is aligned to the vector.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[N]) {
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
__device__ __forceinline__ void store_floats(float* p, const float (&v)[N]) {
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

// The general kernel: one CTA a sparse block of any shape, one thread a
// voxel; every thread forms the block's terms itself.
template <bool kColor>
__global__ void sparse_fuse_kernel(
    float* __restrict__ pool,             // (cap, bz, by, bx), in place
    const int* __restrict__ slots,        // (B,) unique pool slots
    const float* __restrict__ origins,    // (B, 3) block origins, xyz
    const float* __restrict__ proj,       // (4, 4) rows 0..2 of P + z row
    const float* __restrict__ axes,       // (3, bmax) voxel-centre offsets
    const float* __restrict__ depth,      // (h, w)
    const uint8_t* __restrict__ rgb,      // (h, w, 3), kColor only
    float* __restrict__ color_pool,       // (cap, bz, by, bx, 3), kColor
    float* __restrict__ weight_pool,      // (cap, bz, by, bx), kColor
    int bz, int by, int bx, int bmax, int h, int w, float thick, float rho,
    float delta, float rho_over_thick, float neg_eta_rho, float band) {
  const int b = blockIdx.x;
  const int nvox = bz * by * bx;
  const int64_t slot_base = (int64_t)__ldg(slots + b) * nvox;
  const float o[3] = {__ldg(origins + 3 * b + 0), __ldg(origins + 3 * b + 1),
                      __ldg(origins + 3 * b + 2)};
  float p[4][4];
  float base[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) p[r][c] = __ldg(proj + 4 * r + c);
    base[r] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(p[r][0], o[0]), __fmul_rn(p[r][1], o[1])),
                  __fmul_rn(p[r][2], o[2])),
        p[r][3]);
  }
  const float wf = (float)w;
  const float hf = (float)h;

  for (int t = threadIdx.x; t < nvox; t += blockDim.x) {
    const int i = t % bx;
    const int j = (t / bx) % by;
    const int k = t / (bx * by);
    const float ax = __ldg(axes + i);
    const float ay = __ldg(axes + bmax + j);
    const float az = __ldg(axes + 2 * bmax + k);
    float hom[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hom[r] = __fadd_rn(__fadd_rn(__fadd_rn(base[r], __fmul_rn(p[r][2], az)),
                                   __fmul_rn(p[r][1], ay)),
                         __fmul_rn(p[r][0], ax));
    }
    const float u = round_half_away(__fdiv_rn(hom[0], hom[2]));
    const float v = round_half_away(__fdiv_rn(hom[1], hom[2]));
    const bool valid =
        hom[2] >= 0.0f && u >= 0.0f && v >= 0.0f && u < wf && v < hf;
    int64_t pix = 0;
    float d = -1.0f;
    if (valid) {
      pix = (int64_t)(int)v * w + (int)u;
      d = __ldg(depth + pix);
    }
    const bool near = valid && d != -1.0f;
    const float diff = __fsub_rn(hom[3], d);
    const float contrib =
        near ? ray_potential(diff, thick, rho, delta, rho_over_thick,
                             neg_eta_rho)
             : 0.0f;
    const int64_t vox = slot_base + t;
    pool[vox] = __fadd_rn(pool[vox], contrib);
    if (kColor) {
      float wadd = 0.0f;
      float c[3] = {0.0f, 0.0f, 0.0f};
      if (near) {
        wadd = fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(fabsf(diff), band)));
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) c[ch] = (float)__ldg(rgb + 3 * pix + ch);
      }
      float* cp = color_pool + 3 * vox;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) cp[ch] = __fadd_rn(cp[ch], __fmul_rn(c[ch], wadd));
      weight_pool[vox] = __fadd_rn(weight_pool[vox], wadd);
    }
  }
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

// The general kernel: blocks of any shape.
extern "C" int cdmi_sparse_fuse(
    void* pool, const void* slots, const void* origins, const void* proj,
    const void* axes, const void* depth, const void* rgb, void* color_pool,
    void* weight_pool, int n_blocks, int bz, int by, int bx, int bmax, int h,
    int w, float thick, float rho, float delta, float rho_over_thick,
    float neg_eta_rho, float band, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nvox = bz * by * bx;
  if (n_blocks > 0 && nvox > 0) {
    const int threads = nvox < 512 ? ((nvox + 31) / 32) * 32 : 512;
    const cudaStream_t s = (cudaStream_t)stream;
    if (rgb != nullptr) {
      sparse_fuse_kernel<true><<<n_blocks, threads, 0, s>>>(
          (float*)pool, (const int*)slots, (const float*)origins,
          (const float*)proj, (const float*)axes, (const float*)depth,
          (const uint8_t*)rgb, (float*)color_pool, (float*)weight_pool, bz,
          by, bx, bmax, h, w, thick, rho, delta, rho_over_thick, neg_eta_rho,
          band);
    } else {
      sparse_fuse_kernel<false><<<n_blocks, threads, 0, s>>>(
          (float*)pool, (const int*)slots, (const float*)origins,
          (const float*)proj, (const float*)axes, (const float*)depth,
          nullptr, nullptr, nullptr, bz, by, bx, bmax, h, w, thick, rho,
          delta, rho_over_thick, neg_eta_rho, band);
    }
  }
  return (int)cudaGetLastError();
}
