// Sparse TSDF update of one RGB-D frame: one thread block per touched
// sparse block, one thread per voxel, the pixel gather fused in.
//
// Replaces: cudadepthmapintegration_tpu/kernels/gather_points.py,
//   gather_pixels_pallas / _gather_kernel (the windowed point gather), and
//   the device work around it in ops/sparse_grid.py: _sparse_integrate and
//   _sparse_accumulate_color (lattice projection, bounds test, ray potential,
//   colour falloff, scatter into the block pools).
//
// What bounds it on an H100: memory traffic. Each voxel reads and writes its
//   pool entry (8 bytes; 24 more for the colour and weight pools) and makes
//   one data-dependent read of the depth map (plus 3 bytes of colour); the
//   arithmetic is a dozen flops and two IEEE divisions (three with colour).
//
// What the design does about it: a TPU gather is slow, so the Pallas kernel
//   gathers through row-select matmuls over Morton-ordered tiles. On Hopper a
//   pixel read is one cached load (__ldg), so the gather is fused into the
//   update and nothing is staged: the projected pixel, the depth and the
//   colour never leave registers. Threads run x fastest inside a block, so
//   pool loads and stores coalesce and neighbouring threads read neighbouring
//   pixels. Slots are unique within a frame, so no atomics are needed.
//
// Parity with ops/sparse_grid.py (bit for bit with the plain version
// kernels/sparse_cuda.py, which follows the JAX order of operations):
//   * lattice association base_r = ((P[r,0]*ox + P[r,1]*oy) + P[r,2]*oz)
//     + P[r,3], h_r = ((base_r + P[r,2]*az[k]) + P[r,1]*ay[j]) + P[r,0]*ax[i]
//     (sparse_grid.py:75-87), not the dense kernel's ty + (tx + (tz + tc));
//   * IEEE division, no fused multiply-add, round half away from zero
//     (common.cuh); bounds tested on the float u, v with h2 >= 0 kept;
//   * -1 is the invalid-depth sentinel; an invalid sample adds +0.0f;
//   * colour weight: near = valid && d != -1, falloff = max(0, 1 - |zcam -
//     d| / band), wadd = near ? falloff : 0; the pools add rgb * wadd and
//     wadd (sparse_grid.py:205-209).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using cdmi::ray_potential;
using cdmi::round_half_away;

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

}  // namespace

// Launches on `stream` of `device`; returns the launch's cudaError_t. With
// rgb == nullptr only the TSDF pool is updated.
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
