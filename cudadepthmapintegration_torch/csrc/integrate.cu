// TSDF ray-potential integration: a column of KZ voxels per thread.
//
// Replaces: cudadepthmapintegration_tpu/kernels/integrate_pallas.py,
//   _integrate_kernel_v2 (the production rowsel/rowsel3 modes) and
//   _integrate_kernel_hbm (the band sweep for maps over the VMEM ceiling),
//   and with them the windows/rowselw/rowseld/rowselm bodies, which compute
//   the same function. This kernel reads depth straight from global memory,
//   so one kernel serves maps of any size.
//
// What bounds it on an H100: instruction issue. At 512^3 cells x 32 views
//   of 512x512 the volume crosses HBM once per launch (1.07 GB, 0.32 ms at
//   3.35 TB/s), the maps (32 MB) sit in the 50 MB L2, and the 4.29 G
//   (voxel, view) updates are 17 FLOPs each (1.09 ms at 67 TFLOP/s). But an
//   update issues about 68 instructions (the SASS of the KZ = 4 build): two
//   IEEE divisions of about 10 each (the reciprocal, its refinement, the
//   check for the slow path), two roundings (FRND), the 8 table adds, the
//   bounds, the gather and the branches of the ray potential. At four
//   warp-instructions a clock per SM that is 9-10 ms. The one-voxel-per-
//   thread kernel this replaces issued 16 more: scalar loads of the
//   (V, 4, c) tables, three of the four rows the same for a whole block or
//   warp; they took a third of its 18.6 ms. The Pallas kernel kept those
//   tables in VMEM because a TPU gathers slowly.
//
// What the design does about it:
//   * The tables arrive re-laid as float4 rows (V, c, 4)
//     (kernels/integrate_cuda.py::stage_tables), with the first add of the
//     association, zc = tz + tc, made once per (view, k) instead of once per
//     (voxel, view): one 16-byte load per table row.
//   * A thread owns the column (k0 .. k0+KZ-1, j, i) and keeps its KZ sums
//     in registers across every view of the call. Per view it loads its x
//     row (coalesced) and its y row (a broadcast: a warp row shares j) once
//     for its KZ voxels; each voxel adds only its zc row, one address for
//     the whole block (a broadcast __ldg). Table loads fall from 16 to
//     (2 + KZ) / KZ per update, and the KZ depth gathers of a view are
//     independent, so they are in flight together.
//   * A sample has no branch: the in-map offset is 32-bit (the wrapper holds
//     h * w below 2^31), an off-map sample reads as the invalid depth, and
//     the potential is computed and then selected.
//   * grid.z = ceil(cz / KZ); the tail column of a volume whose cz is not a
//     multiple of KZ repeats its last row and stores only its nk rows.
//     Volume and view offsets are 64-bit (a 1024^3 grid has 1.07e9 cells).
//   * The launch shape is fixed at build time: KZ = 8 voxels a thread and
//     32 x 4 threads a block (CDMI_INTEGRATE_* below). `python3
//     chip_smoke.py --integrate-shapes` builds this file once per shape with
//     -D, holds each build to the plain version bit for bit and times it.
//     This shape was the fastest of its 20 at 512^3 x 32 views of 512x512
//     and at 1080p maps; KZ = 16 needs 98 registers and loses occupancy,
//     KZ < 8 reloads the x and y rows more often (PERF.md section 6).
//     Staging zc in shared memory and rounding with full-rate adds instead
//     of FRND and F2I measured no faster and were left out.
//
// Parity with the Pallas kernel (bit for bit at view_block=1):
//   * hom = ty + (tx + (tz + tc)), integrate_pallas.py:661-669; zc = tz + tc
//     is the same single correctly rounded add, made before the launch;
//   * IEEE round-to-nearest division (__fdiv_rn), no reciprocal; the library
//     is built with --fmad=false and the arithmetic is spelled with
//     __fadd_rn/__fmul_rn, so nothing contracts into an fma;
//   * round half away from zero as copysign(floor(|x| + 0.5), x), not
//     roundf (they differ at 0.49999997f);
//   * bounds are tested on the float u, v before the int cast (h2 == 0
//     gives inf or NaN), and hom.z >= 0 is kept;
//   * the invalid-depth sentinel is -1.0f;
//   * views are added into each voxel one at a time, in order, and an
//     invalid sample still adds +0.0f, as the Pallas where(valid, val, 0)
//     does: that add turns a -0.0 voxel into +0.0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// Voxels a thread along z, and threads a block along x and y.
#ifndef CDMI_INTEGRATE_KZ
#define CDMI_INTEGRATE_KZ 8
#endif
#ifndef CDMI_INTEGRATE_BLOCK_X
#define CDMI_INTEGRATE_BLOCK_X 32
#endif
#ifndef CDMI_INTEGRATE_BLOCK_Y
#define CDMI_INTEGRATE_BLOCK_Y 4
#endif

namespace {

using cdmi::ray_potential;
using cdmi::round_half_away;

constexpr int KZ = CDMI_INTEGRATE_KZ;
constexpr int kBlockX = CDMI_INTEGRATE_BLOCK_X;
constexpr int kBlockY = CDMI_INTEGRATE_BLOCK_Y;

__global__ void __launch_bounds__(kBlockX * kBlockY) integrate_kernel(
    float* __restrict__ volume,           // (cz, cy, cx), updated in place
    const float4* __restrict__ tab_x,     // (V, cx) rows of tx
    const float4* __restrict__ tab_y,     // (V, cy) rows of ty
    const float4* __restrict__ tab_zc,    // (V, cz) rows of tz + tc
    const float* __restrict__ depths,     // (V, h, w), h * w < 2^31
    int n_views, int cz, int cy, int cx, int h, int w, float thick, float rho,
    float delta, float rho_over_thick, float neg_eta_rho) {
  const int i = blockIdx.x * kBlockX + threadIdx.x;
  const int j = blockIdx.y * kBlockY + threadIdx.y;
  const int k0 = blockIdx.z * KZ;
  const int nk = min(KZ, cz - k0);  // < KZ only in the tail column
  if (i >= cx || j >= cy) return;
  const int64_t slice = (int64_t)cy * cx;
  const int64_t vox0 = ((int64_t)k0 * cy + j) * (int64_t)cx + i;
  const int64_t plane = (int64_t)h * w;
  const float wf = (float)w;
  const float hf = (float)h;

  float acc[KZ];
#pragma unroll
  for (int kk = 0; kk < KZ; ++kk) {
    acc[kk] = kk < nk ? volume[vox0 + kk * slice] : 0.0f;
  }
  for (int view = 0; view < n_views; ++view) {
    const float4 tx4 = __ldg(tab_x + (int64_t)view * cx + i);
    const float4 ty4 = __ldg(tab_y + (int64_t)view * cy + j);
    const float4* zcv = tab_zc + (int64_t)view * cz + k0;
    const float* dmap = depths + view * plane;
    // First every voxel's projection and gather, so that the column's depth
    // loads are in flight together; then the potentials.
    float d[KZ], h3[KZ];
#pragma unroll
    for (int kk = 0; kk < KZ; ++kk) {
      // The tail column repeats its last row; those sums are not stored.
      const float4 zc = __ldg(zcv + min(kk, nk - 1));  // one address a block
      const float h0 = __fadd_rn(ty4.x, __fadd_rn(tx4.x, zc.x));
      const float h1 = __fadd_rn(ty4.y, __fadd_rn(tx4.y, zc.y));
      const float h2 = __fadd_rn(ty4.z, __fadd_rn(tx4.z, zc.z));
      h3[kk] = __fadd_rn(ty4.w, __fadd_rn(tx4.w, zc.w));
      const float u = round_half_away(__fdiv_rn(h0, h2));
      const float v = round_half_away(__fdiv_rn(h1, h2));
      const bool in_map =
          h2 >= 0.0f && u >= 0.0f && v >= 0.0f && u < wf && v < hf;
      // A sample off the map reads as the invalid depth.
      const int pix = in_map ? (int)v * w + (int)u : 0;
      d[kk] = in_map ? __ldg(dmap + pix) : -1.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KZ; ++kk) {
      const float pot = ray_potential(__fsub_rn(h3[kk], d[kk]), thick, rho,
                                      delta, rho_over_thick, neg_eta_rho);
      // An invalid sample still adds +0.0f (a -0.0 sum becomes +0.0).
      acc[kk] = __fadd_rn(acc[kk], d[kk] != -1.0f ? pot : 0.0f);
    }
  }
#pragma unroll
  for (int kk = 0; kk < KZ; ++kk) {
    if (kk < nk) volume[vox0 + kk * slice] = acc[kk];
  }
}

}  // namespace

// Launches on `stream` of `device`; returns the launch's cudaError_t (a
// volume past the launch grid, cz > 65535 * KZ, is refused there).
extern "C" int cdmi_integrate(void* volume, const void* tab_x,
                              const void* tab_y, const void* tab_zc,
                              const void* depths, int n_views, int cz, int cy,
                              int cx, int h, int w, float thick, float rho,
                              float delta, float rho_over_thick,
                              float neg_eta_rho, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_views <= 0 || cz <= 0 || cy <= 0 || cx <= 0) {
    return (int)cudaGetLastError();
  }
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((cx + kBlockX - 1) / kBlockX, (cy + kBlockY - 1) / kBlockY,
                  (cz + KZ - 1) / KZ);
  integrate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (float*)volume, (const float4*)tab_x, (const float4*)tab_y,
      (const float4*)tab_zc, (const float*)depths, n_views, cz, cy, cx, h, w,
      thick, rho, delta, rho_over_thick, neg_eta_rho);
  return (int)cudaGetLastError();
}
