// TSDF ray-potential integration, one thread per voxel.
//
// Replaces: cudadepthmapintegration_tpu/kernels/integrate_pallas.py,
//   _integrate_kernel_v2 (the production rowsel/rowsel3 modes) and
//   _integrate_kernel_hbm (the band sweep for maps over the VMEM ceiling).
//   Both compute the same function; this kernel reads depth straight from
//   global memory, so one kernel serves maps of any size.
//
// What bounds it on an H100: the depth gather. Each (voxel, view) costs one
//   data-dependent 4-byte load from a depth map, plus table reads that hit
//   L1 (the four table rows of a view are shared by a whole block), two
//   IEEE divisions and a dozen adds. The volume itself costs 8 bytes per
//   voxel per call, not per view.
//
// What the design does about it:
//   * The view loop runs inside the thread and the voxel's running sum stays
//     in a register across every view of the call: one volume read and one
//     write per call (the loop-nest inversion the TPU kernel gets from VMEM
//     residency).
//   * Threads are laid out x fastest, 32 along x and 8 along y, so volume
//     loads and stores coalesce and neighbouring threads project to
//     neighbouring pixels; depth is read with __ldg through the read-only
//     path, and a 32-view batch of 512x512 maps (32 MB) fits the 50 MB L2.
//   * Volume and depth offsets are 64-bit (a 1024^3 grid has 1.07e9 cells).
//
// Parity with the Pallas kernel (bit for bit at view_block=1):
//   * hom = ty + (tx + (tz + tc)), integrate_pallas.py:661-669;
//   * IEEE round-to-nearest division; the library is built with
//     --fmad=false and the arithmetic is spelled with __fadd_rn/__fmul_rn,
//     so nothing contracts into an fma;
//   * round half away from zero as copysign(floor(|x| + 0.5), x), not
//     roundf (they differ at 0.49999997f);
//   * bounds are tested on the float u, v before the int cast (h2 == 0
//     gives inf or NaN), and hom.z >= 0 is kept;
//   * the invalid-depth sentinel is -1.0f;
//   * an invalid sample adds +0.0f, as the Pallas where(valid, val, 0) does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using cdmi::ray_potential;
using cdmi::round_half_away;

__global__ void integrate_kernel(
    float* __restrict__ volume,        // (cz, cy, cx), updated in place
    const float* __restrict__ tx,      // (V, 4, cx)
    const float* __restrict__ ty,      // (V, 4, cy)
    const float* __restrict__ tz,      // (V, 4, cz)
    const float* __restrict__ tc,      // (V, 4)
    const float* __restrict__ depths,  // (V, h, w)
    int n_views, int cz, int cy, int cx, int h, int w, float thick, float rho,
    float delta, float rho_over_thick, float neg_eta_rho) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= cx || j >= cy) return;
  const int64_t vox = ((int64_t)k * cy + j) * (int64_t)cx + i;
  const int64_t plane = (int64_t)h * w;
  const float wf = (float)w;
  const float hf = (float)h;

  float acc = volume[vox];
  for (int view = 0; view < n_views; ++view) {
    const float* txv = tx + (int64_t)view * 4 * cx + i;
    const float* tyv = ty + (int64_t)view * 4 * cy + j;
    const float* tzv = tz + (int64_t)view * 4 * cz + k;
    const float* tcv = tc + (int64_t)view * 4;
    float hom[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float zc = __fadd_rn(__ldg(tzv + r * cz), __ldg(tcv + r));
      hom[r] = __fadd_rn(__ldg(tyv + r * cy),
                         __fadd_rn(__ldg(txv + r * cx), zc));
    }
    const float u = round_half_away(__fdiv_rn(hom[0], hom[2]));
    const float v = round_half_away(__fdiv_rn(hom[1], hom[2]));
    float contrib = 0.0f;
    if (hom[2] >= 0.0f && u >= 0.0f && v >= 0.0f && u < wf && v < hf) {
      const float d =
          __ldg(depths + view * plane + (int64_t)(int)v * w + (int)u);
      if (d != -1.0f) {
        contrib = ray_potential(__fsub_rn(hom[3], d), thick, rho, delta,
                                rho_over_thick, neg_eta_rho);
      }
    }
    acc = __fadd_rn(acc, contrib);
  }
  volume[vox] = acc;
}

}  // namespace

// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int cdmi_integrate(void* volume, const void* tx, const void* ty,
                              const void* tz, const void* tc,
                              const void* depths, int n_views, int cz, int cy,
                              int cx, int h, int w, float thick, float rho,
                              float delta, float rho_over_thick,
                              float neg_eta_rho, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_views > 0 && cz > 0 && cy > 0 && cx > 0) {
    const dim3 block(32, 8, 1);
    const dim3 grid((cx + 31) / 32, (cy + 7) / 8, cz);
    integrate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)volume, (const float*)tx, (const float*)ty, (const float*)tz,
        (const float*)tc, (const float*)depths, n_views, cz, cy, cx, h, w,
        thick, rho, delta, rho_over_thick, neg_eta_rho);
  }
  return (int)cudaGetLastError();
}
