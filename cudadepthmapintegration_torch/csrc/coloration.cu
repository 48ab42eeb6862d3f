// Mesh-coloration gather: one thread per (vertex, view), vertices fastest.
//
// Replaces: cudadepthmapintegration_tpu/kernels/coloration_pallas.py,
//   _colorize_kernel (reached through _gather_colors_padded and
//   gather_colors_pallas). The contract is the same: samples (V, N, 3)
//   uint8 and valid (V, N) bool; an invalid sample is written as 0.
//
// What bounds it on an H100: memory traffic. Each (vertex, view) reads 12
//   bytes of vertex coordinates (L1/L2 hits after the first view), one
//   data-dependent 3-byte colour read, and writes 4 bytes (3 samples and a
//   flag); the arithmetic is a dozen flops and two divisions.
//
// What the design does about it: vertices run fastest, so vertex loads and
//   sample stores coalesce within a warp and the 48 bytes of one view's
//   projection are a broadcast read. There is no Morton order and no tiling:
//   a colour read is one cached load, and marching-cubes output order is
//   already spatially coherent. The masked mean, the exact median and the
//   count stay outside the kernel, as in the JAX package.
//
// Parity with the Pallas kernel (bit for bit):
//   * hom_r = ((p_r0*x + p_r1*y) + p_r2*z) + p_r3 with __fmul_rn/__fadd_rn,
//     and the library is built with --fmad=false (ops/coloration.py:74-87);
//   * IEEE round-to-nearest division; round half away from zero as
//     copysign(floor(|x| + 0.5), x);
//   * bounds against view 0's (h, w), tested on the float u, v; no z test
//     unless z_test, which then requires hom.z > 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using cdmi::round_half_away;

__device__ __forceinline__ float project_row(const float* p, float x, float y,
                                             float z) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__ldg(p + 0), x),
                          __fmul_rn(__ldg(p + 1), y)),
                __fmul_rn(__ldg(p + 2), z)),
      __ldg(p + 3));
}

__global__ void gather_colors_kernel(
    const float* __restrict__ points,    // (N, 3)
    const float* __restrict__ proj,      // (V, 3, 4)
    const uint8_t* __restrict__ colors,  // (V, h, w, 3)
    uint8_t* __restrict__ samples,       // (V, N, 3)
    bool* __restrict__ valid,            // (V, N)
    int n, int h, int w, int z_test) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int view = blockIdx.y;
  if (p >= n) return;
  const float x = __ldg(points + 3 * (int64_t)p + 0);
  const float y = __ldg(points + 3 * (int64_t)p + 1);
  const float z = __ldg(points + 3 * (int64_t)p + 2);
  const float* pv = proj + view * 12;
  const float h0 = project_row(pv + 0, x, y, z);
  const float h1 = project_row(pv + 4, x, y, z);
  const float h2 = project_row(pv + 8, x, y, z);
  const float u = round_half_away(__fdiv_rn(h0, h2));
  const float v = round_half_away(__fdiv_rn(h1, h2));
  bool ok = u >= 0.0f && v >= 0.0f && u < (float)w && v < (float)h;
  if (z_test) ok = ok && h2 > 0.0f;
  uint8_t r = 0, g = 0, b = 0;
  if (ok) {
    const uint8_t* c =
        colors + (((int64_t)view * h + (int)v) * w + (int)u) * 3;
    r = __ldg(c + 0);
    g = __ldg(c + 1);
    b = __ldg(c + 2);
  }
  const int64_t out = (int64_t)view * n + p;
  samples[3 * out + 0] = r;
  samples[3 * out + 1] = g;
  samples[3 * out + 2] = b;
  valid[out] = ok;
}

}  // namespace

// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int cdmi_gather_colors(const void* points, const void* proj,
                                  const void* colors, void* samples,
                                  void* valid, int n, int n_views, int h,
                                  int w, int z_test, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && n_views > 0) {
    const int threads = 256;
    const dim3 grid((n + threads - 1) / threads, n_views, 1);
    gather_colors_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)proj, (const uint8_t*)colors,
        (uint8_t*)samples, (bool*)valid, n, h, w, z_test);
  }
  return (int)cudaGetLastError();
}
