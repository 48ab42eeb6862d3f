// Mesh coloration on the card: a packed-word gather and an exact per-vertex
// statistics kernel.
//
// gather_colors_kernel. Replaces: cudadepthmapintegration_tpu/kernels/
//   coloration_pallas.py, _colorize_kernel (reached through
//   _gather_colors_padded and gather_colors_pallas), and the XLA gather
//   ops/coloration.py::_gather_chunk where its occlusion test is on. It
//   writes one 32-bit word a (view, vertex) sample into a (V_total, N)
//   buffer: r | g << 8 | b << 16 | 1 << 24 when the sample is valid, 0 when
//   it is not. Every view batch of a vertex chunk writes its rows of one
//   buffer.
//
// color_stats_kernel. Replaces: the XLA reductions of
//   cudadepthmapintegration_tpu/ops/coloration.py, _batch_sum_count (:115)
//   and _median_from_samples (:123), with the uchar truncation that
//   colorize_points applies after them. It reads a chunk's (V, N) words and
//   writes mean (N, 3) uint8, median (N, 3) uint8 and count (N,) int32.
//
// What bounds them on an H100: bytes. At 65,536 vertices x 64 views of
//   512x512 the gather reads 12 bytes a vertex, 48 a view and one 4-byte
//   texel a valid sample, and writes 4 bytes a sample (16.8 MB); its 24 FLOPs
//   a sample are 0.1 G. The statistics read those 16.8 MB once (they sit in
//   the 50 MB L2 when the gather has just written them) and write 10 bytes a
//   vertex.
//
// What the design does about it:
//   * One thread per vertex, vertices fastest: each view row of the word
//     buffer is one coalesced 4-byte store a lane in the gather and one
//     coalesced load in the statistics.
//   * The gather keeps its vertex in registers across a group of
//     CDMI_COLOR_VIEWS views; the block stages the group's 3x4 projection
//     rows in shared memory. The vertex is read once a group, not once a
//     view.
//   * The launch shapes are fixed at build time (CDMI_* below). `python3
//     chip_smoke.py --coloration-shapes` builds this file once per shape
//     with -D, holds each build to the plain versions and times it.
//   * Colours arrive staged as one 32-bit RGBX word a texel
//     (kernels/coloration_cuda.py::stage_texels), so a texel is one 4-byte
//     load; the word becomes the sample with the valid bit set.
//   * The statistics keep the count and the three sums in registers. The
//     exact median is a selection, with no sort and no copy of the samples:
//     one sweep over the column builds a 16-bin histogram of each channel's
//     high nibble, which fixes the high nibble of the two middle ranks; a
//     second sweep builds the low-nibble histogram of that bin, and takes
//     the least sample of the next bin when the two middle ranks fall in
//     different bins (the lower one is then the largest of its bin). The
//     counters are data-indexed, which registers cannot be, so each thread
//     keeps its 48 bins in its own column of shared memory, [bin][thread]:
//     lane t of a warp always reads bank t % 32, whatever its bin, so there
//     is no bank conflict. Counters and sums are 32-bit, so a column may
//     hold up to (2^32 - 1) / 255 views (the wrapper refuses more); 16-bit
//     counters packed two a word measured slower (more instructions a
//     sample).
//   * A statistics thread loads CDMI_STATS_BATCH words of its column
//     together, ahead of their work. The kernel still reaches only about a
//     quarter of its byte bound: a chunk of 65,536 vertices fills 16 warps
//     an SM, and each sample's histogram updates are a dependent chain
//     through shared memory (PERF.md section 6).
//
// Parity (bit for bit with the plain versions in kernels/coloration_cuda.py
// and with the Pallas kernel):
//   * hom_r = ((p_r0*x + p_r1*y) + p_r2*z) + p_r3 with __fmul_rn/__fadd_rn,
//     and the library is built with --fmad=false;
//   * IEEE round-to-nearest division; round half away from zero as
//     copysign(floor(|x| + 0.5), x);
//   * bounds against view 0's (h, w), tested on the float u, v; no z test
//     unless z_test, which then requires hom.z > 0;
//   * with a depth batch (the occlusion test of the XLA gather), a sample is
//     rejected unless z > 0, d != -1 and z <= __fadd_rn(d, tol), with z =
//     hom.z and d the view's depth at the pixel;
//   * mean = sum / count in integers: the reference's float64 sum / count
//     truncated to uchar gives the same, since a true quotient below an
//     integer k lies at least 1/count below it;
//   * median = (s[lo] + s[hi]) >> 1 with lo = (c - 1) / 2 and hi = c / 2 of
//     the c sorted valid samples: the reference's 0.5 * (a + b) in float32
//     truncated to uchar (Helper.h:174-187);
//   * a vertex with no valid sample gets (0, 0, 0), (0, 0, 0) and 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// Views a gather thread keeps its vertex across, and threads a block.
#ifndef CDMI_COLOR_VIEWS
#define CDMI_COLOR_VIEWS 8
#endif
#ifndef CDMI_COLOR_THREADS
#define CDMI_COLOR_THREADS 256
#endif
// Threads a block of the statistics kernel (each holds 48 words of shared
// memory: 6 KB a warp), and words a statistics thread loads ahead.
#ifndef CDMI_STATS_THREADS
#define CDMI_STATS_THREADS 128
#endif
#ifndef CDMI_STATS_BATCH
#define CDMI_STATS_BATCH 8
#endif

namespace {

using cdmi::round_half_away;

constexpr int kViews = CDMI_COLOR_VIEWS;
constexpr int kThreads = CDMI_COLOR_THREADS;
constexpr int kStatsThreads = CDMI_STATS_THREADS;
constexpr int kBatch = CDMI_STATS_BATCH;
constexpr uint32_t kValid = 1u << 24;

__device__ __forceinline__ float project_row(const float* p, float x, float y,
                                             float z) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(p[0], x), __fmul_rn(p[1], y)),
                __fmul_rn(p[2], z)),
      p[3]);
}

__global__ void __launch_bounds__(kThreads) gather_colors_kernel(
    const float* __restrict__ points,     // (N, 3)
    const float* __restrict__ proj,       // (V, 3, 4)
    const uint32_t* __restrict__ texels,  // (V, h, w) RGBX words
    const float* __restrict__ depths,     // (V, h, w), or null: no occlusion
    uint32_t* __restrict__ out,           // (V, N) rows of the caller's buffer
    int n, int n_views, int h, int w, int z_test, float tol) {
  __shared__ float rows[kViews * 12];
  const int v0 = blockIdx.y * kViews;
  const int nv = min(kViews, n_views - v0);
  for (int i = threadIdx.x; i < nv * 12; i += kThreads) {
    rows[i] = __ldg(proj + v0 * 12 + i);
  }
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const float x = __ldg(points + 3 * (int64_t)p + 0);
  const float y = __ldg(points + 3 * (int64_t)p + 1);
  const float z = __ldg(points + 3 * (int64_t)p + 2);
  const float wf = (float)w;
  const float hf = (float)h;
  const int64_t plane = (int64_t)h * w;
#pragma unroll
  for (int g = 0; g < kViews; ++g) {
    if (g >= nv) break;
    const float* pv = rows + 12 * g;
    const float h0 = project_row(pv + 0, x, y, z);
    const float h1 = project_row(pv + 4, x, y, z);
    const float h2 = project_row(pv + 8, x, y, z);
    const float u = round_half_away(__fdiv_rn(h0, h2));
    const float v = round_half_away(__fdiv_rn(h1, h2));
    bool ok = u >= 0.0f && v >= 0.0f && u < wf && v < hf;
    if (z_test) ok = ok && h2 > 0.0f;
    uint32_t word = 0;
    if (ok) {
      // The wrapper holds h * w below 2^31.
      const int64_t pix = (v0 + g) * plane + ((int)v * w + (int)u);
      if (depths != nullptr) {
        const float d = __ldg(depths + pix);
        ok = h2 > 0.0f && d != -1.0f && h2 <= __fadd_rn(d, tol);
      }
      if (ok) word = __ldg(texels + pix) | kValid;
    }
    out[(int64_t)(v0 + g) * n + p] = word;
  }
}

// The counter of bin b (0..15) of one channel: h points at the channel's
// first bin in the thread's column.
__device__ __forceinline__ uint32_t& counter(uint32_t* h, uint32_t b) {
  return h[b * kStatsThreads];
}

// The bin that holds rank `rank` (0-based, below the histogram's total), and
// in `within` the rank inside that bin.
__device__ __forceinline__ uint32_t find_bin(const uint32_t* h, uint32_t rank,
                                             uint32_t* within) {
  uint32_t below = 0;
  uint32_t bin = 15;
  bool found = false;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uint32_t c = h[b * kStatsThreads];
    if (!found && rank < below + c) {
      bin = b;
      *within = rank - below;
      found = true;
    }
    below += c;
  }
  return bin;
}

// Calls f(word) on each of a column's n_views words, kBatch at a time: the
// batch's loads are issued together, ahead of its work. The words past the
// column's end read as 0, an invalid sample.
template <typename F>
__device__ __forceinline__ void for_each_word(const uint32_t* src, int ld,
                                              int n_views, F f) {
  for (int v0 = 0; v0 < n_views; v0 += kBatch) {
    uint32_t word[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      word[i] = v0 + i < n_views ? __ldg(src + (int64_t)(v0 + i) * ld) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) f(word[i]);
  }
}

__global__ void __launch_bounds__(kStatsThreads) color_stats_kernel(
    const uint32_t* __restrict__ words,  // (V, ld): a chunk's sample words
    int ld, int n, int n_views,
    uint8_t* __restrict__ mean,          // (N, 3)
    uint8_t* __restrict__ median,        // (N, 3)
    int32_t* __restrict__ count) {       // (N,)
  // Each thread's 3 x 16 bin counters, one column per thread.
  __shared__ uint32_t hist[48 * kStatsThreads];
  const int p = blockIdx.x * kStatsThreads + threadIdx.x;
  if (p >= n) return;  // no barrier below: each thread uses its own column
  uint32_t* col = hist + threadIdx.x;
#pragma unroll
  for (int k = 0; k < 48; ++k) col[k * kStatsThreads] = 0;

  // Sweep 1: count, sums and the high-nibble histograms.
  const uint32_t* src = words + p;
  uint32_t c = 0, sum[3] = {0, 0, 0};
  for_each_word(src, ld, n_views, [&](uint32_t word) {
    if (word & kValid) {
      ++c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const uint32_t s = (word >> (8 * ch)) & 0xFFu;
        sum[ch] += s;
        ++counter(col + ch * 16 * kStatsThreads, s >> 4);
      }
    }
  });
  count[p] = (int32_t)c;
  if (c == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      mean[3 * (int64_t)p + ch] = 0;
      median[3 * (int64_t)p + ch] = 0;
    }
    return;
  }
  const uint32_t lo = (c - 1) >> 1, hi = c >> 1;
  uint32_t bin_lo[3], bin_hi[3], rank_lo[3], rank_hi[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const uint32_t* h = col + ch * 16 * kStatsThreads;
    bin_lo[ch] = find_bin(h, lo, &rank_lo[ch]);
    bin_hi[ch] = find_bin(h, hi, &rank_hi[ch]);
  }
#pragma unroll
  for (int k = 0; k < 48; ++k) col[k * kStatsThreads] = 0;

  // Sweep 2: the low-nibble histogram of each channel's lower middle bin,
  // and the least sample of its upper middle bin.
  uint32_t least_hi[3] = {255, 255, 255};
  for_each_word(src, ld, n_views, [&](uint32_t word) {
    if (word & kValid) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const uint32_t s = (word >> (8 * ch)) & 0xFFu;
        if ((s >> 4) == bin_lo[ch]) ++counter(col + ch * 16 * kStatsThreads, s & 15u);
        if ((s >> 4) == bin_hi[ch]) least_hi[ch] = min(least_hi[ch], s);
      }
    }
  });
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const uint32_t* h = col + ch * 16 * kStatsThreads;
    uint32_t unused;
    const uint32_t s_lo = (bin_lo[ch] << 4) | find_bin(h, rank_lo[ch], &unused);
    const uint32_t s_hi =
        bin_hi[ch] == bin_lo[ch]
            ? (bin_lo[ch] << 4) | find_bin(h, rank_hi[ch], &unused)
            : least_hi[ch];
    mean[3 * (int64_t)p + ch] = (uint8_t)(sum[ch] / c);
    median[3 * (int64_t)p + ch] = (uint8_t)((s_lo + s_hi) >> 1);
  }
}

}  // namespace

// Launches on `stream` of `device`; returns the launch's cudaError_t. `out`
// points at the first of the n_views rows this call writes, each n words.
extern "C" int cdmi_gather_colors(const void* points, const void* proj,
                                  const void* texels, const void* depths,
                                  void* out, int n, int n_views, int h, int w,
                                  int z_test, float tol, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && n_views > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads,
                    (n_views + kViews - 1) / kViews, 1);
    gather_colors_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)proj, (const uint32_t*)texels,
        (const float*)depths, (uint32_t*)out, n, n_views, h, w, z_test, tol);
  }
  return (int)cudaGetLastError();
}

// Launches on `stream` of `device`; returns the launch's cudaError_t.
// `words` has n_views rows of n words, `ld` words apart.
extern "C" int cdmi_color_stats(const void* words, int ld, void* mean,
                                void* median, void* count, int n, int n_views,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + kStatsThreads - 1) / kStatsThreads;
    color_stats_kernel<<<blocks, kStatsThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, ld, n, n_views, (uint8_t*)mean,
        (uint8_t*)median, (int32_t*)count);
  }
  return (int)cudaGetLastError();
}
