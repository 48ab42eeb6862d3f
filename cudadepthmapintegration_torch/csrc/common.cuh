// Device functions shared by the kernels of csrc/*.cu.
//
// Parity rules (see each kernel's header): IEEE round-to-nearest division,
// no fused multiply-add (the library is built with --fmad=false and the
// arithmetic is spelled with __fadd_rn/__fmul_rn/__fdiv_rn), and round half
// away from zero as copysign(floor(|x| + 0.5), x), not roundf (they differ
// at 0.49999997f).

#pragma once

#include <cuda_runtime.h>

namespace cdmi {

__device__ __forceinline__ float round_half_away(float x) {
  return copysignf(floorf(__fadd_rn(fabsf(x), 0.5f)), x);
}

// rayPotential (CudaReconstruction.cu:104-120) as the JAX where-chain
// evaluates it: far / shell / ramp by |diff| against delta and thick.
__device__ __forceinline__ float ray_potential(float diff, float thick,
                                               float rho, float delta,
                                               float rho_over_thick,
                                               float neg_eta_rho) {
  const float a = fabsf(diff);
  if (a > delta) return diff > 0.0f ? 0.0f : neg_eta_rho;
  if (a > thick) {
    // rho * sign(diff); sign(0) is 0 (reachable only for thick < 0).
    return diff > 0.0f ? rho : (diff < 0.0f ? -rho : __fmul_rn(rho, diff));
  }
  return __fmul_rn(rho_over_thick, diff);
}

}  // namespace cdmi
