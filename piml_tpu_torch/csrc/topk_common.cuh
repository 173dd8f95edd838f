// Shared device code of the two field-of-view top-k kernels.
//
// Both kernels score one (agent, object) pair with the same operations, in
// the same order, as their plain PyTorch versions (ops/pairwise.py and
// ops/banded.py): the library is built with --fmad=false and without fast
// math, so no multiply-add is contracted and sqrtf / division stay
// correctly rounded.  That is what makes each kernel bitwise equal to its
// plain version on the card.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace piml {

// packed agent rows: [x, y, hx, hy, valid, self_id, 0, 0]
constexpr int kRowStride = 8;
constexpr int kMaxK = 16;

// Running top-k of one query row, kept in registers: every index below is a
// compile-time constant after unrolling, so nothing spills to local memory.
template <int K>
struct TopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      d[t] = CUDART_INF_F;
      i[t] = 0x7fffffff;
    }
  }

  // Strict lexicographic insertion on (d2, id); the candidate bubbles down
  // the sorted list and the largest entry falls off the end.  Callers pass
  // finite d2 only.
  __device__ __forceinline__ void push(float cd, int ci) {
    if (!(cd < d[K - 1] || (cd == d[K - 1] && ci < i[K - 1]))) return;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const bool less = cd < d[t] || (cd == d[t] && ci < i[t]);
      if (less) {
        const float td = d[t];
        const int ti = i[t];
        d[t] = cd;
        i[t] = ci;
        cd = td;
        ci = ti;
      }
    }
  }

  // (sqrt d2, id); an empty (+inf) slot gets id 0
  __device__ __forceinline__ void store(float* out_d, int* out_i) const {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      out_d[t] = sqrtf(d[t]);
      out_i[t] = d[t] < CUDART_INF_F ? i[t] : 0;
    }
  }
};

// Squared distance of an in-view pair, +inf when the field-of-view gate
// rejects it.  The gate is multiplicative, as in the TPU kernel:
// out of view when rel_h < cos_thr * max(sqrt(d2), 1e-8).  The self pair is
// pinned to (d2, rel_h) = (0, 0), which the gate excludes for cos_thr > 0.
__device__ __forceinline__ float pair_d2(float xa, float ya, float hx, float hy,
                                         float xb, float yb, bool self_pair,
                                         float cos_thr) {
  const float dx = xb - xa;
  const float dy = yb - ya;
  float d2 = dx * dx + dy * dy;
  float rel_h = dx * hx + dy * hy;
  if (self_pair) {
    d2 = 0.0f;
    rel_h = 0.0f;
  }
  const bool out_of_view = rel_h < cos_thr * fmaxf(sqrtf(d2), 1e-8f);
  return out_of_view ? CUDART_INF_F : d2;
}

}  // namespace piml

// switch over the compile-time k of a launch; LAUNCH(K) is a macro
#define PIML_DISPATCH_K(k, LAUNCH)                       \
  switch (k) {                                           \
    case 1: LAUNCH(1); break;                            \
    case 2: LAUNCH(2); break;                            \
    case 3: LAUNCH(3); break;                            \
    case 4: LAUNCH(4); break;                            \
    case 5: LAUNCH(5); break;                            \
    case 6: LAUNCH(6); break;                            \
    case 7: LAUNCH(7); break;                            \
    case 8: LAUNCH(8); break;                            \
    case 9: LAUNCH(9); break;                            \
    case 10: LAUNCH(10); break;                          \
    case 11: LAUNCH(11); break;                          \
    case 12: LAUNCH(12); break;                          \
    case 13: LAUNCH(13); break;                          \
    case 14: LAUNCH(14); break;                          \
    case 15: LAUNCH(15); break;                          \
    case 16: LAUNCH(16); break;                          \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
