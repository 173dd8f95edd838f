// Shared device code of the two field-of-view top-k kernels.
//
// Both kernels score one (agent, object) pair with the same operations, in
// the same order, as their plain PyTorch versions (ops/pairwise.py and
// ops/banded.py): the library is built with --fmad=false and without fast
// math, so no multiply-add is contracted and sqrtf / division stay
// correctly rounded.  That is what makes each kernel bitwise equal to its
// plain version on the card.
//
// The result is fixed by the strict (d2, id) order, so it does not depend
// on the order in which pairs are visited or partial lists are merged:
// both kernels split a row's columns into slices, one warp each, and merge
// the slices' register lists through shared memory at the end.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace piml {

// packed agent rows: [x, y, hx, hy, valid, self_id, 0, 0]
constexpr int kRowStride = 8;
constexpr int kMaxK = 16;
constexpr int kWarp = 32;

// Squared distance of a pair by direct differencing, and the heading
// projection of its offset; the self pair is pinned to (0, 0).
__device__ __forceinline__ float pair_d2(float dx, float dy, bool self_pair) {
  return self_pair ? 0.0f : dx * dx + dy * dy;
}

__device__ __forceinline__ float pair_rel_h(float dx, float dy, float hx,
                                            float hy, bool self_pair) {
  return self_pair ? 0.0f : dx * hx + dy * hy;
}

// For a field of view of at most 180 degrees (cos_thr >= 0) a pair behind
// the agent (rel_h < 0) fails the gate whatever its distance, so it is
// decided without the sqrt.
__device__ __forceinline__ bool behind(float rel_h, float cos_thr) {
  return cos_thr >= 0.0f && rel_h < 0.0f;
}

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

  // Strict lexicographic insertion on (d2, id); the largest entry falls
  // off the end.  The list is sorted, so the candidate ranks before every
  // entry from its place on: each slot keeps its entry, takes its left
  // neighbour's, or takes the candidate.  The K compares do not depend on
  // each other, where bubbling the candidate down would chain them.
  __device__ __forceinline__ void push(float cd, int ci) {
    if (!ranks(cd, ci)) return;
    bool before[K];
#pragma unroll
    for (int t = 0; t < K; ++t)
      before[t] = cd < d[t] || (cd == d[t] && ci < i[t]);
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      if (before[t]) {
        d[t] = before[t - 1] ? d[t - 1] : cd;
        i[t] = before[t - 1] ? i[t - 1] : ci;
      }
    }
    if (before[0]) {
      d[0] = cd;
      i[0] = ci;
    }
  }

  // Inserts a scored pair when it is in view.  The gate is multiplicative,
  // as in the TPU kernel: out of view when
  // rel_h < cos_thr * max(sqrt(d2), 1e-8).  The self pair is pinned to
  // (d2, rel_h) = (0, 0), which the gate excludes for cos_thr > 0.
  __device__ __forceinline__ void offer(float d2, float dx, float dy,
                                        float hx, float hy, bool self_pair,
                                        float cos_thr, int id) {
    const float rel_h = pair_rel_h(dx, dy, hx, hy, self_pair);
    if (behind(rel_h, cos_thr)) return;
    if (rel_h < cos_thr * fmaxf(sqrtf(d2), 1e-8f)) return;
    push(d2, id);
  }

  // Scores one pair and inserts it when it is in view and ranks.  A pair
  // whose d2 exceeds the current k-th distance cannot enter the list, so
  // it is rejected before the sqrt of the field-of-view gate; a tie takes
  // the full path (its id decides).
  __device__ __forceinline__ void score(float xa, float ya, float hx,
                                        float hy, float xb, float yb,
                                        bool self_pair, float cos_thr,
                                        int id) {
    const float dx = xb - xa;
    const float dy = yb - ya;
    const float d2 = pair_d2(dx, dy, self_pair);
    if (d2 > d[K - 1]) return;
    offer(d2, dx, dy, hx, hy, self_pair, cos_thr, id);
  }

  // Whether (cd, ci) would enter the list.
  __device__ __forceinline__ bool ranks(float cd, int ci) const {
    return cd < d[K - 1] || (cd == d[K - 1] && ci < i[K - 1]);
  }

  // Slice-parallel merge of a block of kWarp rows: warp `slice` of
  // `slices` holds a partial list for row `lane`.  Warps 1.. publish their
  // lists in `sd` / `si` ((slices - 1) * K * kWarp entries each), and warp
  // 0 folds them into its own.  Every thread of the block must call it;
  // its first barrier lets `sd` / `si` alias buffers the walks used.
  __device__ __forceinline__ void merge(float* sd, int* si, int slice,
                                        int slices, int lane) {
    __syncthreads();
    if (slice > 0) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const int at = ((slice - 1) * K + t) * kWarp + lane;
        sd[at] = d[t];
        si[at] = i[t];
      }
    }
    __syncthreads();
    if (slice == 0) {
      for (int s = 0; s < slices - 1; ++s) {
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const int at = (s * K + t) * kWarp + lane;
          const float cd = sd[at];
          const int ci = si[at];
          // a published list is sorted on (d2, id), so once one entry
          // does not rank, none after it does (an empty slot never does)
          if (!(cd < CUDART_INF_F) || !ranks(cd, ci)) break;
          push(cd, ci);
        }
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
