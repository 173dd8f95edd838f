// K1: dense streaming field-of-view top-k (replaces the Pallas kernel
// piml_tpu/ops/pairwise.py:91 `_kernel`).
//
// One thread per query agent keeps a register top-k of (d2, object id);
// the object table streams through shared memory in chunks that every
// thread of the block reads.  Work is N * M pair evaluations of ~20
// floating-point operations; the table is read once per block, so device
// memory traffic is O(N * M / TILE_N) and the kernel is bound by the
// per-pair arithmetic and the insertion compare chain.
#include "topk_common.cuh"

namespace {

constexpr int kTileN = 64;    // query rows per block (one per thread)
constexpr int kChunk = 1024;  // object columns per shared-memory chunk

// rows: (n, 8) [x, y, hx, hy, valid, ...]; cols: (3, m) [x; y; valid]
template <int K>
__global__ void __launch_bounds__(kTileN)
pairwise_topk_kernel(const float* __restrict__ rows, int n,
                     const float* __restrict__ cols, int m, float cos_thr,
                     int self_pairs, float* __restrict__ out_d,
                     int* __restrict__ out_i) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sv[kChunk];

  const int r = blockIdx.x * kTileN + threadIdx.x;
  const bool live = r < n;
  float xa = 0.f, ya = 0.f, hx = 0.f, hy = 0.f, va = 0.f;
  if (live) {
    const float* row = rows + static_cast<size_t>(r) * piml::kRowStride;
    xa = row[0];
    ya = row[1];
    hx = row[2];
    hy = row[3];
    va = row[4];
  }
  const bool active = live && !(va < 0.5f);

  piml::TopK<K> top;
  top.init();
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int len = min(kChunk, m - c0);
    for (int j = threadIdx.x; j < len; j += kTileN) {
      sx[j] = cols[c0 + j];
      sy[j] = cols[m + c0 + j];
      sv[j] = cols[2 * m + c0 + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < len; ++j) {
        if (sv[j] < 0.5f) continue;
        const int id = c0 + j;
        const float d2 = piml::pair_d2(xa, ya, hx, hy, sx[j], sy[j],
                                       self_pairs && id == r, cos_thr);
        if (d2 < CUDART_INF_F) top.push(d2, id);
      }
    }
    __syncthreads();
  }
  if (live) {
    top.store(out_d + static_cast<size_t>(r) * K,
              out_i + static_cast<size_t>(r) * K);
  }
}

}  // namespace

extern "C" int piml_pairwise_topk(const float* rows, int n, const float* cols,
                                  int m, float cos_thr, int self_pairs, int k,
                                  float* out_d, int* out_i, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kTileN - 1) / kTileN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIML_LAUNCH_K1(K)                                               \
  pairwise_topk_kernel<K><<<grid, kTileN, 0, s>>>(rows, n, cols, m,     \
                                                  cos_thr, self_pairs,  \
                                                  out_d, out_i)
  PIML_DISPATCH_K(k, PIML_LAUNCH_K1)
#undef PIML_LAUNCH_K1
  return static_cast<int>(cudaGetLastError());
}
