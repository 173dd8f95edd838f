// K1: dense streaming field-of-view top-k (replaces the Pallas kernel
// piml_tpu/ops/pairwise.py:91 `_kernel`).
//
// Work is N * M pair evaluations; the table (12 bytes a column) and the
// rows are read once from device memory, so the kernel is bound by the
// per-pair arithmetic and, on this card, by the latency of that scalar
// compare-and-select chain: there is nothing for tensor cores, wgmma or
// TMA tiles to do.  What the design does about it:
//
// - parallelism: a block holds 32 query rows (one per lane) and splits the
//   M columns into `slices` contiguous ranges, one warp each, every warp
//   with its own register top-k (ops/pairwise.py `column_slices` picks the
//   count);
// - each warp stages its own columns through a private shared-memory
//   chunk as (x, y) pairs, with a validity bit mask per 32 columns from a
//   ballot: coalesced loads, __syncwarp only, no block barrier, and one
//   broadcast 8-byte load per column.  No column is read by two warps of a
//   block, so staging the whole table at once buys no reuse, only fewer
//   blocks on each SM (timed 77 % slower over 12,685 columns, PERF.md);
// - a pair whose d2 exceeds the row's current k-th distance is rejected
//   before the sqrt of the field-of-view gate, and so is a pair behind the
//   agent.  Lanes hold different rows, so one lane's rare candidate would
//   stall its warp on every column; instead each lane marks its
//   candidates among 32 columns in a bit mask (against its k-th distance
//   before the group), and the warp then scores the marked pairs,
//   diverging for as many rounds as its busiest lane has candidates;
// - the slices of a row share, in shared memory, the least k-th distance
//   any of them holds: the row's final k-th distance is no larger, so a
//   pair beyond it cannot rank, and each slice rejects against it as soon
//   as one slice's list is full, where its own list may still be filling;
// - the slices' partial lists are merged in shared memory by warp 0.
//   Ties break on (d2, column id) in every list, so the merged result is
//   the plain version's, bit for bit, whatever the split.
#include "topk_common.cuh"

namespace {

constexpr int kMaxSlices = 8;
constexpr int kChunk = 256;  // columns a warp stages in shared memory
constexpr int kGroups = kChunk / piml::kWarp;

// staging and the merge's lists share the block's shared memory: the merge
// starts with a barrier, after every walk has ended
template <int K>
union Smem {
  struct {
    float2 xy[kMaxSlices][kChunk];
    unsigned valid[kMaxSlices][kGroups];  // bit t: column 32 g + t is valid
  } stage;
  struct {
    float d[(kMaxSlices - 1) * K * piml::kWarp];
    int i[(kMaxSlices - 1) * K * piml::kWarp];
  } merge;
};

// rows: (n, 8) [x, y, hx, hy, valid, ...]; cols: (3, m) [x; y; valid];
// blockDim.x = 32 * slices; warp s walks columns
// [s * cols_per_slice, min(m, (s + 1) * cols_per_slice))
template <int K>
__global__ void __launch_bounds__(piml::kWarp * kMaxSlices)
pairwise_topk_kernel(const float* __restrict__ rows, int n,
                     const float* __restrict__ cols, int m,
                     int cols_per_slice, float cos_thr, int self_pairs,
                     float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ Smem<K> sm;
  // per row: the least k-th d2 of its slices' full lists, as the bits of a
  // non-negative float (which order as ints)
  __shared__ int row_kth[piml::kWarp];

  const int lane = threadIdx.x % piml::kWarp;
  const int slice = threadIdx.x / piml::kWarp;
  const int slices = blockDim.x / piml::kWarp;
  float2* sxy = sm.stage.xy[slice];
  unsigned* svalid = sm.stage.valid[slice];

  const int r = blockIdx.x * piml::kWarp + lane;
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
  // a pair behind the agent (rel_h < 0) cannot rank when the field of view
  // is at most 180 degrees (piml::behind)
  const float behind_lim = cos_thr >= 0.0f ? 0.0f : -CUDART_INF_F;

  if (slice == 0) row_kth[lane] = __float_as_int(CUDART_INF_F);
  __syncthreads();
  const volatile int* shared_kth = row_kth;

  piml::TopK<K> top;
  top.init();
  const int c_lo = slice * cols_per_slice;
  const int c_hi = min(m, c_lo + cols_per_slice);
  for (int c0 = c_lo; c0 < c_hi; c0 += kChunk) {
    const int len = min(kChunk, c_hi - c0);
    // stage the chunk; columns past its end read as invalid
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = g * piml::kWarp + lane;
      float x = 0.0f, y = 0.0f;
      bool valid = false;
      if (j < len) {
        x = cols[c0 + j];
        y = cols[m + c0 + j];
        valid = !(cols[2 * m + c0 + j] < 0.5f);
      }
      sxy[j] = make_float2(x, y);
      const unsigned mask = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) svalid[g] = mask;
    }
    __syncwarp();
    for (int g0 = 0; g0 < len; g0 += piml::kWarp) {
      // every lane marks, among 32 columns, the pairs that may rank against
      // its row's k-th distance as it stood before the group, then scores
      // them: the warp diverges for as many rounds as its busiest lane has
      // candidates, not once per column that any lane needs
      const float kth =
          fminf(top.d[K - 1], __int_as_float(shared_kth[lane]));
      unsigned cand = 0;
#pragma unroll
      for (int t = 0; t < piml::kWarp; ++t) {
        const float2 p = sxy[g0 + t];
        const float dx = p.x - xa;
        const float dy = p.y - ya;
        const bool may = !(dx * dx + dy * dy > kth) &&
                         !(dx * hx + dy * hy < behind_lim);
        cand |= static_cast<unsigned>(may) << t;
      }
      const unsigned valid = svalid[g0 / piml::kWarp];
      cand &= valid;
      // the self pair is pinned to (d2, rel_h) = (0, 0) whatever its
      // offset, so it is always scored
      const unsigned ts = static_cast<unsigned>(r - c0 - g0);
      if (self_pairs && ts < 32u) cand |= (1u << ts) & valid;
      if (!active) cand = 0;
      while (cand) {
        const int j = g0 + __ffs(cand) - 1;
        cand &= cand - 1;
        const int id = c0 + j;
        const bool self_pair = self_pairs && id == r;
        const float2 p = sxy[j];
        const float dx = p.x - xa;
        const float dy = p.y - ya;
        top.offer(piml::pair_d2(dx, dy, self_pair), dx, dy, hx, hy,
                  self_pair, cos_thr, id);
      }
      if (top.d[K - 1] < CUDART_INF_F)
        atomicMin(&row_kth[lane], __float_as_int(top.d[K - 1]));
    }
    __syncwarp();
  }
  top.merge(sm.merge.d, sm.merge.i, slice, slices, lane);
  if (slice == 0 && live) {
    top.store(out_d + static_cast<size_t>(r) * K,
              out_i + static_cast<size_t>(r) * K);
  }
}

}  // namespace

extern "C" int piml_pairwise_topk(const float* rows, int n, const float* cols,
                                  int m, int slices, int cols_per_slice,
                                  float cos_thr, int self_pairs, int k,
                                  float* out_d, int* out_i, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  if (slices < 1 || slices > kMaxSlices || cols_per_slice < 1 ||
      static_cast<long long>(slices) * cols_per_slice < m)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + piml::kWarp - 1) / piml::kWarp);
  const dim3 block(piml::kWarp * slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIML_LAUNCH_K1(K)                                                 \
  pairwise_topk_kernel<K><<<grid, block, 0, s>>>(rows, n, cols, m,        \
                                                 cols_per_slice, cos_thr, \
                                                 self_pairs, out_d, out_i)
  PIML_DISPATCH_K(k, PIML_LAUNCH_K1)
#undef PIML_LAUNCH_K1
  return static_cast<int>(cudaGetLastError());
}
