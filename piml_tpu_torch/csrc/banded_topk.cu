// K2: banded cell-list field-of-view top-k (replaces the Pallas kernels
// piml_tpu/ops/banded.py:116 `_kernel` and :128 `_kernel_dma`, which share
// `_tile_compute`).
//
// The agents arrive sorted by grid cell, so a tile of 128 consecutive rows
// is spatially coherent, and its 5x5 cell boxes all lie inside one
// contiguous window of the cell-sorted object table starting at
// ws[tile] * 128.  One block per tile streams that window through shared
// memory; each thread keeps K1's register top-k for its row, with ties
// broken by the lowest ORIGINAL object id (the table is in cell order, not
// id order).  Work is N * window pair evaluations; the TPU's resident and
// DMA variants differ only in where the table lives, which on this card
// is always device memory, read once per tile.
//
// Channels: the JAX package vmaps this kernel over the window channels of
// the BPTT finetune, which batches the pallas_call into one more grid
// axis.  Here blockIdx.y is the channel.  Rows, window starts and outputs
// are per channel; the object table and grid geometry are per channel
// (agent pass: each channel bins its own agents) or shared (obstacle pass:
// stride 0).  With one channel the launch is the single-frame one.
#include "topk_common.cuh"

namespace {

constexpr int kTileN = 128;  // rows per tile: the window arithmetic's unit
constexpr int kLane = 128;   // window starts are in units of 128 columns
constexpr int kChunk = 512;  // window columns per shared-memory chunk

// per channel c (blockIdx.y):
// rows: (n_pad, 8) [x, y, hx, hy, valid, self_id, 0, 0], cell-sorted;
// cols: (6, m_band) [x; y; valid; oid; cx; cy], cell-sorted, at
//   c * cols_cstride;
// geo: [lo_x, lo_y, cs_x, cs_y] at c * geo_cstride;
// ws: (n_pad / 128,) window starts / 128; out: (n_pad, K)
template <int K>
__global__ void __launch_bounds__(kTileN)
banded_topk_kernel(const int* __restrict__ ws, const float* __restrict__ geo,
                   int geo_cstride, const float* __restrict__ rows,
                   int n_pad, const float* __restrict__ cols, int m_band,
                   int cols_cstride, int window, int grid_dim, float cos_thr,
                   int self_pairs, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sv[kChunk];
  __shared__ float so[kChunk];
  __shared__ float scx[kChunk];
  __shared__ float scy[kChunk];

  const size_t c = blockIdx.y;
  ws += c * (n_pad / kTileN);
  geo += c * geo_cstride;
  rows += c * n_pad * piml::kRowStride;
  cols += c * cols_cstride;
  out_d += c * n_pad * K;
  out_i += c * n_pad * K;

  const int r = blockIdx.x * kTileN + threadIdx.x;
  const float* row = rows + static_cast<size_t>(r) * piml::kRowStride;
  const float xa = row[0];
  const float ya = row[1];
  const float hx = row[2];
  const float hy = row[3];
  const float va = row[4];
  const float self_id = row[5];
  const bool active = !(va < 0.5f);

  // the agent's cell, by the same f32 expression as the host side's
  // clip(floor((x - lo) / cs), 0, G - 1), so the in-kernel box and the
  // exactness predicate's box agree
  const float gmax = static_cast<float>(grid_dim - 1);
  const float axa = fminf(fmaxf(floorf((xa - geo[0]) / geo[2]), 0.0f), gmax);
  const float aya = fminf(fmaxf(floorf((ya - geo[1]) / geo[3]), 0.0f), gmax);

  const int start = ws[blockIdx.x] * kLane;
  piml::TopK<K> top;
  top.init();
  for (int c0 = 0; c0 < window; c0 += kChunk) {
    const int len = min(kChunk, window - c0);
    const float* base = cols + start + c0;
    for (int j = threadIdx.x; j < len; j += kTileN) {
      sx[j] = base[j];
      sy[j] = base[m_band + j];
      sv[j] = base[2 * m_band + j];
      so[j] = base[3 * m_band + j];
      scx[j] = base[4 * m_band + j];
      scy[j] = base[5 * m_band + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < len; ++j) {
        if (sv[j] < 0.5f) continue;
        // 5x5 cell-box membership
        if (!(fabsf(scx[j] - axa) <= 2.0f && fabsf(scy[j] - aya) <= 2.0f))
          continue;
        const float d2 = piml::pair_d2(xa, ya, hx, hy, sx[j], sy[j],
                                       self_pairs && so[j] == self_id,
                                       cos_thr);
        if (d2 < CUDART_INF_F) top.push(d2, static_cast<int>(so[j]));
      }
    }
    __syncthreads();
  }
  top.store(out_d + static_cast<size_t>(r) * K,
            out_i + static_cast<size_t>(r) * K);
}

}  // namespace

extern "C" int piml_banded_topk(const int* ws, const float* geo,
                                int geo_cstride, const float* rows,
                                int n_pad, int channels, const float* cols,
                                int m_band, int cols_cstride, int window,
                                int grid_dim, float cos_thr, int self_pairs,
                                int k, float* out_d, int* out_i,
                                void* stream) {
  if (n_pad <= 0 || channels <= 0) return static_cast<int>(cudaSuccess);
  if (n_pad % kTileN != 0 || window <= 0 || channels > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_pad / kTileN, channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIML_LAUNCH_K2(K)                                                  \
  banded_topk_kernel<K><<<grid, kTileN, 0, s>>>(                          \
      ws, geo, geo_cstride, rows, n_pad, cols, m_band, cols_cstride,       \
      window, grid_dim, cos_thr, self_pairs, out_d, out_i)
  PIML_DISPATCH_K(k, PIML_LAUNCH_K2)
#undef PIML_LAUNCH_K2
  return static_cast<int>(cudaGetLastError());
}
