// K2: banded cell-list field-of-view top-k (replaces the Pallas kernels
// piml_tpu/ops/banded.py:116 `_kernel` and :128 `_kernel_dma`, which share
// `_tile_compute`).
//
// The agents arrive sorted by grid cell, so a tile of 128 consecutive rows
// is spatially coherent, and its 5x5 cell boxes all lie inside one
// contiguous window of the cell-sorted object table starting at
// ws[tile] * 128.  The table is sorted by cell id cx * G + cy (invalid and
// padding columns last), so a row's box is five contiguous column ranges,
// one per cell column cx - 2 .. cx + 2, whose ends are two entries of the
// table's per-cell offsets; clipping them to the window keeps exactly the
// columns the plain version's "window and box and valid" mask admits, also
// on a tile whose window overflowed (the exactness predicate still flags
// it).  ops/banded.py `box_ranges` computes the same ranges on the host.
//
// Work is the in-box pairs only (~66 a row for agents, ~103 for obstacles
// at the dense-stress shape, against windows of 1,792 and 1,280 columns),
// and the bytes are the rows, the touched columns and the outputs, so the
// kernel is bound by latency and occupancy: scalar compare and select,
// with nothing for tensor cores, wgmma or TMA tiles to do.  What the
// design does about it:
//
// - parallelism: a block holds 32 consecutive cell-sorted rows (one per
//   lane) and 5 warps; warp s walks range s of its lane's row, with its
//   own register top-k.  At N = 12,685 that is 400 blocks of 5 warps, ~15
//   warps on each of the 132 SMs, where a thread per row left ~3;
// - the ranges of neighbouring lanes start a few columns apart (their rows
//   share a cell column), so a warp-wide column load touches one or two
//   cache lines; columns come through the read-only cache.  Staging the
//   tile's window in shared memory in one go timed within 2 % of this on
//   the passes the rollout launches (PERF.md), and would cap the window
//   at what shared memory holds;
// - a pair whose d2 exceeds the row's current k-th distance is rejected
//   before the sqrt of the field-of-view gate (TopK::score);
// - the 5 partial lists are merged in shared memory by warp 0; ties break
//   on (d2, original object id), so the result is the plain version's, bit
//   for bit.
//
// Channels: the JAX package vmaps this kernel over the window channels of
// the BPTT finetune, which batches the pallas_call into one more grid
// axis.  Here blockIdx.y is the channel.  Rows, window starts and outputs
// are per channel; the object table, its offsets and the grid geometry are
// per channel (agent pass: each channel bins its own agents) or shared
// (obstacle pass: stride 0).  With one channel the launch is the
// single-frame one.
#include "topk_common.cuh"

namespace {

constexpr int kTileN = 128;  // rows per window start
constexpr int kLane = 128;   // window starts are in units of 128 columns
constexpr int kSlices = 5;   // warps per block: one per cell column of the box

// per channel c (blockIdx.y):
// rows: (n_pad, 8) [x, y, hx, hy, valid, self_id, 0, 0], cell-sorted;
// cols: (6, m_band) [x; y; valid; oid; cx; cy], cell-sorted, at
//   c * cols_cstride; offsets: (G * G + 2,) first column of each cell id,
//   at c * offsets_cstride;
// geo: [lo_x, lo_y, cs_x, cs_y] at c * geo_cstride;
// ws: (n_pad / 128,) window starts / 128; out: (n_pad, K)
template <int K>
__global__ void __launch_bounds__(piml::kWarp * kSlices)
banded_topk_kernel(const int* __restrict__ ws, const float* __restrict__ geo,
                   int geo_cstride, const float* __restrict__ rows,
                   int n_pad, const float* __restrict__ cols, int m_band,
                   int cols_cstride, const long long* __restrict__ offsets,
                   int offsets_cstride, int window, int grid_dim,
                   float cos_thr, int self_pairs, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
  __shared__ float sd[(kSlices - 1) * K * piml::kWarp];
  __shared__ int si[(kSlices - 1) * K * piml::kWarp];

  const size_t c = blockIdx.y;
  ws += c * (n_pad / kTileN);
  geo += c * geo_cstride;
  rows += c * n_pad * piml::kRowStride;
  cols += c * cols_cstride;
  offsets += c * offsets_cstride;
  out_d += c * n_pad * K;
  out_i += c * n_pad * K;

  const int lane = threadIdx.x % piml::kWarp;
  const int slice = threadIdx.x / piml::kWarp;
  const int r = blockIdx.x * piml::kWarp + lane;
  const float* row = rows + static_cast<size_t>(r) * piml::kRowStride;
  const float xa = row[0];
  const float ya = row[1];
  const float hx = row[2];
  const float hy = row[3];
  const float va = row[4];
  const float self_id = row[5];

  const float* cx = cols;
  const float* cy = cols + m_band;
  const float* co = cols + 3 * static_cast<size_t>(m_band);

  // the agent's cell, by the same f32 expression as the host side's
  // clip(floor((x - lo) / cs), 0, G - 1), so the kernel's box and the
  // exactness predicate's box agree
  const float gmax = static_cast<float>(grid_dim - 1);
  const int ax = static_cast<int>(
      fminf(fmaxf(floorf((xa - geo[0]) / geo[2]), 0.0f), gmax));
  const int ay = static_cast<int>(
      fminf(fmaxf(floorf((ya - geo[1]) / geo[3]), 0.0f), gmax));
  const int bx = ax - 2 + slice;  // this warp's cell column of the box
  int lo = 0, hi = 0;
  if (!(va < 0.5f) && bx >= 0 && bx < grid_dim) {
    // the box column's cells bx * G + y0 .. bx * G + y1, clipped to the
    // tile's window
    const long long start = static_cast<long long>(ws[r / kTileN]) * kLane;
    const long long end = start + window;
    const int y0 = max(ay - 2, 0);
    const int y1 = min(ay + 2, grid_dim - 1);
    const long long first = __ldg(offsets + bx * grid_dim + y0);
    const long long last = __ldg(offsets + bx * grid_dim + y1 + 1);
    const long long l = min(max(first, start), end);
    lo = static_cast<int>(l);
    hi = static_cast<int>(min(max(last, l), end));
  }

  piml::TopK<K> top;
  top.init();
  for (int j = lo; j < hi; ++j) {
    const float oid = __ldg(co + j);
    top.score(xa, ya, hx, hy, __ldg(cx + j), __ldg(cy + j),
              self_pairs && oid == self_id, cos_thr, static_cast<int>(oid));
  }
  top.merge(sd, si, slice, kSlices, lane);
  if (slice == 0) {
    top.store(out_d + static_cast<size_t>(r) * K,
              out_i + static_cast<size_t>(r) * K);
  }
}

}  // namespace

extern "C" int piml_banded_topk(const int* ws, const float* geo,
                                int geo_cstride, const float* rows,
                                int n_pad, int channels, const float* cols,
                                int m_band, int cols_cstride,
                                const long long* offsets,
                                int offsets_cstride, int window,
                                int grid_dim, float cos_thr, int self_pairs,
                                int k, float* out_d, int* out_i,
                                void* stream) {
  if (n_pad <= 0 || channels <= 0) return static_cast<int>(cudaSuccess);
  if (n_pad % kTileN != 0 || window <= 0 || channels > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_pad / piml::kWarp, channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIML_LAUNCH_K2(K)                                                  \
  banded_topk_kernel<K><<<grid, piml::kWarp * kSlices, 0, s>>>(           \
      ws, geo, geo_cstride, rows, n_pad, cols, m_band, cols_cstride,       \
      offsets, offsets_cstride, window, grid_dim, cos_thr, self_pairs,     \
      out_d, out_i)
  PIML_DISPATCH_K(k, PIML_LAUNCH_K2)
#undef PIML_LAUNCH_K2
  return static_cast<int>(cudaGetLastError());
}
