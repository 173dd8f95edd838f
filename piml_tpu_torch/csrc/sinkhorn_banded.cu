// The banded Sinkhorn's iteration on the card: each half-update, the
// iteration's error, stop gate and exactness proof, and the final
// transport-cost pass (replaces the torch iteration of
// metrics/ot_banded.py `sinkhorn_banded`, which it runs on CPU tensors; the
// JAX package has no Pallas kernel for it: XLA computes the same banded
// tensors there, piml_tpu/metrics/ot_banded.py `sinkhorn_banded`).
//
// Both clouds are cell-sorted on one grid; each 128-row tile of one side
// reads one window of `window` consecutive entries of the other side's
// sorted table (ops/sinkhorn.py).  A half-update sets, for every query row
// i of a tile and every column j of its window,
//   M_ij = pv_ij ? -d2_ij / eps + pot_j / eps : NEG_BIG,
// the row's logsumexp ls_i, its new potential eps (log_marg_i - ls_i) (0 on
// an invalid row) and its proof that every term outside the window is
// below 1e-12 of ls_i.  At 12,685 agents a half-update is 12,800 x 1,280 =
// 16.4 M window terms; a frame runs 201 such passes (100 iterations and
// the cost), 3.29 G terms, of which some 57 % pair two valid points in the
// window's true span (1.88 G).  Each such term is one expf and some ten
// other f32 operations, each an instruction under --fmad=false: on the
// H100's 132 SMs at 1.98 GHz the exp unit (16 a clock an SM) bounds a frame
// at 0.45 ms and the other operations at 0.56 ms, so the pass is bound by
// operations, not by its few MB of positions and potentials.  What the
// design does:
//
// - no pair tensor: a block holds 128 rows, one a thread, with the row's
//   position and its running (max, sum of exp) in registers; the block
//   stages its columns' (x, y, potential / eps) through shared memory as
//   float4, which every lane reads as a broadcast 16-byte load.  Columns
//   past the window's true span or invalid in the table add NEG_BIG
//   terms: they are counted, not staged, so their exp is taken once a
//   slice and not once a term;
// - 100 tiles are fewer than the card's 132 SMs, so each tile's true span
//   is split into column slices of equal width (ops/sinkhorn.py
//   `column_slices`: 20 at this size, 2,000 blocks); block (t, s) writes
//   its rows' (max, sum) for slice s to a (slices, rows, 2) scratch, with
//   an online logsumexp over its columns;
// - a small finish kernel merges each row's slices in slice order, sets
//   the new potential and the row's proof, and reduces the error, the
//   potential's largest valid value (the next half's proof reads it) and
//   the proof over the rows: each block writes its partials, and the last
//   block to finish (an integer ticket) adds them in block order.  No float
//   atomics: two calls give the same bits, so the iteration count, the stop
//   test and `exact` do not change from run to run;
// - the iteration's gate lives on the card: a half-update whose frame has
//   stopped (error below the threshold) writes nothing, as the torch
//   iteration's `where(active, ...)` keeps its state; the host reads the
//   gate every few iterations, as it does there.
//
// A half-update is two launches, an iteration four, the cost pass two; one
// library call launches a run of iterations, between two host reads of
// the gate.
// Terms are the torch iteration's, in its order of operations (the library
// is built with --fmad=false and without fast math, so expf and logf are
// the accurate ones, as in PyTorch's kernels); the sums are taken in
// another order, so values agree to float32 rounding, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int kTileRows = 128;  // rows a block of the slice kernel
constexpr int kWarps = kTileRows / 32;
constexpr int kFinishThreads = 256;
constexpr int kMaxSlices = 64;
constexpr float kNegBig = -1e9f;  // metrics.py NEG_BIG

// state_f and state_i: the frame's iteration state on the card
enum StateF { kErr = 0, kWmax0 = 1, kWmax1 = 2, kCost = 3, kLogM = 4 };
enum StateI { kActive = 0, kExact = 1, kIterations = 2, kOk0 = 3,
              kTicket = 4 };

}  // namespace

// One side of the frame: its cell-sorted rows and their windows into the
// other side's table.  ops/sinkhorn.py `_Side` mirrors this layout.
struct PimlSinkhornSide {
  const float* pos;            // (rows, 2) positions, sorted
  const float* valid;          // (rows,) 1 or 0
  const float* consts;         // (rows, 4): log marginal, -bound^2,
                               // log1p(bound^2), trivially ok (1 or 0)
  const long long* start;      // (rows / 128,) first lane of each window
  const long long* win_end;    // (rows / 128,) end of each window's span
  float* pot;                  // (rows,) this side's potential
  int rows;                    // a multiple of 128
  int tiles;                   // rows / 128
};

namespace {

// One more term x, `weight` times, in a running (max m, sum s of exp(. - m)).
__device__ __forceinline__ void lse_add(float x, float weight, float& m,
                                        float& s) {
  if (x > m) {
    s = s * expf(m - x) + weight;
    m = x;
  } else {
    s += weight * expf(x - m);
  }
}

// grid: (tiles, slices); block (t, s) takes rows [128 t, + 128) of side q
// against slice s of its window's true span in side t's table: the span,
// [0, min(window, win_end - start)) of the window's columns, is cut into
// gridDim.y slices of equal width, so the blocks of a tile share its valid
// columns evenly; the columns past the span are NEG_BIG terms, counted by
// slice 0.  kCostPass: the transport cost's terms
// exp(A + (u_i + v_j) / eps) * (-A * eps), summed; else the half-update's
// running (max, sum of exp) of M_ij.
template <bool kCostPass>
__global__ void __launch_bounds__(kTileRows)
sinkhorn_slice_kernel(const PimlSinkhornSide q, const PimlSinkhornSide t,
                      int window, float eps, float inv_eps,
                      const int* __restrict__ state_i,
                      float2* __restrict__ part) {
  if (!kCostPass && state_i[kActive] == 0) return;  // the frame stopped
  __shared__ __align__(16) float4 stage[kTileRows];
  __shared__ int warp_valid[kWarps];

  const int i = blockIdx.x * kTileRows + threadIdx.x;
  const float2 qp = reinterpret_cast<const float2*>(q.pos)[i];
  const bool row_valid = q.valid[i] > 0.5f;
  const float ui = kCostPass ? q.pot[i] : 0.0f;
  const long long base = q.start[blockIdx.x] * kTileRows;
  const long long end = min(q.win_end[blockIdx.x],
                            static_cast<long long>(t.rows));
  const int span = static_cast<int>(
      max(0LL, min(end - base, static_cast<long long>(window))));
  const int cols = (span + gridDim.y - 1) / gridDim.y;
  const int lo = blockIdx.y * cols;
  const int hi = min(span, lo + cols);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float m = -CUDART_INF_F, s = 0.0f;  // running max and sum (cost: s only)
  int absent = blockIdx.y == 0 ? window - span : 0;  // NEG_BIG columns
  for (int c = lo; c < hi; c += kTileRows) {
    const int j = c + threadIdx.x;
    const long long idx = base + j;
    const bool take = j < hi && t.valid[idx] > 0.5f;
    float4 col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (take) {
      const float2 p = reinterpret_cast<const float2*>(t.pos)[idx];
      // the half's column term pot_j / eps, the cost's v_j
      col = make_float4(p.x, p.y, kCostPass ? t.pot[idx]
                                            : t.pot[idx] * inv_eps, 0.0f);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    __syncthreads();  // the previous chunk is read
    if (lane == 0) warp_valid[warp] = __popc(ballot);
    __syncthreads();
    int at = __popc(ballot & ((1u << lane) - 1u)), staged = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_valid[w] : 0;
      staged += warp_valid[w];
    }
    if (take) stage[at] = col;  // the valid columns, in window order
    absent += min(kTileRows, hi - c) - staged;
    __syncthreads();
    if (!row_valid) continue;  // an invalid row's terms are never read
#pragma unroll 4
    for (int k = 0; k < staged; ++k) {
      const float4 tc = stage[k];
      const float dx = tc.x - qp.x;
      const float dy = tc.y - qp.y;
      const float d2 = dx * dx + dy * dy;
      const float a = -d2 * inv_eps;  // A = -d2 / eps
      if (kCostPass) {
        const float mm = a + (ui + tc.z) * inv_eps;
        s += expf(mm) * (-a * eps);
      } else {
        lse_add(a + tc.z, 1.0f, m, s);
      }
    }
  }
  if (!kCostPass && absent > 0) lse_add(kNegBig, absent, m, s);
  part[static_cast<size_t>(blockIdx.y) * q.rows + i] = make_float2(m, s);
}

// Block-wide reduction of (sum, max, and) over kFinishThreads threads in a
// fixed tree order (within each warp, then over the warps); thread 0 gets
// the result.
__device__ __forceinline__ void block_reduce(float& sum, float& mx, int& ok) {
  __shared__ float w_sum[kFinishThreads / 32];
  __shared__ float w_max[kFinishThreads / 32];
  __shared__ int w_ok[kFinishThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
    ok &= __shfl_down_sync(0xffffffffu, ok, o);
  }
  if (lane == 0) {
    w_sum[warp] = sum;
    w_max[warp] = mx;
    w_ok[warp] = ok;
  }
  __syncthreads();
  if (warp != 0) return;
  constexpr int kWarpsF = kFinishThreads / 32;
  sum = lane < kWarpsF ? w_sum[lane] : 0.0f;
  mx = lane < kWarpsF ? w_max[lane] : -CUDART_INF_F;
  ok = lane < kWarpsF ? w_ok[lane] : 1;
  for (int o = kWarpsF / 2; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
    ok &= __shfl_down_sync(0xffffffffu, ok, o);
  }
}

// Writes this block's partial to blk and returns true in the last block
// to do so, which then reduces every block's partial in block order (the
// ticket is reset for the next launch).
__device__ bool last_block_reduce(float& sum, float& mx, int& ok,
                                  float4* __restrict__ blk, int* ticket) {
  __shared__ bool is_last;
  block_reduce(sum, mx, ok);
  if (threadIdx.x == 0) {
    blk[blockIdx.x] = make_float4(sum, mx, static_cast<float>(ok), 0.0f);
    __threadfence();
    is_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  sum = 0.0f;
  mx = -CUDART_INF_F;
  ok = 1;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
       b += kFinishThreads) {
    const float4 p = __ldcg(&blk[b]);
    sum += p.x;
    mx = fmaxf(mx, p.y);
    ok &= p.z != 0.0f;
  }
  __syncthreads();  // block_reduce's shared arrays are free again
  block_reduce(sum, mx, ok);
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

// One row a thread: merge the slices of row i in slice order into its
// logsumexp ls_i, set its new potential and its proof; side 0 (the first
// half) also sums the error |u_new - u| over valid rows.  The last block
// writes the side's largest valid potential and proof, and side 1 closes
// the iteration: exact &= ok_0 & ok_1, iterations += 1, and the gate of
// the next iteration, err >= thresh.
__global__ void __launch_bounds__(kFinishThreads)
sinkhorn_finish_kernel(const PimlSinkhornSide q, int side, int slices,
                       float eps, float inv_eps, float log_tol, float thresh,
                       const float2* __restrict__ part,
                       float* __restrict__ state_f, int* __restrict__ state_i,
                       float4* __restrict__ blk) {
  if (state_i[kActive] == 0) return;
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  float err = 0.0f, wmax = -CUDART_INF_F;
  int ok = 1;
  if (i < q.rows) {
    const float qv = q.valid[i];
    const bool valid = qv > 0.5f;
    const float4 c = reinterpret_cast<const float4*>(q.consts)[i];
    float fresh = 0.0f;
    if (valid) {
      float mx = -CUDART_INF_F;
#pragma unroll 8
      for (int s = 0; s < slices; ++s)
        mx = fmaxf(mx, part[static_cast<size_t>(s) * q.rows + i].x);
      float sum = 0.0f;
#pragma unroll 8
      for (int s = 0; s < slices; ++s) {
        const float2 p = part[static_cast<size_t>(s) * q.rows + i];
        sum += p.y * expf(p.x - mx);
      }
      const float ls = logf(sum) + mx;
      fresh = eps * (c.x - ls);
      wmax = fresh;
      // every window-excluded term is <= e^log_tol of ls; the log1p term
      // extends it to the cost's tail (ot_banded.py `half_update`)
      const float other = state_f[kWmax0 + 1 - side];
      const float margin = (c.y + other) * inv_eps + state_f[kLogM] + c.z
                           - ls;
      ok = c.w != 0.0f || margin <= log_tol;
    } else {
      ok = c.w != 0.0f;
    }
    if (side == 0) err = fabsf((fresh - q.pot[i]) * qv);
    q.pot[i] = fresh;
  }
  if (!last_block_reduce(err, wmax, ok, blk, &state_i[kTicket])) return;
  if (threadIdx.x != 0) return;
  state_f[kWmax0 + side] = wmax;
  if (side == 0) {
    state_f[kErr] = err;
    state_i[kOk0] = ok;
  } else {
    state_i[kExact] &= state_i[kOk0] & ok;
    state_i[kIterations] += 1;
    state_i[kActive] = state_f[kErr] >= thresh;
  }
}

// The transport cost: each row's slices added in slice order, the rows in
// block order, into state_f[kCost].
__global__ void __launch_bounds__(kFinishThreads)
sinkhorn_cost_kernel(int rows, int slices, const float2* __restrict__ part,
                     float* __restrict__ state_f, int* __restrict__ state_i,
                     float4* __restrict__ blk) {
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  float sum = 0.0f, unused = 0.0f;
  int ok = 1;
  if (i < rows) {
#pragma unroll 8
    for (int s = 0; s < slices; ++s)
      sum += part[static_cast<size_t>(s) * rows + i].y;
  }
  if (!last_block_reduce(sum, unused, ok, blk, &state_i[kTicket])) return;
  if (threadIdx.x == 0) state_f[kCost] = sum;
}

// True where the sides are not whole tiles, the slices are out of range,
// or part (float2 entries) or blk (float4 entries) is too short for the
// launches: part holds a (max, sum) a slice a row, blk a partial a finish
// block.
bool bad_args(const PimlSinkhornSide* sides, int window, int slices,
              long long part_len, int blk_len) {
  if (sides == nullptr) return true;
  int rows = 0;
  for (int k = 0; k < 2; ++k) {
    if (sides[k].rows < kTileRows || sides[k].rows % kTileRows ||
        sides[k].tiles != sides[k].rows / kTileRows)
      return true;
    rows = sides[k].rows > rows ? sides[k].rows : rows;
  }
  if (window < 1 || slices < 1 || slices > kMaxSlices) return true;
  return part_len < static_cast<long long>(slices) * rows ||
         blk_len < (rows + kFinishThreads - 1) / kFinishThreads;
}

// One half-update of side `side` (0: the rows of x against y's table, 1:
// the reverse): the slice kernel and the finish kernel.
cudaError_t half_update(const PimlSinkhornSide* sides, int side, int window,
                        int slices, float eps, float inv_eps, float log_tol,
                        float thresh, float* state_f, int* state_i,
                        float2* part, float4* blk, cudaStream_t stream) {
  const PimlSinkhornSide& q = sides[side];
  sinkhorn_slice_kernel<false><<<dim3(q.tiles, slices), kTileRows, 0,
                                  stream>>>(q, sides[1 - side], window, eps,
                                            inv_eps, state_i, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sinkhorn_finish_kernel<<<(q.rows + kFinishThreads - 1) / kFinishThreads,
                           kFinishThreads, 0, stream>>>(
      q, side, slices, eps, inv_eps, log_tol, thresh, part, state_f, state_i,
      blk);
  return cudaGetLastError();
}

}  // namespace

// `iterations` Sinkhorn iterations, each a half-update of x then of y; an
// iteration whose frame has stopped writes nothing.  sides: two
// PimlSinkhornSide on the host (x, y); state_f: err, the two sides' largest
// valid potential, the cost, log(max(nx, ny, 2)); state_i: the gate,
// exact, iterations, side 0's proof, the finish kernels' ticket; part:
// (slices, rows, 2) scratch of part_len float2 entries, rows the larger
// side's; blk: blk_len float4 entries, one a finish block.
extern "C" int piml_sinkhorn_iterations(const PimlSinkhornSide* sides,
                                        int iterations, int window,
                                        int slices, float eps, float inv_eps,
                                        float log_tol, float thresh,
                                        float* state_f, int* state_i,
                                        float* part, long long part_len,
                                        float* blk, int blk_len,
                                        void* stream) {
  if (bad_args(sides, window, slices, part_len, blk_len) || iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* p = reinterpret_cast<float2*>(part);
  auto* b = reinterpret_cast<float4*>(blk);
  for (int it = 0; it < iterations; ++it)
    for (int side = 0; side < 2; ++side) {
      const cudaError_t err = half_update(sides, side, window, slices, eps,
                                          inv_eps, log_tol, thresh, state_f,
                                          state_i, p, b, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  return static_cast<int>(cudaSuccess);
}

// The transport cost on the window pairs of x's rows, from both sides'
// potentials, into state_f[3].
extern "C" int piml_sinkhorn_cost(const PimlSinkhornSide* sides, int window,
                                  int slices, float eps, float inv_eps,
                                  float* state_f, int* state_i, float* part,
                                  long long part_len, float* blk,
                                  int blk_len, void* stream) {
  if (bad_args(sides, window, slices, part_len, blk_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const PimlSinkhornSide& q = sides[0];
  const auto s = static_cast<cudaStream_t>(stream);
  auto* p = reinterpret_cast<float2*>(part);
  sinkhorn_slice_kernel<true><<<dim3(q.tiles, slices), kTileRows, 0, s>>>(
      q, sides[1], window, eps, inv_eps, state_i, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_cost_kernel<<<(q.rows + kFinishThreads - 1) / kFinishThreads,
                         kFinishThreads, 0, s>>>(
      q.rows, slices, p, state_f, state_i, reinterpret_cast<float4*>(blk));
  return static_cast<int>(cudaGetLastError());
}
