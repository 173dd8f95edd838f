// MLAPM's all-pairs force law: for each agent i, the goal term minus
// sum_j where(gate_ij, mag_ij * R(+-theta) r_hat_ij, 0) over every agent j
// (replaces the plain pair pass of models/mlapm.py `_pair_terms`; the JAX
// package has no Pallas kernel for it: XLA fuses the law's pair arithmetic
// there, piml_tpu/models/mlapm.py `mlapm_force`).
//
// Work is N * N pair terms on 16 bytes an agent, each term some hundred
// lane instructions (two or three IEEE square roots and divisions, one
// expf), so the kernel is bound by arithmetic.  What the design does:
//
// - no pair tensor: a block holds 128 rows, one a thread, with each row's
//   position, masked velocity, goal direction and two accumulators in
//   registers; the block stages its columns' (x, y, vx, vy) through shared
//   memory as float4, which every lane reads as a broadcast 16-byte load;
// - N rows make only N / 128 blocks, too few for 132 SMs, so the columns
//   are split too (ops/mlapm.py `column_splits`): block (t, s) walks the
//   columns [s * cols_per_split, min(n, (s + 1) * cols_per_split)) and
//   writes its rows' partial sums to a (splits, N, 2) scratch; a second
//   small kernel adds the partials in split order and subtracts the sum
//   from the goal term.  No atomics: two calls give the same bits;
// - a pair with an absent (non-finite) member is skipped, since its term
//   is +0: generator scenes hold many absent slots;
// - the law is a template parameter: raw, GC, UCY and UCY with its
//   collision gate on the magnitude share the pair loop.
//
// Each pair term has the plain version's bits; only the order of the sum
// over j differs.  The library is built with --fmad=false, so no product
// is contracted into a multiply-add, and without fast math, so sqrtf and
// `/` are IEEE and expf is the accurate one, as in PyTorch's own kernels;
// each line below is one of the plain version's operations, in its order
// (vector_norm over a trailing dim of 2 is sqrtf(dx * dx + dy * dy) on the
// card, chip_smoke.py phase 3c).  The rotation's cos and sin are not taken
// here: the wrapper passes the values torch.cos and torch.sin give on the
// card for each class of the cross product's sign (> 0, < 0, 0, NaN).
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int kTileRows = 128;  // rows a block: one a thread
constexpr int kChunk = 512;     // columns a block stages at a time
constexpr int kMaxSplits = 64;
constexpr int kFinishThreads = 256;

// the floors of the plain version's clamp_min, as PyTorch converts them
constexpr float kUnitFloor = static_cast<float>(1e-12);
constexpr float kCosFloor = static_cast<float>(1e-8);

enum Law { kRaw = 0, kGC = 1, kUCY = 2, kUCYIntent = 3 };

struct Consts {
  float A, B, C, D;
  float coll;    // 2 * radius: UCY's collision distance
  float rot[8];  // (cos, sin) where the cross product is > 0, < 0, 0, NaN
};

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.where(isfinite(v), v, 0)
__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

struct Row {
  float x, y;    // p_i
  float vx, vy;  // v_i, each component masked by isfinite
  float ex, ey;  // e_i, the goal direction
};

// Adds the term of column q = (x_j, y_j, vx_j, vy_j) (velocity masked) on
// row a to (ax, ay).
template <int L>
__device__ __forceinline__ void add_pair(const Row& a, const float4 q,
                                         const Consts& k, float& ax,
                                         float& ay) {
  const float dx = q.x - a.x;  // vr = p_j - p_i
  const float dy = q.y - a.y;
  // a pair with an absent member: its vr_safe is 0, its gate false and its
  // term +0, which leaves the sum as it is
  if (!(isfinite(dx) && isfinite(dy))) return;
  const float r = sqrtf(dx * dx + dy * dy);
  const bool view = a.vx * dx + a.vy * dy > 0.0f;
  const bool gate = view && r > 0.0f;
  const float rn = clamp_min(r, kUnitFloor);
  float ux = dx / rn;  // direc
  float uy = dy / rn;
  float mag;
  if constexpr (L == kRaw) {
    mag = k.A * expf(k.B * r);
  } else {
    const float wx = q.z - a.vx;  // vv_j - vv_i
    const float wy = q.w - a.vy;
    const float cross = dx * a.ey - dy * a.ex;
    float c = k.rot[6], s = k.rot[7];
    if (cross == 0.0f) {
      c = k.rot[4];
      s = k.rot[5];
    }
    if (cross < 0.0f) {
      c = k.rot[2];
      s = k.rot[3];
    }
    if (cross > 0.0f) {
      c = k.rot[0];
      s = k.rot[1];
    }
    const float rx = c * ux - s * uy;
    const float ry = s * ux + c * uy;
    ux = rx;
    uy = ry;
    if constexpr (L == kGC) {
      const float na = clamp_min(r, kCosFloor);
      const float nb = clamp_min(sqrtf(wx * wx + wy * wy), kCosFloor);
      const float cs = (dx * wx + dy * wy) / (na * nb);
      mag = k.A * expf(k.B * r + k.C * cs + k.D * r * cs);
    } else {
      bool coll = r < k.coll;
      const float sx = dx + wx;
      const float sy = dy + wy;
      coll |= sqrtf(sx * sx + sy * sy) < k.coll;
      const float vv2 = clamp_min(wx * wx + wy * wy, kUnitFloor);
      const float rv = dx * wx + dy * wy;
      const float tmin = -rv / vv2;
      const float dmin2 = (dx * dx + dy * dy) - rv * rv / vv2;
      const float dmin = sqrtf(clamp_min(dmin2, 0.0f));
      coll |= tmin > 0.0f && tmin < 1.0f && dmin < k.coll;
      const float cf = coll ? 1.0f : 0.0f;
      mag = k.A * expf(k.B * r * cf + k.C * cf);
      if constexpr (L == kUCYIntent) mag = mag * cf;
    }
  }
  ax += gate ? mag * ux : 0.0f;
  ay += gate ? mag * uy : 0.0f;
}

// grid: (tiles, splits); block (t, s) takes rows [128 t, + 128) against
// the columns of split s, and writes their partial sums to partial[s].
template <int L>
__global__ void __launch_bounds__(kTileRows)
mlapm_pairs_kernel(const float2* __restrict__ pos,
                   const float2* __restrict__ vel,
                   const float2* __restrict__ dir, int n, int cols_per_split,
                   const Consts k, float2* __restrict__ partial) {
  __shared__ __align__(16) float4 stage[kChunk];

  const int i = blockIdx.x * kTileRows + threadIdx.x;
  Row a;
  if (i < n) {
    const float2 p = pos[i];
    const float2 v = vel[i];
    const float2 e = dir[i];
    a = Row{p.x, p.y, finite_or_zero(v.x), finite_or_zero(v.y), e.x, e.y};
  } else {  // past n: a NaN row meets no finite pair and is not written
    a = Row{CUDART_NAN_F, CUDART_NAN_F, 0.0f, 0.0f, 0.0f, 0.0f};
  }

  float ax = 0.0f, ay = 0.0f;
  const int lo = blockIdx.y * cols_per_split;
  const int hi = min(n, lo + cols_per_split);
  for (int c = lo; c < hi; c += kChunk) {
    const int len = min(kChunk, hi - c);
    __syncthreads();  // the previous chunk is read
    for (int j = threadIdx.x; j < len; j += kTileRows) {
      const float2 p = pos[c + j];
      const float2 v = vel[c + j];
      stage[j] = make_float4(p.x, p.y, finite_or_zero(v.x),
                             finite_or_zero(v.y));
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < len; ++j) add_pair<L>(a, stage[j], k, ax, ay);
  }
  if (i < n) partial[static_cast<size_t>(blockIdx.y) * n + i] =
      make_float2(ax, ay);
}

// out_i = goal_i - sum_s partial[s, i], the partials added in split order
__global__ void __launch_bounds__(kFinishThreads)
mlapm_finish_kernel(const float2* __restrict__ partial,
                    const float2* __restrict__ goal, int n, int splits,
                    float2* __restrict__ out) {
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= n) return;
  float2 sum = partial[i];
  for (int s = 1; s < splits; ++s) {
    const float2 t = partial[static_cast<size_t>(s) * n + i];
    sum.x += t.x;
    sum.y += t.y;
  }
  const float2 g = goal[i];
  out[i] = make_float2(g.x - sum.x, g.y - sum.y);
}

template <int L>
void launch_pairs(dim3 grid, cudaStream_t stream, const float2* pos,
                  const float2* vel, const float2* dir, int n,
                  int cols_per_split, const Consts& k, float2* partial) {
  mlapm_pairs_kernel<L><<<grid, kTileRows, 0, stream>>>(
      pos, vel, dir, n, cols_per_split, k, partial);
}

}  // namespace

// pos, vel, dir (the goal direction), goal (the goal term): (n, 2) float32;
// law: 0 raw, 1 GC, 2 UCY, 3 UCY with the collision gate on the
// magnitude; rot: 8 floats on the host, (cos, sin) where the cross product
// is > 0, < 0, 0, NaN; partial: (splits, n, 2) scratch; out: (n, 2).
extern "C" int piml_mlapm_force(const float* pos, const float* vel,
                                const float* dir, const float* goal, int n,
                                int splits, int cols_per_split, int law,
                                float A, float B, float C, float D,
                                float coll, const float* rot, float* partial,
                                float* out, void* stream) {
  if (n < 0 || law < kRaw || law > kUCYIntent || rot == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || splits > kMaxSplits || cols_per_split < 1 ||
      static_cast<long long>(splits) * cols_per_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts k{A, B, C, D, coll, {}};
  for (int t = 0; t < 8; ++t) k.rot[t] = rot[t];
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTileRows - 1) / kTileRows, splits);
  const auto* p = reinterpret_cast<const float2*>(pos);
  const auto* v = reinterpret_cast<const float2*>(vel);
  const auto* e = reinterpret_cast<const float2*>(dir);
  auto* part = reinterpret_cast<float2*>(partial);
  switch (law) {
    case kRaw:
      launch_pairs<kRaw>(grid, s, p, v, e, n, cols_per_split, k, part);
      break;
    case kGC:
      launch_pairs<kGC>(grid, s, p, v, e, n, cols_per_split, k, part);
      break;
    case kUCY:
      launch_pairs<kUCY>(grid, s, p, v, e, n, cols_per_split, k, part);
      break;
    default:
      launch_pairs<kUCYIntent>(grid, s, p, v, e, n, cols_per_split, k, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlapm_finish_kernel<<<(n + kFinishThreads - 1) / kFinishThreads,
                        kFinishThreads, 0, s>>>(
      part, reinterpret_cast<const float2*>(goal), n, splits,
      reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
