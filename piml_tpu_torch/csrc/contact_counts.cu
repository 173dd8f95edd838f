// Contact counts: for each agent of each frame, the number of other agents
// closer than a threshold, for one or two thresholds in one pass (replaces
// the plain pair pass of ops/contacts.py `contact_counts_plain`; the JAX
// package has no Pallas kernel for it: XLA reduces its (..., N, N) pair
// tensor, piml_tpu/physics/features.py `collision_detection_single_frame`).
//
// Work is frames * N * N pair tests on 8 bytes an agent, so the kernel is
// bound by the per-pair arithmetic.  What the design does about it:
//
// - no pair tensor: a block holds 64 rows of one frame, two a lane, and
//   splits the frame's columns into `slices` contiguous ranges, one warp
//   each (ops/contacts.py `column_slices`); each warp stages its columns
//   through a private shared-memory chunk and every lane reads them as
//   broadcast 16-byte loads, two columns at a time;
// - the distance is never taken: sqrtf is correctly rounded and monotone,
//   so sqrtf(d2) < thr exactly when d2 < b, b the least float whose sqrtf
//   is not below thr (`sqrt_bound`, on the host); a NaN d2 fails every
//   compare, as a NaN distance does;
// - a pair costs its two differences, two products, their sum and one
//   compare against the larger bound, or-ed into a flag over a group of
//   kGroup columns; a lane recounts a group by threshold only when its
//   flag is set, which at crowd densities is rare;
// - the warps' partial counts are summed in shared memory and each row's
//   counts are written once, as exact small integers in f32.
//
// The plain version's semantics, bit for bit (the library is built with
// --fmad=false, so no product is contracted into a multiply-add):
// count_i = sum_j where(isnan(dist_ij), 0, (dist_ij < thr) - (i == j)),
// dist_ij = sqrtf(dx * dx + dy * dy), dx = x_j - x_i, dy = y_j - y_i, which
// is what torch.linalg.vector_norm computes over a trailing dim of 2 on the
// card (chip_smoke.py checks the form against it).  The self pair is
// counted like any other and taken off at the end where its d2 is not NaN.
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTileRows = 2 * kWarp;  // rows a block: two a lane
constexpr int kMaxSlices = 8;
constexpr int kChunk = 256;  // columns a warp stages at a time
constexpr int kGroup = 16;   // columns tested before a lane may recount

__device__ __forceinline__ float pair_d2(float2 a, float bx, float by) {
  const float dx = bx - a.x;
  const float dy = by - a.y;
  return dx * dx + dy * dy;
}

// pos: (frames, n) agents as (x, y); grid: tiles * frames blocks, block
// b takes rows [64 (b % tiles), + 64) of frame b / tiles; warp s walks
// columns [s * cols_per_slice, min(n, (s + 1) * cols_per_slice)).
// out1 is null for one threshold.
__global__ void __launch_bounds__(kWarp * kMaxSlices)
contact_counts_kernel(const float2* __restrict__ pos, int n, int tiles,
                      int cols_per_slice, float b0, float b1,
                      float* __restrict__ out0, float* __restrict__ out1) {
  __shared__ __align__(16) float2 stage[kMaxSlices][kChunk];
  __shared__ int part[kMaxSlices - 1][4][kWarp];

  const int lane = threadIdx.x % kWarp;
  const int slice = threadIdx.x / kWarp;
  const int slices = blockDim.x / kWarp;
  const size_t frame = blockIdx.x / tiles;
  const int ra = (blockIdx.x % tiles) * kTileRows + lane;
  const int rb = ra + kWarp;
  const float2* p = pos + frame * n;
  const float2 absent = make_float2(CUDART_NAN_F, CUDART_NAN_F);
  // rows past n are NaN: they count nothing and are not written
  const float2 a = ra < n ? p[ra] : absent;
  const float2 b = rb < n ? p[rb] : absent;
  const float bmax = fmaxf(b0, b1);

  int ca0 = 0, ca1 = 0, cb0 = 0, cb1 = 0;
  float2* sx = stage[slice];
  const int lo = slice * cols_per_slice;
  const int hi = min(n, lo + cols_per_slice);
  for (int c = lo; c < hi; c += kChunk) {
    const int len = min(kChunk, hi - c);
    // columns past the chunk's end read as NaN, which no compare counts
    for (int j = lane; j < kChunk; j += kWarp) sx[j] = j < len ? p[c + j]
                                                               : absent;
    __syncwarp();
    for (int g = 0; g < len; g += kGroup) {
      const float4* q = reinterpret_cast<const float4*>(sx + g);
      bool near = false;
#pragma unroll
      for (int t = 0; t < kGroup / 2; ++t) {
        const float4 v = q[t];
        near |= pair_d2(a, v.x, v.y) < bmax;
        near |= pair_d2(a, v.z, v.w) < bmax;
        near |= pair_d2(b, v.x, v.y) < bmax;
        near |= pair_d2(b, v.z, v.w) < bmax;
      }
      if (near) {
#pragma unroll 4
        for (int t = 0; t < kGroup; ++t) {
          const float2 v = sx[g + t];
          const float da = pair_d2(a, v.x, v.y);
          const float db = pair_d2(b, v.x, v.y);
          ca0 += da < b0;
          ca1 += da < b1;
          cb0 += db < b0;
          cb1 += db < b1;
        }
      }
    }
    __syncwarp();
  }

  if (slice > 0) {
    part[slice - 1][0][lane] = ca0;
    part[slice - 1][1][lane] = ca1;
    part[slice - 1][2][lane] = cb0;
    part[slice - 1][3][lane] = cb1;
  }
  __syncthreads();
  if (slice != 0) return;
  for (int s = 0; s < slices - 1; ++s) {
    ca0 += part[s][0][lane];
    ca1 += part[s][1][lane];
    cb0 += part[s][2][lane];
    cb1 += part[s][3][lane];
  }
  // the self pair: counted above where d2 = 0 < b, taken off where its
  // d2 is not NaN (a non-finite coordinate makes it NaN)
  const int sa = !isnan(pair_d2(a, a.x, a.y));
  const int sb = !isnan(pair_d2(b, b.x, b.y));
  float* o0 = out0 + frame * n;
  float* o1 = out1 ? out1 + frame * n : nullptr;
  if (ra < n) {
    o0[ra] = static_cast<float>(ca0 - sa);
    if (o1) o1[ra] = static_cast<float>(ca1 - sa);
  }
  if (rb < n) {
    o0[rb] = static_cast<float>(cb0 - sb);
    if (o1) o1[rb] = static_cast<float>(cb1 - sb);
  }
}

// The least b >= 0 with sqrtf(b) >= thr, so that for every d2 >= 0 or NaN,
// sqrtf(d2) < thr exactly when d2 < b: sqrtf is correctly rounded on host
// and card alike, and monotone.  A NaN or non-positive thr gives 0, below
// which no d2 lies, as no distance lies below such a thr.
float sqrt_bound(float thr) {
  if (!(thr > 0.0f)) return 0.0f;
  float b = thr * thr;
  while (b > 0.0f && sqrtf(nextafterf(b, 0.0f)) >= thr)
    b = nextafterf(b, 0.0f);
  while (sqrtf(b) < thr) b = nextafterf(b, INFINITY);
  return b;
}

}  // namespace

extern "C" int piml_contact_counts(const float* pos, int frames, int n,
                                   int slices, int cols_per_slice,
                                   int thresholds, float thr0, float thr1,
                                   float* out0, float* out1, void* stream) {
  if (frames < 0 || n < 0 || thresholds < 1 || thresholds > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if ((thresholds == 2) != (out1 != nullptr) || slices < 1 ||
      slices > kMaxSlices || cols_per_slice < 1 ||
      static_cast<long long>(slices) * cols_per_slice < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const long long blocks = static_cast<long long>(tiles) * frames;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float b0 = sqrt_bound(thr0);
  const float b1 = thresholds == 2 ? sqrt_bound(thr1) : 0.0f;
  contact_counts_kernel<<<static_cast<unsigned>(blocks), kWarp * slices, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(pos), n, tiles, cols_per_slice, b0, b1,
      out0, out1);
  return static_cast<int>(cudaGetLastError());
}
