// Per-destination segment softmax over a graph's edges (GAT's attention
// normaliser), hand written for Hopper (sm_90a). Plain C entry point, loaded
// with ctypes by repro_torch/kernels/edge_softmax/ops.py; it launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// edge_softmax_f32 replaces edge_softmax_kernel
// (src/repro/kernels/edge_softmax/edge_softmax.py:40):
//   for every destination row r and head h, over the edges e with
//   dst[e] == r (dst sorted ascending):
//     m   = max(max_e scores[e, h], -1e30)
//     den = max(sum_e expf(scores[e, h] - m), 1e-30)
//     out[e, h] = expf(scores[e, h] - m) / den
//   the function of the reference's edge_softmax_ref, with its -1e30 max
//   floor and 1e-30 denominator clamp. The TPU kernel's layout is not
//   carried over: it packed each 128-row destination block's edges into a
//   padded tile and reduced over a one-hot (E_tile, 128) membership matrix
//   on the VPU. Here the edges are already sorted by destination, so each
//   row's edges are one contiguous run, found by binary search.
//   Bound: memory. It reads the scores and the row ids (E*H*4 + 4*E bytes)
//   and writes the attention (E*H*4); the exponentials are ~E*H*3 expf,
//   far below the card's float32 rate.
//   Design: one warp per destination row (8 rows per 256-thread block).
//   Lane 0 binary-searches the row's edge range [lo, hi) in the sorted dst
//   (integer arithmetic only) and broadcasts it with a shuffle. For each
//   head, three lane-strided passes over the row's edges: the max, the sum
//   of expf(s - m), and the write of expf(s - m) / den. Each lane
//   accumulates its own edges in a fixed order and the warp combines the 32
//   partials with a fixed xor-shuffle butterfly: no atomics and no block
//   depends on another, so the result has the same bits on every run (and
//   every lane ends with the same sum, since a + b == b + a). expf is the
//   precise one (no --use_fast_math) and every add and divide is
//   round-to-nearest, so the result is within (deg + 4) * 2^-23 relative of
//   the exact softmax.
//   Known limit: a power-law hub row's edges all run in one warp (max
//   in-degree 20,983 at chip_smoke.py's main-path shapes), three passes per
//   head, while the rest of the grid drains. Splitting hub rows across a
//   block, and one pass over all heads at once, are the first things a
//   performance pass should look at.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloor = -1e30f;
constexpr float kDenFloor = 1e-30f;

// first index e in [0, E) with dst[e] >= key (E when none)
__device__ long long lower_bound(const int* __restrict__ dst, long long E,
                                 long long key) {
  long long lo = 0, hi = E;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)dst[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void edge_softmax_kernel(const float* __restrict__ scores,
                                    const int* __restrict__ dst,
                                    float* __restrict__ out, long long E,
                                    long long n_dst, int H) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_dst) return;  // r is the same for the whole warp
  long long lo = 0, hi = 0;
  if (lane == 0) {
    lo = lower_bound(dst, E, r);
    hi = lower_bound(dst, E, r + 1);
  }
  lo = __shfl_sync(kFull, lo, 0);
  hi = __shfl_sync(kFull, hi, 0);
  if (lo == hi) return;  // a row without edges writes nothing
  for (int h = 0; h < H; ++h) {
    float m = kMaxFloor;
    for (long long e = lo + lane; e < hi; e += 32) m = fmaxf(m, scores[e * H + h]);
    m = warp_max(m);
    float s = 0.f;
    for (long long e = lo + lane; e < hi; e += 32)
      s = __fadd_rn(s, expf(__fsub_rn(scores[e * H + h], m)));
    const float den = fmaxf(warp_sum(s), kDenFloor);
    for (long long e = lo + lane; e < hi; e += 32)
      out[e * H + h] = __fdiv_rn(expf(__fsub_rn(scores[e * H + h], m)), den);
  }
}

}  // namespace

extern "C" int edge_softmax_f32(const float* scores, const int* dst, float* out,
                                long long E, long long n_dst, long long H,
                                cudaStream_t stream) {
  if (E <= 0 || n_dst <= 0 || H <= 0) return (int)cudaGetLastError();
  const long long grid = (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_softmax_kernel<<<(unsigned)grid, kWarpsPerBlock * 32, 0, stream>>>(
      scores, dst, out, E, n_dst, (int)H);
  return (int)cudaGetLastError();
}
