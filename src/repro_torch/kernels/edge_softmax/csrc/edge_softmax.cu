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
//   row's edges are one contiguous run, [starts[r], starts[r + 1]) from the
//   wrapper's row plan (kernels/heavy_rows.py).
//   Bound: memory. It reads the scores (E*H*4 bytes) and, through the
//   plan, the row ids (4*E), and writes the attention (E*H*4); the
//   exponentials are ~E*H*2 expf, far below the
//   card's float32 rate.
//   Design: heads in groups of up to kMaxHeads, one launch a group (one
//   launch for H <= 8). A thread takes an edge's heads of the group
//   together (one float4 at H = 4), so a row's edges are passed over three
//   times in all, not three times per head: the max, the sum of
//   expf(s - m), and the write of expf(s - m) / den. The rows with more
//   than heavy_edges edges take a whole 512-thread block each: the first
//   blocks of the grid, as many as fit on the card at once, walk the
//   plan's heavy list (those with more than 16 times as many edges first)
//   round robin; a block's 16 warps' partial maxima and sums combine
//   through shared memory in warp order. Every other row takes one warp,
//   16 rows a block, in row order (a warp whose row is heavy exits). Each
//   thread accumulates its own edges in a fixed order and a warp combines
//   its 32 partials with a fixed xor-shuffle butterfly: no atomics and no
//   block depends on another, so the result has the same bits on every run
//   (and every lane ends with the same sum, since a + b == b + a). expf is the precise one
//   (no --use_fast_math) and every add and divide is round-to-nearest; a
//   sum of deg terms in any fixed order rounds at most deg - 1 times, so
//   the result is within (deg + 4) * 2^-23 relative of the exact softmax.
//   What bounds it now: the three passes' loads, the hub row's (20,983
//   edges at chip_smoke.py's main-path shapes) 41 iterations a pass in one
//   block, and the row plan's two launches before it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "../../csrc/heavy_rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 16;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxHeads = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloor = -1e30f;
constexpr float kDenFloor = 1e-30f;

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

// the G heads of one edge at p (16-byte aligned float4s when VEC)
template <int G, bool VEC>
__device__ __forceinline__ void load_heads(const float* __restrict__ p,
                                           float (&v)[G]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + j);
      v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) v[j] = p[j];
  }
}

template <int G, bool VEC>
__device__ __forceinline__ void store_heads(float* __restrict__ p,
                                            const float (&v)[G]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < G; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) p[j] = v[j];
  }
}

// the softmax of heads h0 .. h0 + G over edges [lo, hi): this thread takes
// edges lo + first, lo + first + step, ...; `whole` when the block's
// threads share the row (their warps' partials meet in `part`), else a warp
template <int G, bool VEC>
__device__ __forceinline__ void softmax_row(const float* __restrict__ src,
                                            float* __restrict__ dst,
                                            long long lo, long long hi, int H,
                                            int first, int step, bool whole,
                                            float (*part)[G]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m[G];
#pragma unroll
  for (int j = 0; j < G; ++j) m[j] = kMaxFloor;
#pragma unroll 4
  for (long long e = lo + first; e < hi; e += step) {
    float v[G];
    load_heads<G, VEC>(src + e * H, v);
#pragma unroll
    for (int j = 0; j < G; ++j) m[j] = fmaxf(m[j], v[j]);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) m[j] = warp_max(m[j]);
  if (whole) {
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) part[warp][j] = m[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      m[j] = part[0][j];
      for (int k = 1; k < kWarpsPerBlock; ++k) m[j] = fmaxf(m[j], part[k][j]);
    }
    __syncthreads();  // part is reused for the sums
  }

  float den[G];
#pragma unroll
  for (int j = 0; j < G; ++j) den[j] = 0.f;
#pragma unroll 4
  for (long long e = lo + first; e < hi; e += step) {
    float v[G];
    load_heads<G, VEC>(src + e * H, v);
#pragma unroll
    for (int j = 0; j < G; ++j)
      den[j] = __fadd_rn(den[j], expf(__fsub_rn(v[j], m[j])));
  }
#pragma unroll
  for (int j = 0; j < G; ++j) den[j] = warp_sum(den[j]);
  if (whole) {
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) part[warp][j] = den[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      den[j] = part[0][j];
      for (int k = 1; k < kWarpsPerBlock; ++k)
        den[j] = __fadd_rn(den[j], part[k][j]);
    }
    __syncthreads();  // part is reused by the block's next row
  }
#pragma unroll
  for (int j = 0; j < G; ++j) den[j] = fmaxf(den[j], kDenFloor);

#pragma unroll 4
  for (long long e = lo + first; e < hi; e += step) {
    float v[G];
    load_heads<G, VEC>(src + e * H, v);
#pragma unroll
    for (int j = 0; j < G; ++j)
      v[j] = __fdiv_rn(expf(__fsub_rn(v[j], m[j])), den[j]);
    store_heads<G, VEC>(dst + e * H, v);
  }
}

// heads h0 .. h0 + G of every row. Blocks [0, n_whole) walk the plan's
// heavy list (block b its entries b, b + n_whole, ...) and take each row
// whole; the rest take one ordinary row a warp
template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_softmax_kernel(const float* __restrict__ scores,
                    const long long* __restrict__ starts,
                    const long long* __restrict__ heavy,
                    float* __restrict__ out, long long n_dst,
                    long long k_slots, long long n_whole,
                    long long heavy_edges, int H, int h0) {
  __shared__ float part[kWarpsPerBlock][G];
  const float* src = scores + h0;
  float* dst = out + h0;
  if (blockIdx.x < n_whole) {  // the same for the whole block
    for (long long i = blockIdx.x; i < k_slots; i += n_whole) {
      const long long r = heavy[i];
      if (r < 0) return;  // past the last heavy row
      softmax_row<G, VEC>(src, dst, starts[r], starts[r + 1], H, threadIdx.x,
                          kThreads, true, part);
    }
    return;
  }
  const long long r =
      (blockIdx.x - n_whole) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_dst) return;  // r is the same for the whole warp
  const long long lo = starts[r], hi = starts[r + 1];
  // a row without edges writes nothing; a heavy row has its own block
  if (lo == hi || hi - lo > heavy_edges) return;
  softmax_row<G, VEC>(src, dst, lo, hi, H, threadIdx.x & 31, 32, false, part);
}

template <int G, bool VEC>
void launch(const float* scores, const long long* starts,
            const long long* heavy, float* out, long long n_dst,
            long long k_slots, long long heavy_edges, int H, int h0,
            cudaStream_t stream) {
  const long long n_whole =
      k_slots == 0 ? 0
                   : std::min(k_slots, heavy_rows::resident_blocks(
                                           edge_softmax_kernel<G, VEC>,
                                           kThreads, 0));
  const long long grid =
      n_whole + (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_softmax_kernel<G, VEC><<<(unsigned)grid, kThreads, 0, stream>>>(
      scores, starts, heavy, out, n_dst, k_slots, n_whole, heavy_edges, H, h0);
}

template <int G>
void launch_group(bool vec, const float* scores, const long long* starts,
                  const long long* heavy, float* out, long long n_dst,
                  long long k_slots, long long heavy_edges, int H, int h0,
                  cudaStream_t stream) {
  if constexpr (G % 4 == 0) {
    if (vec) {
      launch<G, true>(scores, starts, heavy, out, n_dst, k_slots,
                      heavy_edges, H, h0, stream);
      return;
    }
  }
  launch<G, false>(scores, starts, heavy, out, n_dst, k_slots, heavy_edges,
                   H, h0, stream);
}

}  // namespace

extern "C" int edge_softmax_f32(const float* scores, const int* dst, float* out,
                                long long E, long long n_dst, long long H,
                                long long* starts, long long* heavy,
                                long long k_slots, long long heavy_edges,
                                cudaStream_t stream) {
  if (E <= 0 || n_dst <= 0 || H <= 0) return (int)cudaGetLastError();
  const int plan_err = heavy_rows::plan(dst, E, n_dst, heavy_edges, starts,
                                        heavy, k_slots, stream);
  if (plan_err != 0) return plan_err;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(scores) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  for (long long h0 = 0; h0 < H; h0 += kMaxHeads) {
    const int g = (int)(H - h0 < kMaxHeads ? H - h0 : kMaxHeads);
    // float4 loads need every edge's group 16-byte aligned
    const bool vec = aligned && H % 4 == 0;
#define EDGE_SOFTMAX_GROUP(G)                                             \
  case G:                                                                 \
    launch_group<G>(vec, scores, starts, heavy, out, n_dst, k_slots,      \
                    heavy_edges, (int)H, (int)h0, stream);                \
    break;
    switch (g) {
      EDGE_SOFTMAX_GROUP(1)
      EDGE_SOFTMAX_GROUP(2)
      EDGE_SOFTMAX_GROUP(3)
      EDGE_SOFTMAX_GROUP(4)
      EDGE_SOFTMAX_GROUP(5)
      EDGE_SOFTMAX_GROUP(6)
      EDGE_SOFTMAX_GROUP(7)
      EDGE_SOFTMAX_GROUP(8)
    }
#undef EDGE_SOFTMAX_GROUP
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}
