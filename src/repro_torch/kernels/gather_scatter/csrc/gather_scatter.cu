// Row gather and fused gather+aggregate for the SSO forward hot path, the
// sorted scatter-add of the backward's grad write-back, and the segment sum
// of every message-passing layer, hand written for Hopper (sm_90a). Plain C
// entry points, loaded with ctypes by repro_torch/kernels/gather_scatter/
// ops.py; each launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// gather_rows_f32 replaces gather_rows_pallas
// (src/repro/kernels/gather_scatter/gather_scatter.py:50):
//   out[i, :] = table[rows[i], :], a bitwise row copy out of the staged
//   partition stack (the forward regather).
//   Bound: memory. It moves 2*R*D*4 bytes and computes nothing.
//   Design: a 2-D block, threadIdx.x over the columns of one row and
//   threadIdx.y over rows, so neighbouring threads touch neighbouring
//   addresses and every warp reads one contiguous run of a source row. Each
//   thread moves 16 B (float4) when D % 4 == 0 and both pointers are 16 B
//   aligned, one float otherwise. The TPU kernel's per-row DMA grid and its
//   128-lane column padding have no counterpart: blocks run in parallel and
//   the ragged edge is masked.
//
// gather_aggregate_f32 replaces gather_aggregate_pallas
// (src/repro/kernels/gather_scatter/gather_scatter.py:91):
//   out[r, :] = sum over edges e with dst[e] == r, in edge order, of
//   w[e] * table[erows[e], :], from zero, with dst sorted ascending.
//   Each output element is one fused multiply-add chain, __fmaf_rn(w, x,
//   acc), over its row's edges in edge order, so the result equals the
//   exact FMA oracle (ref.gather_aggregate_fma_np) bitwise, whichever
//   block computes it, and the reference's float64 oracle
//   (ref.gather_aggregate_ref_fma) but where that rounds twice.
//   Bound: memory. It reads each edge's source row (E*D*4 bytes, less where
//   L2 catches repeats), writes n_dst*D*4 and reads 8*E of indices and
//   weights. A row's FMA chain is deg dependent FMAs (~4 cycles each), so
//   the hub row of chip_smoke.py's main-path unit (20,983 edges) cannot
//   finish in less than ~45 us however it is spread.
//   Design: the launch first makes the row plan on the device
//   (../../csrc/heavy_rows.cuh; no host synchronisation) into scratch from
//   the wrapper: each row's edge range (starts) and the rows with more than
//   heavy_edges edges, those with more than 16x as many first, each group
//   in row order. Then two launches, no atomics, no block depends on
//   another:
//   - Heavy rows first, split wide: each row into slabs of 32 lanes' V
//     columns (V = float4 at D % 4 == 0 with 16-byte aligned bases: 128
//     columns; else float: 32), each (row, slab) an item of a persistent
//     grid that deals the items round robin down the list. A block is four
//     producer warps and a consumer warp around a 64 KB shared-memory ring
//     of 32-edge stages (4 stages of float4 slabs, 16 of float slabs):
//     producer lane c copies V column c of each edge's slab, and lane j
//     edge j's weight, with cp.async, arriving on the stage's mbarrier
//     when they land; the producers take turns by stage, so four source-id
//     loads are in flight at once; consumer lane c runs its columns' chains
//     out of shared memory. So the hub row runs on D / 128 SMs at once (8
//     at D = 1,024) with 64 KB in flight on each.
//   - Then every other row in natural row order (the reordered graph's L2
//     reuse): one block per (row, column tile), each thread one float4 (or
//     one float) column, kUnroll edges' source values loaded ahead of the
//     chain and the next kUnroll edges' indices and weights behind them; a
//     block whose row is heavy exits.
//   The TPU kernel's sequential grid carried the sum in VMEM across grid
//   steps; here a loop inside one block (or one warp) takes that role.
//   What bounds it now: both launches' source-row reads through L2 and
//   HBM (the heavy rows hold most of a power-law unit's edges: 77% at
//   chip_smoke.py's main shape, T = 256), no longer the hub row: its
//   chain (~45 us) runs beside the rest.

// scatter_add_f32 replaces scatter_add_pallas
// (src/repro/kernels/gather_scatter/gather_scatter.py:141):
//   base[rows[i], :] += values[i, :] in place, rows sorted ascending (they
//   may repeat): the backward's grad write-back into a partition's buffer.
//   Duplicate rows add in input order, one plain round-to-nearest add each
//   (__fadd_rn, never contracted into an FMA), starting from base's value,
//   so the result equals a sequential np.add.at bitwise. Rows that are not
//   touched keep base's bits: the TPU kernel aliased base into its output,
//   here the kernel writes into base itself and never reads the rest.
//   Bound: memory. It reads the values (R*D*4 bytes) and the R row ids
//   (4*R), and reads and writes each of the U touched rows once (2*U*D*4).
//   Design: no atomics, and no block depends on another. Each run of equal
//   row ids (a segment) is owned by exactly one thread per column: the
//   thread whose value row starts the segment (i == 0 or rows[i] !=
//   rows[i-1]) walks to the end of the segment, adding into a register that
//   starts at base[row]; the other threads exit. The 2-D block is
//   gather_rows': threadIdx.x over the columns (float4 when D % 4 == 0 and
//   both pointers are 16 B aligned, one float otherwise), threadIdx.y over
//   value rows. The TPU wrapper's 128-lane column padding has no
//   counterpart: any D is taken.
//
// scatter_add_host_f32 also replaces scatter_add_pallas, where the engine
// runs the write-back: the same add, in the same order, but base is a
// page-locked host buffer (the partition's grad buffer in the host cache),
// which the kernel reads and writes in place through its mapped device
// address; rows and values are on the card (the unit's ∇GA, which the
// backward computed there). So the buffer never crosses the link whole.
//   Bound: bytes over the host link, not HBM. Each of the U touched base
//   rows crosses it once each way (2*U*D*4 bytes); values and row ids are
//   read from HBM. A read over the link takes microseconds to return.
//   Design: one warp per value row; the warp whose row starts a segment
//   owns it, as above, and its lanes first start all their base loads of a
//   chunk of kHostLoads 16-byte columns a lane (kHostLoads * 512 bytes a
//   warp in flight, a whole 1,024-wide row at once), then add the
//   segment's values in input order (__fadd_rn) and store each column
//   once. Neighbouring lanes touch neighbouring 16 bytes, so each warp
//   load is one 512-byte run of a row. Eight warps a block, a block per
//   eight value rows: a write-back pair's rows are all in flight at once.

// segment_sum_f32 replaces no TPU kernel: the JAX package leaves its
// segment sums (jax.ops.segment_sum) to XLA. It is the card's seg_sum
// (repro_torch/models/gnn/layers.py): every message-passing sum over dst
// and every row gather's backward, a sum over its source ids.
//   out[r, :] = sum over edges i with seg[i] == r of x[i, :], from +0, in
//   a fixed order: the wrapper stable-sorts the ids (keys) with their
//   positions (perm), so a segment's edges lie in edge order; a segment of
//   at most K edges sums them in that order, one __fadd_rn each (bitwise
//   a sequential np.add.at, and the CPU's index_add_); a longer one is cut
//   into chunks of K consecutive edges from its start, each chunk summed
//   in edge order from +0, and the chunk sums are added in chunk order.
//   The same bits on every run and under any launch setting: no atomics,
//   and each output element is one fixed chain of adds.
//   Bound: memory. It reads each edge's row (E*D*4 bytes), the sorted ids
//   and positions (12*E), and writes n*D*4, plus each long segment's chunk
//   sums once each way (at most 2*ceil(E/K) rows).
//   Design: PyTorch's own index_put_(accumulate=True) gives each distinct
//   id one warp that walks its duplicates with a read-modify-write of the
//   output row each, so the longest segment (a plan's padded tail: tens of
//   thousands of edges into row 0) sets the time of a launch. Here the
//   launch first finds each segment's edge range in the sorted ids
//   (row_starts_kernel of ../../csrc/heavy_rows.cuh; no host
//   synchronisation), then:
//   - segment_sum_slots_kernel, a thread a segment: each chunk of a
//     segment of more than K edges writes its first sorted position into
//     its slot, 2 * (p / K) for a chunk of K edges and 2 * (p / K) + 1 for
//     a shorter (last) one: two full chunks never start in one K-tile of
//     positions, nor two short ones, so slots are distinct and there are
//     2 * ceil(E / K) of them (an unused slot keeps the wrapper's -1);
//   - segment_sum_chunks_kernel, a thread per (slot, V column): the
//     chunk's sum in registers, kUnroll rows loaded ahead of the adds,
//     into the chunk-sum scratch;
//   - segment_sum_rows_kernel, a thread per (segment, V column), segments
//     in order: a segment of at most K edges sums its edges as above, a
//     longer one its chunk sums in chunk order; an empty one writes 0.
//   V is float4 where D % 4 == 0 with 16-byte aligned bases (a warp then
//   reads 512 contiguous bytes of a row), else float; a block is 256
//   threads, threadIdx.x over the columns (a warp multiple, or the power of
//   two at or above the columns below 32, so narrow sums pack rows into a
//   warp) and threadIdx.y over segments or slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "../../csrc/heavy_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;         // edges loaded ahead of an FMA chain
constexpr unsigned kFull = 0xffffffffu;
// heavy rows: items of one V (float4 or float) column a lane, 32 lanes; a
// ring of kRingBytes of 32-edge stages (4 stages of float4 slabs, 16 of
// float slabs) and their weights, filled by kProducers warps and drained
// by one consumer warp
constexpr int kStageEdges = 32;
constexpr int kRingBytes = 64 * 1024;
constexpr int kProducers = 4;
constexpr int kHeavyThreads = 32 * (kProducers + 1);

template <typename V>
struct Ring {
  static constexpr int kStages = kRingBytes / (kStageEdges * 32 * (int)sizeof(V));
  // producer p fills the stages q = p mod kProducers, so each slot has one
  // producer, which fills it round by round and so never waits on a
  // barrier phase of parity it has already seen: a producer two rounds
  // ahead would pass its parity wait a phase early
  static_assert(kStages % kProducers == 0, "each slot needs one producer");
  static constexpr int kWeights = kRingBytes;  // byte offset of the weights
  static constexpr int kBars = kWeights + kStages * kStageEdges * 4;
  static constexpr int kSmem = kBars + 2 * 8 * kStages;
};

__global__ void gather_rows_vec4_kernel(const float4* __restrict__ table,
                                        const int* __restrict__ rows,
                                        float4* __restrict__ out,
                                        long long R, long long D4) {
  long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  const float4* src = table + (long long)rows[r] * D4;
  float4* dst = out + r * D4;
  for (long long c = threadIdx.x; c < D4; c += blockDim.x) dst[c] = src[c];
}

__global__ void gather_rows_scalar_kernel(const float* __restrict__ table,
                                          const int* __restrict__ rows,
                                          float* __restrict__ out,
                                          long long R, long long D) {
  long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  const float* src = table + (long long)rows[r] * D;
  float* dst = out + r * D;
  for (long long c = threadIdx.x; c < D; c += blockDim.x) dst[c] = src[c];
}

__device__ __forceinline__ float fma_v(float w, float x, float acc) {
  return __fmaf_rn(w, x, acc);
}

__device__ __forceinline__ float4 fma_v(float w, float4 x, float4 acc) {
  return make_float4(__fmaf_rn(w, x.x, acc.x), __fmaf_rn(w, x.y, acc.y),
                     __fmaf_rn(w, x.z, acc.z), __fmaf_rn(w, x.w, acc.w));
}

template <typename V>
__device__ __forceinline__ V zero_v();
template <>
__device__ __forceinline__ float zero_v<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero_v<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// every row with heavy_edges edges or fewer, in row order: block (r, tile),
// thread = one V column of `cols`; a heavy row's blocks exit
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_aggregate_rows_kernel(const V* __restrict__ table,
                             const int* __restrict__ erows,
                             const float* __restrict__ w,
                             const long long* __restrict__ starts,
                             V* __restrict__ out, long long cols,
                             long long heavy_edges) {
  const long long r = blockIdx.x;
  const long long lo = starts[r], hi = starts[r + 1];
  if (hi - lo > heavy_edges) return;
  const long long c = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  // the indices and weights of the next kUnroll edges are loaded while the
  // current ones' source values are in flight
  int rn[kUnroll];
  float wn[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    rn[k] = lo + k < hi ? erows[lo + k] : 0;
    wn[k] = lo + k < hi ? w[lo + k] : 0.f;
  }
  V acc = zero_v<V>();
  long long e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    V x[kUnroll];
    float we[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      we[k] = wn[k];
      x[k] = table[(long long)rn[k] * cols + c];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long f = e + kUnroll + k;
      rn[k] = f < hi ? erows[f] : 0;
      wn[k] = f < hi ? w[f] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = fma_v(we[k], x[k], acc);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    if (e + k < hi) acc = fma_v(wn[k], table[(long long)rn[k] * cols + c], acc);
  out[r * cols + c] = acc;
}

// one heavy item: V columns c0 .. c0 + ncols of row `row`, edges [lo, hi)
struct HeavyItem {
  long long row, lo, hi;
  int c0, ncols;
};

// item i = (heavy[i / n_slab], slab i % n_slab) of 32 V columns; false
// past the list or at its first -1 (every later entry is -1 too)
__device__ __forceinline__ bool heavy_item(const long long* __restrict__ heavy,
                                           const long long* __restrict__ starts,
                                           long long n_items, long long n_slab,
                                           long long cols, long long i,
                                           HeavyItem* it) {
  if (i >= n_items) return false;
  const long long row = heavy[i / n_slab];
  if (row < 0) return false;
  it->row = row;
  it->lo = starts[row];
  it->hi = starts[row + 1];
  it->c0 = (int)(i % n_slab) * 32;
  it->ncols = (int)min(32ll, cols - it->c0);
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}

// returns once the phase of parity `parity` of the barrier has completed;
// a wait of more than ~2^34 cycles (seconds: no copy takes that long)
// traps, so a lost arrival fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// one V (4 or 16 bytes, aligned) from global to shared memory (cp.async;
// 16-byte copies bypass L1); the thread's copies so far complete on a
// barrier with cp_async_arrive
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async(uint32_t dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// one arrival on the barrier once every cp.async this thread has issued
// is complete (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// heavy rows: a persistent grid deals (row, slab) items, every warp of a
// block takes the same items. Producer warps p = 0 .. kProducers - 1 fill
// the stages q = p mod kProducers of the ring: lane j reads edge j's
// source row id, then lane c copies V column c of each edge's slab and
// lane j edge j's weight (cp.async), and each lane's copies arrive on the
// stage's "full" barrier. The consumer warp's lane c runs V column c's FMA
// chains out of shared memory and frees the stage
template <typename V>
__global__ void __launch_bounds__(kHeavyThreads)
gather_aggregate_heavy_kernel(const V* __restrict__ table,
                              const int* __restrict__ erows,
                              const float* __restrict__ w,
                              const long long* __restrict__ starts,
                              const long long* __restrict__ heavy,
                              V* __restrict__ out, long long cols,
                              long long n_items, long long n_slab) {
  using R = Ring<V>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);  // [stage][edge][32 columns]
  float* wring = reinterpret_cast<float*>(smem + R::kWeights);  // [stage][edge]
  const uint32_t full0 = smem_u32(smem + R::kBars);
  const uint32_t empty0 = full0 + 8 * R::kStages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // every producer lane's copies
      mbar_init(empty0 + 8 * s, 1);  // the consumer's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  long long q0 = 0;  // stages of this block's earlier items
  HeavyItem it;
  for (long long i = blockIdx.x;
       heavy_item(heavy, starts, n_items, n_slab, cols, i, &it);
       i += gridDim.x) {
    const long long n_st = (it.hi - it.lo + kStageEdges - 1) / kStageEdges;
    if (warp < kProducers) {
      const V* col = table + it.c0 + lane;
      const bool on = lane < it.ncols;
      for (long long k = (warp - q0 % kProducers + kProducers) % kProducers;
           k < n_st; k += kProducers) {
        const long long q = q0 + k, e0 = it.lo + k * kStageEdges;
        const int slot = (int)(q % R::kStages);
        const int n = (int)min((long long)kStageEdges, it.hi - e0);
        const int row = lane < n ? erows[e0 + lane] : 0;
        mbar_wait(empty0 + 8 * slot, (uint32_t)((q / R::kStages) & 1) ^ 1u);
        V* xs = ring + slot * kStageEdges * 32 + lane;
        for (int j = 0; j < n; ++j) {
          const int r = __shfl_sync(kFull, row, j);
          if (on) cp_async(smem_u32(xs + j * 32), col + (long long)r * cols);
        }
        if (lane < n)
          cp_async(smem_u32(wring + slot * kStageEdges + lane), w + e0 + lane);
        cp_async_arrive(full0 + 8 * slot);
      }
    } else {
      V acc = zero_v<V>();
      for (long long k = 0; k < n_st; ++k) {
        const long long q = q0 + k;
        const int slot = (int)(q % R::kStages);
        const int n =
            (int)min((long long)kStageEdges, it.hi - it.lo - k * kStageEdges);
        mbar_wait(full0 + 8 * slot, (uint32_t)((q / R::kStages) & 1));
        const V* xs = ring + slot * kStageEdges * 32 + lane;
        const float* ws = wring + slot * kStageEdges;
        if (n == kStageEdges) {
#pragma unroll
          for (int j = 0; j < kStageEdges; ++j)
            acc = fma_v(ws[j], xs[j * 32], acc);
        } else {
          for (int j = 0; j < n; ++j) acc = fma_v(ws[j], xs[j * 32], acc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      }
      if (lane < it.ncols) out[it.row * cols + it.c0 + lane] = acc;
    }
    q0 += n_st;
  }
}

// the first value row of a segment, or -1 (thread exits): rows[r] differs
// from its predecessor or r == 0
__device__ __forceinline__ int segment_row(const int* __restrict__ rows,
                                           long long r) {
  const int row = rows[r];
  return (r == 0 || rows[r - 1] != row) ? row : -1;
}

__global__ void scatter_add_vec4_kernel(float4* __restrict__ base,
                                        const int* __restrict__ rows,
                                        const float4* __restrict__ values,
                                        long long R, long long D4) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  const int row = segment_row(rows, r);
  if (row < 0) return;
  long long end = r + 1;
  while (end < R && rows[end] == row) ++end;
  float4* dst = base + (long long)row * D4;
  for (long long c = threadIdx.x; c < D4; c += blockDim.x) {
    float4 acc = dst[c];
    for (long long j = r; j < end; ++j) {
      const float4 v = values[j * D4 + c];
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    dst[c] = acc;
  }
}

__global__ void scatter_add_scalar_kernel(float* __restrict__ base,
                                          const int* __restrict__ rows,
                                          const float* __restrict__ values,
                                          long long R, long long D) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  const int row = segment_row(rows, r);
  if (row < 0) return;
  long long end = r + 1;
  while (end < R && rows[end] == row) ++end;
  float* dst = base + (long long)row * D;
  for (long long c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = dst[c];
    for (long long j = r; j < end; ++j) acc = __fadd_rn(acc, values[j * D + c]);
    dst[c] = acc;
  }
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// base is the device-mapped address of page-locked host memory: each warp
// owns one segment and keeps kHostLoads loads a lane in flight over the link
constexpr int kHostLoads = 8;
constexpr int kHostWarps = 8;

template <typename V>
__global__ void scatter_add_host_kernel(V* __restrict__ base,
                                        const int* __restrict__ rows,
                                        const V* __restrict__ values,
                                        long long R, long long cols) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kHostWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int row = segment_row(rows, r);
  if (row < 0) return;
  long long end = r + 1;
  while (end < R && rows[end] == row) ++end;
  V* dst = base + (long long)row * cols;
  for (long long c0 = lane; c0 < cols; c0 += 32 * kHostLoads) {
    V acc[kHostLoads];
#pragma unroll
    for (int k = 0; k < kHostLoads; ++k) {
      const long long c = c0 + 32 * k;
      if (c < cols) acc[k] = dst[c];
    }
    for (long long j = r; j < end; ++j) {
      const V* v = values + j * cols;
#pragma unroll
      for (int k = 0; k < kHostLoads; ++k) {
        const long long c = c0 + 32 * k;
        if (c < cols) acc[k] = add_rn(acc[k], v[c]);
      }
    }
#pragma unroll
    for (int k = 0; k < kHostLoads; ++k) {
      const long long c = c0 + 32 * k;
      if (c < cols) dst[c] = acc[k];
    }
  }
}

// ---- segment_sum: sorted ids `keys` (E) and their positions `perm`
constexpr int kSegUnroll = 8;  // rows loaded ahead of a chain of adds

// the slot of the chunk of a long segment that starts at sorted position
// p and holds len (1 .. K) edges
__device__ __forceinline__ long long chunk_slot(long long p, long long len,
                                                long long K) {
  return 2 * (p / K) + (len < K ? 1 : 0);
}

// x[perm[e], c] over e in [lo, hi), from +0, one __fadd_rn each in order;
// the positions of the next kSegUnroll rows load behind their values
template <typename V>
__device__ __forceinline__ V sum_rows(const V* __restrict__ x,
                                      const long long* __restrict__ perm,
                                      long long lo, long long hi,
                                      long long cols, long long c) {
  long long pn[kSegUnroll];
#pragma unroll
  for (int k = 0; k < kSegUnroll; ++k) pn[k] = lo + k < hi ? perm[lo + k] : 0;
  V acc = zero_v<V>();
  long long e = lo;
  for (; e + kSegUnroll <= hi; e += kSegUnroll) {
    V v[kSegUnroll];
#pragma unroll
    for (int k = 0; k < kSegUnroll; ++k) v[k] = x[pn[k] * cols + c];
#pragma unroll
    for (int k = 0; k < kSegUnroll; ++k) {
      const long long f = e + kSegUnroll + k;
      pn[k] = f < hi ? perm[f] : 0;
    }
#pragma unroll
    for (int k = 0; k < kSegUnroll; ++k) acc = add_rn(acc, v[k]);
  }
#pragma unroll
  for (int k = 0; k < kSegUnroll; ++k)
    if (e + k < hi) acc = add_rn(acc, x[pn[k] * cols + c]);
  return acc;
}

// one thread a segment: the first sorted position of each chunk of a
// segment of more than K edges, into its slot
__global__ void segment_sum_slots_kernel(const long long* __restrict__ starts,
                                         long long n, long long K,
                                         long long* __restrict__ first) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long lo = starts[r], hi = starts[r + 1];
  if (hi - lo <= K) return;
  for (long long p = lo; p < hi; p += K)
    first[chunk_slot(p, min(K, hi - p), K)] = p;
}

// thread (slot, V column): the slot's chunk summed in edge order
template <typename V>
__global__ void __launch_bounds__(kThreads)
segment_sum_chunks_kernel(const V* __restrict__ x, const int* __restrict__ keys,
                          const long long* __restrict__ perm,
                          const long long* __restrict__ starts,
                          const long long* __restrict__ first,
                          long long n_slots, long long K,
                          V* __restrict__ chunks, long long cols) {
  const long long s = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const long long c = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= n_slots || c >= cols) return;
  const long long p = first[s];
  if (p < 0) return;
  const long long hi = min(starts[(long long)keys[p] + 1], p + K);
  chunks[s * cols + c] = sum_rows(x, perm, p, hi, cols, c);
}

// thread (segment, V column): a segment of at most K edges sums its
// edges, a longer one its chunks' sums in chunk order
template <typename V>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows_kernel(const V* __restrict__ x,
                        const long long* __restrict__ perm,
                        const long long* __restrict__ starts,
                        const V* __restrict__ chunks, long long n,
                        long long K, V* __restrict__ out, long long cols) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const long long c = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= n || c >= cols) return;
  const long long lo = starts[r], hi = starts[r + 1];
  V acc;
  if (hi - lo <= K) {
    acc = sum_rows(x, perm, lo, hi, cols, c);
  } else {
    acc = zero_v<V>();
#pragma unroll 8
    for (long long p = lo; p < hi; p += K)
      acc = add_rn(acc, chunks[chunk_slot(p, min(K, hi - p), K) * cols + c]);
  }
  out[r * cols + c] = acc;
}

// threads along the columns: a warp multiple covering `cols`, at most kThreads
int col_threads(long long cols) {
  long long t = ((cols + 31) / 32) * 32;
  return (int)(t < kThreads ? t : kThreads);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// segment_sum's threads along the columns: col_threads' warp multiple
// from 32 columns, below that the power of two at or above them
int seg_col_threads(long long cols) {
  if (cols >= 32) return col_threads(cols);
  int t = 1;
  while (t < cols) t *= 2;
  return t;
}

}  // namespace

extern "C" int gather_rows_f32(const float* table, const int* rows, float* out,
                               long long R, long long D, cudaStream_t stream) {
  if (R <= 0 || D <= 0) return (int)cudaGetLastError();
  const bool vec = (D % 4 == 0) && aligned16(table, out);
  const long long cols = vec ? D / 4 : D;
  const int tx = col_threads(cols);
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const long long grid = (R + ty - 1) / ty;
  if (vec) {
    gather_rows_vec4_kernel<<<(unsigned)grid, block, 0, stream>>>(
        reinterpret_cast<const float4*>(table), rows,
        reinterpret_cast<float4*>(out), R, cols);
  } else {
    gather_rows_scalar_kernel<<<(unsigned)grid, block, 0, stream>>>(
        table, rows, out, R, cols);
  }
  return (int)cudaGetLastError();
}

template <typename V>
int launch_gather_aggregate(const V* table, const int* erows, const float* w,
                            const long long* starts, const long long* heavy,
                            long long k_slots, V* out, long long n_dst,
                            long long cols, long long heavy_edges,
                            cudaStream_t stream) {
  const long long n_slab = (cols + 31) / 32;
  const long long n_items = k_slots * n_slab;
  if (n_items > 0) {
    cudaFuncSetAttribute(gather_aggregate_heavy_kernel<V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Ring<V>::kSmem);
    const long long grid = std::min(
        n_items, heavy_rows::resident_blocks(gather_aggregate_heavy_kernel<V>,
                                 kHeavyThreads, Ring<V>::kSmem));
    gather_aggregate_heavy_kernel<V>
        <<<(unsigned)grid, kHeavyThreads, Ring<V>::kSmem, stream>>>(
            table, erows, w, starts, heavy, out, cols, n_items, n_slab);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int tx = col_threads(cols);
  const dim3 grid((unsigned)n_dst, (unsigned)((cols + tx - 1) / tx));
  gather_aggregate_rows_kernel<V><<<grid, tx, 0, stream>>>(
      table, erows, w, starts, out, cols, heavy_edges);
  return (int)cudaGetLastError();
}

extern "C" int gather_aggregate_f32(const float* table, const int* erows,
                                    const int* dst, const float* w, float* out,
                                    long long E, long long n_dst, long long D,
                                    long long* starts, long long* heavy,
                                    long long k_slots, long long heavy_edges,
                                    cudaStream_t stream) {
  if (n_dst <= 0 || D <= 0) return (int)cudaGetLastError();
  const int err = heavy_rows::plan(dst, E, n_dst, heavy_edges, starts, heavy,
                                   k_slots, stream);
  if (err != 0) return err;
  if (D % 4 == 0 && aligned16(table, out))
    return launch_gather_aggregate(reinterpret_cast<const float4*>(table),
                                   erows, w, starts, heavy, k_slots,
                                   reinterpret_cast<float4*>(out), n_dst, D / 4,
                                   heavy_edges, stream);
  return launch_gather_aggregate(table, erows, w, starts, heavy, k_slots, out,
                                 n_dst, D, heavy_edges, stream);
}

// the row plan alone (heavy_rows.cuh), for holding it to its plain version
extern "C" int heavy_rows_plan(const int* dst, long long E, long long n_dst,
                               long long heavy_edges, long long* starts,
                               long long* heavy, long long k_slots,
                               cudaStream_t stream) {
  if (n_dst < 0) return (int)cudaGetLastError();
  return heavy_rows::plan(dst, E, n_dst, heavy_edges, starts, heavy, k_slots,
                          stream);
}

extern "C" int scatter_add_f32(float* base, const int* rows,
                               const float* values, long long R, long long D,
                               cudaStream_t stream) {
  if (R <= 0 || D <= 0) return (int)cudaGetLastError();
  const bool vec = (D % 4 == 0) && aligned16(base, values);
  const long long cols = vec ? D / 4 : D;
  const int tx = col_threads(cols);
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const long long grid = (R + ty - 1) / ty;
  if (vec) {
    scatter_add_vec4_kernel<<<(unsigned)grid, block, 0, stream>>>(
        reinterpret_cast<float4*>(base), rows,
        reinterpret_cast<const float4*>(values), R, cols);
  } else {
    scatter_add_scalar_kernel<<<(unsigned)grid, block, 0, stream>>>(
        base, rows, values, R, cols);
  }
  return (int)cudaGetLastError();
}

// base_host is page-locked host memory; the kernel reaches it through its
// mapped device address. A pageable or unmapped base is refused with the
// error of cudaHostGetDevicePointer (cleared, so a later launch's
// cudaGetLastError does not report it).
extern "C" int scatter_add_host_f32(float* base_host, const int* rows,
                                    const float* values, long long R,
                                    long long D, cudaStream_t stream) {
  if (R <= 0 || D <= 0) return (int)cudaGetLastError();
  void* mapped = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(&mapped, base_host, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  float* base = static_cast<float*>(mapped);
  const long long grid = (R + kHostWarps - 1) / kHostWarps;
  if (D % 4 == 0 && aligned16(base, values)) {
    scatter_add_host_kernel<float4><<<(unsigned)grid, 32 * kHostWarps, 0, stream>>>(
        reinterpret_cast<float4*>(base), rows,
        reinterpret_cast<const float4*>(values), R, D / 4);
  } else {
    scatter_add_host_kernel<float><<<(unsigned)grid, 32 * kHostWarps, 0, stream>>>(
        base, rows, values, R, D);
  }
  return (int)cudaGetLastError();
}

template <typename V>
int launch_segment_sum(const V* x, const int* keys, const long long* perm,
                       long long n, long long cols, long long K,
                       const long long* starts, const long long* first,
                       long long n_slots, V* chunks, V* out,
                       cudaStream_t stream) {
  const int tx = seg_col_threads(cols);
  const int ty = kThreads / tx;
  const unsigned gy = (unsigned)((cols + tx - 1) / tx);
  const dim3 block(tx, ty);
  if (n_slots > 0) {
    segment_sum_chunks_kernel<V>
        <<<dim3((unsigned)((n_slots + ty - 1) / ty), gy), block, 0, stream>>>(
            x, keys, perm, starts, first, n_slots, K, chunks, cols);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  segment_sum_rows_kernel<V>
      <<<dim3((unsigned)((n + ty - 1) / ty), gy), block, 0, stream>>>(
          x, perm, starts, chunks, n, K, out, cols);
  return (int)cudaGetLastError();
}

// keys: the ids sorted stably (E int32), perm: their positions (E int64);
// scratch from the wrapper: starts (n + 1 int64), first (n_slots =
// 2 * ceil(E / K) int64), chunks (n_slots * D float). Ids outside [0, n)
// fall in no segment.
extern "C" int segment_sum_f32(const float* x, const int* keys,
                               const long long* perm, long long E, long long n,
                               long long D, long long K, long long* starts,
                               long long* first, float* chunks, float* out,
                               cudaStream_t stream) {
  if (n <= 0 || D <= 0) return (int)cudaGetLastError();
  if (K <= 0) return (int)cudaErrorInvalidValue;
  heavy_rows::row_starts_kernel<<<(unsigned)((n + 1 + 255) / 256), 256, 0,
                                  stream>>>(keys, E, n, starts);
  const long long n_slots = E > 0 ? 2 * ((E + K - 1) / K) : 0;
  if (n_slots > 0) {
    const cudaError_t err = cudaMemsetAsync(
        first, 0xff, (size_t)n_slots * sizeof(long long), stream);
    if (err != cudaSuccess) return (int)err;
    segment_sum_slots_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        starts, n, K, first);
  }
  if (D % 4 == 0 && aligned16(x, out) && aligned16(chunks, out))
    return launch_segment_sum(reinterpret_cast<const float4*>(x), keys, perm, n,
                              D / 4, K, starts, first, n_slots,
                              reinterpret_cast<float4*>(chunks),
                              reinterpret_cast<float4*>(out), stream);
  return launch_segment_sum(x, keys, perm, n, D, K, starts, first, n_slots,
                            chunks, out, stream);
}
