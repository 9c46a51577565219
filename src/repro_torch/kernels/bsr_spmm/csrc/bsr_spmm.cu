// Block-sparse SpMM over a graph's nonzero B x B adjacency blocks (BSR),
// hand written for Hopper (sm_90a). Plain C entry points, loaded with ctypes
// by repro_torch/kernels/bsr_spmm/ops.py; they launch on the caller's stream,
// allocate nothing and return cudaGetLastError().
//
// bsr_spmm_f32 / bsr_spmm_bf16x replace bsr_spmm_kernel
// (src/repro/kernels/bsr_spmm/bsr_spmm.py:45):
//   out[r] = sum over the blocks i with row_ids[i] == r of
//            a_blocks[i] (B, B) @ x[col_ids[i]] (B, D)
//   with a_blocks float32, x float32 or bfloat16, row_ids sorted ascending,
//   out (n_dst_blocks, B, D) in x's dtype. Every product and every sum is
//   float32; a bfloat16 output is rounded once, after the row's last block
//   (the TPU kernel rounds to x's dtype after every block). A destination
//   block row with no nonzero block is written with zeros (the TPU kernel
//   leaves it unwritten). The TPU grid ran (D / d_block, nnz) steps in
//   order, carrying each output block in VMEM across a row's consecutive
//   steps; here blocks run in parallel in no order, so one CUDA block owns
//   one destination block row and walks the row's nonzero blocks itself.
//   Bound: bytes. At the GCN main path's shape (65,536 nodes, B 128,
//   152,272 nonzero blocks, D 1,024, 9.6 nonzero entries a block) the
//   blocks are 9.98 GB, 3.0 ms at 3.35 TB/s, and with x and out read and
//   written once 3.1 ms, while A.X needs only its nonzero products (2 *
//   1.46e6 entries * D = 3.0e9 FLOP, 0.045 ms). A dense product of each
//   block does 1,709x that work (5.1e12 FLOP), all but a few of them on
//   zeros: that was this kernel's first design, 138 ms.
//   Design: only the nonzero entries are multiplied. One block of 512
//   threads (16 warps) per (destination block row, 512-column part of D).
//   Warp w loads rows w, w + 16, ... of each of the row's A blocks as
//   coalesced 128-byte loads (a lane holds columns lane + 32 c), finds the
//   nonzero entries with one ballot per 32 columns and appends each as (a,
//   x row) to its row's list in shared memory, in (block, column) order,
//   at positions from the ballots' prefix counts. A row's list is a chain
//   of 32-entry pages from a pool of 512 (16,384 entries, 128 KB) shared by
//   the block's 128 rows, so a hub row takes as many pages as it needs.
//   After the row's last block every (row, 128-column tile) pair is applied
//   by one warp, pairs of one row on neighbouring warps so a hub row's
//   tiles run side by side: a lane accumulates 4 columns in registers, one
//   float32 FMA per entry and column, over the row's pages in order, x rows
//   loaded eight entries ahead. When the pool cannot take the next block
//   (a block row with more than ~12,000 nonzeros), every row is applied
//   first and its float32 partial sums stored (in out itself for float32,
//   in a float32 scratch for bfloat16) and loaded back at the next apply.
//   Pages are taken with shared-memory atomics, so which page holds what
//   varies, but not the order of the sums: every output element is one
//   float32 FMA chain over its row's nonzero entries in (block, column)
//   order, so a rerun is bitwise equal and each element is within (m_r +
//   1) 2^-23 (|A| |X|)_r of the plain version's sum (m_r nonzero entries),
//   the limit bsr_spmm_tolerance states. Entries that are 0 are skipped, so
//   0 * inf or 0 * NaN in x adds nothing here, where the dense product
//   (and the plain version) gives NaN. Ragged B (< 128) and D are masked;
//   x is read in place.
//   The two parts of a row each scan its blocks, the second mostly from
//   memory again; one 1,024-column part scans them once but leaves half as
//   many blocks to apply the rows (scripts/pt_kernel_variants.py times
//   both). Tried and not kept, for being slower: fixed 128-entry buckets
//   per row (a hub row flushed every 128 entries); loading the next
//   block's values ahead (more registers).
//   Floor of this layout: the 9.98 GB of blocks alone take 3.0 ms, about 3x
//   the CSR product of the same edges, which reads 1.46 M (column, weight)
//   pairs instead.
//
// ptxas (nvcc 12.9, sm_90a): 123 registers (float32 and bf16 x), no
// spills; 132 KB of dynamic shared memory, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxB = 128;
constexpr int kRowsPerWarp = kMaxB / kWarps;  // 8: rows w + 16 q
constexpr int kPage = 32;                     // entries of a page
constexpr int kPages = 512;                   // pool: any one block's fit
constexpr int kTileCols = 128;                // columns of a (row, tile) pair
constexpr int kPartCols = 512;                // columns of one block's part
constexpr int kTiles = kPartCols / kTileCols;
constexpr int kUnroll = 8;                    // entries loaded ahead

struct Smem {
  float a[kPages * kPage];  // entry values
  int src[kPages * kPage];  // entry x rows (col_ids[blk] * B + k)
  int next[kPages];         // a row's next page
  int head[kMaxB], tail[kMaxB], cnt[kMaxB];  // a row's pages and entries
  int started[kMaxB];       // partial sums stored at an earlier flush
  int used;                 // pages taken since the last flush
  int req[2];               // pages this block asks for (by block parity)
  long long range[2];
};

// first index i in [0, n) with rows[i] >= key (n when none)
__device__ long long lower_bound(const int* __restrict__ rows, long long n,
                                 long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)rows[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc[c] (column c0 + lane + 32 c) += a * x[src, column] over a run of n
// entries, in order
template <typename T>
__device__ __forceinline__ void apply_run(const float* __restrict__ ea,
                                          const int* __restrict__ es, int n,
                                          const T* __restrict__ x, long long D,
                                          long long c0, int lane,
                                          const bool (&ok)[4], float (&acc)[4]) {
  int e = 0;
  for (; e + kUnroll <= n; e += kUnroll) {
    float av[kUnroll], xv[kUnroll][4];  // a batch's loads first
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ea[e + u];
      const T* xr = x + (long long)es[e + u] * D + c0 + lane;
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[u][c] = ok[c] ? to_f32(xr[32 * c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(av[u], xv[u][c], acc[c]);
  }
  for (; e < n; ++e) {
    const float av = ea[e];
    const T* xr = x + (long long)es[e] * D + c0 + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (ok[c]) acc[c] = fmaf(av, to_f32(xr[32 * c]), acc[c]);
  }
}

// Applies every row's entries for each (row, tile) pair of this warp: pair
// p = i * n_tiles + t, p = warp mod 16, so a row's tiles run on neighbouring
// warps. A row's sums continue from its float32 partial if an earlier flush
// stored one; they go to `partial` (a flush) or, rounded to T, to out.
template <typename T>
__device__ void apply_rows(const Smem& sm, const T* __restrict__ x, T* out,
                           float* partial, long long r, int B, long long D,
                           long long part0, int n_tiles, bool last, int warp,
                           int lane) {
  for (int p = warp; p < B * n_tiles; p += kWarps) {
    const int i = p / n_tiles, t = p % n_tiles;
    const long long c0 = part0 + (long long)t * kTileCols;
    const long long row = (r * B + i) * D;
    bool ok[4];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ok[c] = c0 + lane + 32 * c < D;
      if (ok[c] && sm.started[i]) acc[c] = partial[row + c0 + lane + 32 * c];
    }
    // the row's pages in order, all full but the last
    int page = sm.head[i];
    for (int done = 0, n = sm.cnt[i]; done < n; done += kPage) {
      apply_run(sm.a + page * kPage, sm.src + page * kPage,
                min(kPage, n - done), x, D, c0, lane, ok, acc);
      page = sm.next[page];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!ok[c]) continue;
      const long long at = row + c0 + lane + 32 * c;
      if (last)
        store(out + at, acc[c]);
      else
        partial[at] = acc[c];
    }
  }
}

// this warp's rows w + 16 q, columns lane + 32 c, of A block blk (zeros past
// B), and the block's first x row
__device__ __forceinline__ void load_rows(const float* __restrict__ a,
                                          const int* __restrict__ col_ids,
                                          long long blk, int B, int warp,
                                          int lane,
                                          float (&v)[kRowsPerWarp][4],
                                          int& xbase) {
  const float* ab = a + blk * B * B;
  xbase = col_ids[blk] * B;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = warp + kWarps * q, k = lane + 32 * c;
      v[q][c] = (i < B && k < B) ? ab[i * B + k] : 0.f;
    }
}

// pages a row needs to take `tot` more entries after its `cnt`
__device__ __forceinline__ int pages_needed(int cnt, int tot) {
  const int room = (kPage - cnt % kPage) % kPage;  // left in the last page
  return tot > room ? (tot - room + kPage - 1) / kPage : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_kernel(const float* __restrict__ a, const int* __restrict__ row_ids,
                const int* __restrict__ col_ids, const T* __restrict__ x,
                T* out, float* partial, long long nnz,
                int B, long long D, int n_parts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = (long long)blockIdx.x / n_parts;
  const long long part0 = ((long long)blockIdx.x % n_parts) * kPartCols;
  const int n_tiles =
      (int)min((long long)kTiles, (D - part0 + kTileCols - 1) / kTileCols);
  if (tid == 0) {
    sm.range[0] = lower_bound(row_ids, nnz, r);
    sm.range[1] = lower_bound(row_ids, nnz, r + 1);
    sm.used = 0;
    sm.req[0] = sm.req[1] = 0;
  }
  if (tid < kMaxB) {
    sm.cnt[tid] = 0;
    sm.started[tid] = 0;
  }
  __syncthreads();
  const long long lo = sm.range[0], hi = sm.range[1];
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one

  int cnt[kRowsPerWarp];  // entries of row w + 16 q since the last flush
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) cnt[q] = 0;

  for (long long blk = lo; blk < hi; ++blk) {
    // rows w + 16 q, columns lane + 32 c of the block
    float v[kRowsPerWarp][4];
    int xbase;
    load_rows(a, col_ids, blk, B, warp, lane, v, xbase);
    const int par = (int)(blk & 1);
    if (tid == 0) sm.req[par ^ 1] = 0;  // the next block's count
    int tot[kRowsPerWarp], need = 0;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      tot[q] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tot[q] += __popc(__ballot_sync(0xffffffffu, v[q][c] != 0.f));
      need += pages_needed(cnt[q], tot[q]);
    }
    if (lane == 0 && need) atomicAdd(&sm.req[par], need);
    __syncthreads();
    // every thread reads the same count before any takes a page
    if (__syncthreads_or(sm.used + sm.req[par] > kPages)) {
      // the pool cannot take this block: apply every row so far, keep the
      // float32 partial sums, start the pool over
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int i = warp + kWarps * q;
        if (lane == 0 && i < B) sm.cnt[i] = cnt[q];
      }
      __syncthreads();
      apply_rows(sm, x, out, partial, r, B, D, part0, n_tiles, false, warp,
                 lane);
      __syncthreads();
      if (tid < kMaxB) sm.started[tid] = 1;
      if (tid == 0) sm.used = 0;
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) cnt[q] = 0;
      __syncthreads();
    }
    // take the pages (a row's new pages are consecutive) and append the
    // nonzero entries in column order, at the ballots' prefix counts
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int i = warp + kWarps * q;
      if (tot[q] == 0) continue;  // warp-uniform
      const int np = pages_needed(cnt[q], tot[q]);
      const int old_tail = sm.tail[i];  // the last page, if cnt > 0
      __syncwarp();                     // read by every lane before lane 0
      int first = 0;                    // updates it
      if (lane == 0 && np) first = atomicAdd(&sm.used, np);
      first = __shfl_sync(0xffffffffu, first, 0);
      if (lane == 0 && np) {
        if (cnt[q] == 0)
          sm.head[i] = first;
        else
          sm.next[sm.tail[i]] = first;
        for (int j = 0; j + 1 < np; ++j) sm.next[first + j] = first + j + 1;
        sm.tail[i] = first + np - 1;
      }
      const int room = (kPage - cnt[q] % kPage) % kPage;
      int pos = 0;  // this block's entry number in the row
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned m = __ballot_sync(0xffffffffu, v[q][c] != 0.f);
        if (v[q][c] != 0.f) {
          const int e = pos + __popc(m & lt);
          const int at = e < room
                             ? old_tail * kPage + kPage - room + e
                             : (first + (e - room) / kPage) * kPage +
                                   (e - room) % kPage;
          sm.a[at] = v[q][c];
          sm.src[at] = xbase + lane + 32 * c;
        }
        pos += __popc(m);
      }
      cnt[q] += tot[q];
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int i = warp + kWarps * q;
      if (i < B) sm.cnt[i] = cnt[q];
    }
  }
  __syncthreads();
  apply_rows(sm, x, out, partial, r, B, D, part0, n_tiles, true, warp, lane);
}

template <typename T>
int launch(const float* a, const int* row_ids, const int* col_ids,
           const T* x, T* out, float* partial, long long nnz, long long B,
           long long D, long long n_dst_blocks, cudaStream_t stream) {
  if (n_dst_blocks <= 0 || B <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > kMaxB) return (int)cudaErrorInvalidValue;
  const long long n_parts = (D + kPartCols - 1) / kPartCols;
  const long long grid = n_dst_blocks * n_parts;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bsr_spmm_kernel<T><<<(unsigned)grid, kThreads, smem, stream>>>(
      a, row_ids, col_ids, x, out, partial, nnz, (int)B, D, (int)n_parts);
  return (int)cudaGetLastError();
}

}  // namespace

// x rows are addressed as int32 (col_ids * B + k): the wrapper keeps
// n_src_blocks * B below 2^31. For float32 the flushed rows' partial sums
// go to out itself (so out and partial alias: neither is __restrict__).
extern "C" int bsr_spmm_f32(const float* a, const int* row_ids,
                            const int* col_ids, const float* x, float* out,
                            long long nnz, long long B, long long D,
                            long long n_dst_blocks, cudaStream_t stream) {
  return launch<float>(a, row_ids, col_ids, x, out, out, nnz, B, D,
                       n_dst_blocks, stream);
}

// `partial`: float32 scratch of out's shape, for the flushed rows' sums
extern "C" int bsr_spmm_bf16x(const float* a, const int* row_ids,
                              const int* col_ids, const void* x, void* out,
                              float* partial, long long nnz, long long B,
                              long long D, long long n_dst_blocks,
                              cudaStream_t stream) {
  return launch<__nv_bfloat16>(a, row_ids, col_ids,
                               static_cast<const __nv_bfloat16*>(x),
                               static_cast<__nv_bfloat16*>(out), partial, nnz,
                               B, D, n_dst_blocks, stream);
}
