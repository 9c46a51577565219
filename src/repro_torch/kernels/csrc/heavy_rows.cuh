// The row plan of the kernels that walk a destination-sorted edge list
// (gather_aggregate, edge_softmax), made on the card: each row's edge range
// and the list of heavy rows, with no host synchronisation. Included by
// kernels/gather_scatter/csrc/gather_scatter.cu and
// kernels/edge_softmax/csrc/edge_softmax.cu; its plain version is
// kernels/heavy_rows.py (plan_rows), which the card tests hold it to.
//
//   starts (n_dst + 1 int64): row r's edges are [starts[r], starts[r + 1]),
//     the first e with dst[e] >= r (dst sorted ascending; an id outside
//     [0, n_dst) falls in no row).
//   heavy (K int64, K = min(E / (heavy_edges + 1), n_dst) by the wrapper):
//     the rows with more than heavy_edges edges, those with more than
//     kHugeFactor * heavy_edges first, each group in row order, then -1.
//     The huge rows' work is the longest, so it starts first; the rest
//     keeps the reordered graph's row order, whose neighbouring rows share
//     source rows in L2.
//
// Three launches, each over the whole card: row_starts_kernel, one thread
// a row, writes starts; tile_counts_kernel counts each tile of
// kTile rows' huge and other heavy rows (ballots); heavy_write_kernel adds
// up the earlier tiles' counts and writes each tile's rows at their places
// in a fixed order. Integer arithmetic only; the same list on every run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace heavy_rows {

constexpr int kHugeFactor = 16;
constexpr int kTile = 1024;  // rows a planner block

// starts[r] = the first e in [0, E) with dst[e] >= r (E when none), one
// thread a row: a binary search, whose first steps every thread shares in
// cache
__global__ void row_starts_kernel(const int* __restrict__ dst, long long E,
                                  long long n_dst,
                                  long long* __restrict__ starts) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > n_dst) return;
  long long lo = 0, hi = E;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)dst[mid] < r) lo = mid + 1; else hi = mid;
  }
  starts[r] = lo;
}

// this thread's row of the tile and its group: 2 huge, 1 other heavy, 0
__device__ __forceinline__ int row_group(const long long* __restrict__ starts,
                                         long long n_dst, long long heavy_edges,
                                         long long r) {
  if (r >= n_dst) return 0;
  const long long d = starts[r + 1] - starts[r];
  return d > kHugeFactor * heavy_edges ? 2 : (d > heavy_edges ? 1 : 0);
}

// exclusive prefix over the block (kTile threads, in thread order) of the
// threads with `flag`, and the block's count; `warps` is kTile / 32 ints
// of shared memory
__device__ __forceinline__ int tile_scan(bool flag, int* warps, int* count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warps[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
  for (int k = 0; k < kTile / 32; ++k) {
    before += k < warp ? warps[k] : 0;
    total += warps[k];
  }
  __syncthreads();
  *count = total;
  return before + __popc(ballot & ((1u << lane) - 1));
}

// counts[2 b], counts[2 b + 1]: tile b's huge and other heavy rows
__global__ void __launch_bounds__(kTile)
tile_counts_kernel(const long long* __restrict__ starts, long long n_dst,
                   long long heavy_edges, long long* __restrict__ counts) {
  __shared__ int warps[kTile / 32];
  const int g = row_group(starts, n_dst, heavy_edges,
                          (long long)blockIdx.x * kTile + threadIdx.x);
  int n_huge, n_rest;
  tile_scan(g == 2, warps, &n_huge);
  tile_scan(g == 1, warps, &n_rest);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = n_huge;
    counts[2 * blockIdx.x + 1] = n_rest;
  }
}

// each tile's heavy rows at their places: the huge rows of earlier tiles,
// then of this one in row order; after all huge rows, the same for the
// other heavy rows; -1 from the end of the list to k_slots
__global__ void __launch_bounds__(kTile)
heavy_write_kernel(const long long* __restrict__ starts, long long n_dst,
                   long long heavy_edges, const long long* __restrict__ counts,
                   long long n_tiles, long long* __restrict__ heavy,
                   long long k_slots) {
  __shared__ int warps[kTile / 32];
  __shared__ long long base[3];  // huge before, other before, huge in all
  if (threadIdx.x == 0) {
    long long hb = 0, rb = 0, ht = 0, rt = 0;
    for (long long b = 0; b < n_tiles; ++b) {
      hb += b < blockIdx.x ? counts[2 * b] : 0;
      rb += b < blockIdx.x ? counts[2 * b + 1] : 0;
      ht += counts[2 * b];
      rt += counts[2 * b + 1];
    }
    base[0] = hb;
    base[1] = ht + rb;
    base[2] = ht + rt;
  }
  const long long r = (long long)blockIdx.x * kTile + threadIdx.x;
  const int g = row_group(starts, n_dst, heavy_edges, r);
  int n;
  const int at_huge = tile_scan(g == 2, warps, &n);
  const int at_rest = tile_scan(g == 1, warps, &n);
  if (g == 2) heavy[base[0] + at_huge] = r;
  if (g == 1) heavy[base[1] + at_rest] = r;
  for (long long i = base[2] + r; i < k_slots; i += n_tiles * kTile)
    heavy[i] = -1;
}

// tiles of the planner: counts needs 2 * plan_tiles(n_dst) int64 after
// the k_slots of the list
inline long long plan_tiles(long long n_dst) {
  return (n_dst + kTile - 1) / kTile;
}

// blocks of `kernel` resident on the whole card at once (at least one): the
// size of a persistent grid
template <typename K>
long long resident_blocks(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long n = (long long)sms * per_sm;
  return n > 0 ? n : 1;
}

// the three launches on `stream` (`heavy` holds k_slots entries and then
// 2 * plan_tiles(n_dst) of tile counts); returns cudaGetLastError()
inline int plan(const int* dst, long long E, long long n_dst,
                long long heavy_edges, long long* starts, long long* heavy,
                long long k_slots, cudaStream_t stream) {
  const long long grid = (n_dst + 1 + 255) / 256;
  row_starts_kernel<<<(unsigned)grid, 256, 0, stream>>>(dst, E, n_dst,
                                                        starts);
  if (k_slots > 0) {
    const long long tiles = plan_tiles(n_dst);
    long long* counts = heavy + k_slots;
    tile_counts_kernel<<<(unsigned)tiles, kTile, 0, stream>>>(
        starts, n_dst, heavy_edges, counts);
    heavy_write_kernel<<<(unsigned)tiles, kTile, 0, stream>>>(
        starts, n_dst, heavy_edges, counts, tiles, heavy, k_slots);
  }
  return (int)cudaGetLastError();
}

}  // namespace heavy_rows
