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
//   one output tile and loops over the row's nonzero blocks itself.
//   Bound: bytes. At the GCN main path's shape (65,536 nodes, B 128,
//   152,272 nonzero blocks, D 1,024) the bytes (10 GB of blocks, x and out
//   once) take 3.1 ms at 3.35 TB/s, while Â·X needs only its nonzero
//   products (2 * 1.46e6 entries * D = 3.0e9 FLOP, 0.045 ms). What limits
//   this design is the dense block layout's work: it multiplies every
//   entry of every block, 2 * nnz * B^2 * D = 5.11e12 FLOP, 76 ms at
//   float32's 67 TFLOP/s. Float32 means float32: no TF32 tensor cores.
//   Design: one 256-thread block per (destination block row r, 64-wide
//   column tile of D), the tile index fastest, so the tiles of one row run
//   side by side and share the row's A blocks through L2. Thread 0
//   binary-searches the row's block range [lo, hi) in the sorted row_ids.
//   The block walks the row's blocks in ascending order, each in 32-wide
//   k-slices: A[blk][:, k0:k0+32] (transposed, 16.5 KB) and
//   X[col][k0:k0+32, tile] (8 KB) are staged in shared memory, the next
//   slice's values are loaded into registers while the current one is
//   multiplied, and each thread accumulates an 8 x 4 register tile of the
//   128 x 64 output with float32 FMAs (per k: two float4 reads of A, one of
//   X, 32 FMAs). Ragged B (< 128, not a multiple of 32) and ragged D are
//   masked: padded entries are 0 and add exactly nothing. The tile is
//   written once. No atomics and no block depends on another, so a rerun
//   has the same bits; each output element is one FMA chain over the
//   row's K_r * B terms, of which only its m_r nonzero entries of A round
//   (a zero product adds exactly nothing): within about m_r * 2^-24 *
//   sum |a x| of the exact sum.
//   Known limits: SIMT FMAs (wgmma with TMA-fed tiles is the next step);
//   zero sub-tiles of a block are multiplied like any other (at the main
//   path's density, 9.6 edges per 16,384-entry block, almost all of the
//   work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;   // output rows of a tile (B <= 128)
constexpr int kTileN = 64;    // output columns of a tile
constexpr int kTileK = 32;    // k-slice staged at once
constexpr int kPadA = 4;      // keeps the transposed A stores conflict-free
constexpr int kARegs = kTileK * kTileM / kThreads;  // 16
constexpr int kXRegs = kTileK * kTileN / kThreads;  // 8

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

// Load k-slice `step` of the row's block walk into registers: A entries
// (i, k0 + kk) with kk = lane % 8 + 8 * (s % 4), i = lane / 8 + 4 * warp +
// 32 * (s / 4) (a warp reads 4 rows x 32 bytes, and its transposed stores
// hit 32 distinct banks), and X entries (k0 + kk, d0 + j) with j = t % 64,
// kk = t / 64 + 4 * s.
template <typename T>
__device__ __forceinline__ void load_slice(
    const float* __restrict__ a, const int* __restrict__ col_ids,
    const T* __restrict__ x, long long blk, int k0, int B, long long D,
    long long d0, float (&ra)[kARegs], float (&rx)[kXRegs]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* ab = a + blk * B * B;
  const T* xb = x + (long long)col_ids[blk] * B * D;
#pragma unroll
  for (int s = 0; s < kARegs; ++s) {
    const int kk = (lane & 7) + 8 * (s & 3);
    const int i = (lane >> 3) + 4 * warp + 32 * (s >> 2);
    ra[s] = (i < B && k0 + kk < B) ? ab[(long long)i * B + k0 + kk] : 0.f;
  }
#pragma unroll
  for (int s = 0; s < kXRegs; ++s) {
    const int kk = (t >> 6) + 4 * s;
    const long long j = d0 + (t & 63);
    rx[s] = (k0 + kk < B && j < D) ? to_f32(xb[(long long)(k0 + kk) * D + j])
                                   : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ a, const int* __restrict__ row_ids,
                const int* __restrict__ col_ids, const T* __restrict__ x,
                T* __restrict__ out, long long nnz, int B, long long D,
                long long n_tiles) {
  __shared__ __align__(16) float As[kTileK][kTileM + kPadA];  // A[i][k0+k]
  __shared__ __align__(16) float Xs[kTileK][kTileN];          // X[k0+k][j]
  __shared__ long long range[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long r = (long long)blockIdx.x / n_tiles;
  const long long d0 = ((long long)blockIdx.x % n_tiles) * kTileN;
  if (t == 0) {
    range[0] = lower_bound(row_ids, nnz, r);
    range[1] = lower_bound(row_ids, nnz, r + 1);
  }
  __syncthreads();
  const long long lo = range[0];
  const int n_k = (B + kTileK - 1) / kTileK;
  const long long steps = (range[1] - lo) * n_k;
  const int ty = t >> 4, tx = t & 15;  // rows ty*8 .. +7, columns tx*4 .. +3

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float ra[kARegs], rx[kXRegs];
  if (steps > 0) load_slice(a, col_ids, x, lo, 0, B, D, d0, ra, rx);
  for (long long st = 0; st < steps; ++st) {
#pragma unroll
    for (int s = 0; s < kARegs; ++s)
      As[(lane & 7) + 8 * (s & 3)][(lane >> 3) + 4 * warp + 32 * (s >> 2)] = ra[s];
#pragma unroll
    for (int s = 0; s < kXRegs; ++s) Xs[(t >> 6) + 4 * s][t & 63] = rx[s];
    __syncthreads();
    if (st + 1 < steps) {
      const long long nx = st + 1;
      load_slice(a, col_ids, x, lo + nx / n_k, (int)(nx % n_k) * kTileK, B,
                 D, d0, ra, rx);
    }
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xs[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the tile, written once (zeros for a row with no nonzero block)
  T* ob = out + r * B * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i;
    if (row >= B) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long col = d0 + tx * 4 + j;
      if (col < D) store(ob + (long long)row * D + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const float* a, const int* row_ids, const int* col_ids,
           const T* x, T* out, long long nnz, long long B, long long D,
           long long n_dst_blocks, cudaStream_t stream) {
  if (n_dst_blocks <= 0 || B <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > kTileM) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (D + kTileN - 1) / kTileN;
  const long long grid = n_dst_blocks * n_tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bsr_spmm_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      a, row_ids, col_ids, x, out, nnz, (int)B, D, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bsr_spmm_f32(const float* a, const int* row_ids,
                            const int* col_ids, const float* x, float* out,
                            long long nnz, long long B, long long D,
                            long long n_dst_blocks, cudaStream_t stream) {
  return launch<float>(a, row_ids, col_ids, x, out, nnz, B, D, n_dst_blocks,
                       stream);
}

extern "C" int bsr_spmm_bf16x(const float* a, const int* row_ids,
                              const int* col_ids, const void* x, void* out,
                              long long nnz, long long B, long long D,
                              long long n_dst_blocks, cudaStream_t stream) {
  return launch<__nv_bfloat16>(a, row_ids, col_ids,
                               static_cast<const __nv_bfloat16*>(x),
                               static_cast<__nv_bfloat16*>(out), nnz, B, D,
                               n_dst_blocks, stream);
}
