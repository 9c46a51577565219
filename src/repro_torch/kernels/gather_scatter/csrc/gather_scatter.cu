// Row gather and fused gather+aggregate for the SSO forward hot path, and the
// sorted scatter-add of the backward's grad write-back, hand written for
// Hopper (sm_90a). Plain C entry points, loaded with ctypes by
// repro_torch/kernels/gather_scatter/ops.py; each launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
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
//   Each edge is one fused multiply-add, __fmaf_rn(w, x, acc), so the result
//   equals the reference FMA oracle (ref.gather_aggregate_ref_fma) bitwise.
//   Bound: memory. It reads each edge's source row (E*D*4 bytes, less where
//   L2 catches repeats), writes n_dst*D*4 and reads 12*E of indices and
//   weights.
//   Design: one block per (dst row, column tile); no atomics and no block
//   depends on another, so the sum order is fixed and the result is the
//   same on every run. The row's edge range comes from a binary search of
//   the sorted dst (thread 0, into shared memory). Each thread owns 4
//   columns (float4) or 1, walks the edges in order, and keeps the sum in
//   registers; edge indices and weights are loaded UNROLL edges ahead of the
//   FMA chain so the dependent row loads overlap. The TPU kernel's
//   sequential grid carried the sum in VMEM across grid steps; here the
//   loop inside the block takes that role.
//   Known limit: a power-law hub row's edges all run in one block, so the
//   highest in-degree row serialises one SM while the rest of the grid
//   drains. Splitting hub rows (a second pass over partial sums in a fixed
//   order) is the first thing a performance pass should look at.
//
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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

__device__ __forceinline__ void edge_range(const int* __restrict__ dst,
                                           long long E, long long r,
                                           long long* lo, long long* hi) {
  __shared__ long long bounds[2];
  if (threadIdx.x == 0) {
    bounds[0] = lower_bound(dst, E, r);
    bounds[1] = lower_bound(dst, E, r + 1);
  }
  __syncthreads();
  *lo = bounds[0];
  *hi = bounds[1];
}

__global__ void gather_aggregate_vec4_kernel(const float4* __restrict__ table,
                                             const int* __restrict__ erows,
                                             const int* __restrict__ dst,
                                             const float* __restrict__ w,
                                             float4* __restrict__ out,
                                             long long E, long long D4) {
  const long long r = blockIdx.x;
  const long long c = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  long long lo, hi;
  edge_range(dst, E, r, &lo, &hi);
  if (c >= D4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  long long e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    float4 x[kUnroll];
    float we[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      we[k] = w[e + k];
      x[k] = table[(long long)erows[e + k] * D4 + c];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      acc.x = __fmaf_rn(we[k], x[k].x, acc.x);
      acc.y = __fmaf_rn(we[k], x[k].y, acc.y);
      acc.z = __fmaf_rn(we[k], x[k].z, acc.z);
      acc.w = __fmaf_rn(we[k], x[k].w, acc.w);
    }
  }
  for (; e < hi; ++e) {
    const float we = w[e];
    const float4 x = table[(long long)erows[e] * D4 + c];
    acc.x = __fmaf_rn(we, x.x, acc.x);
    acc.y = __fmaf_rn(we, x.y, acc.y);
    acc.z = __fmaf_rn(we, x.z, acc.z);
    acc.w = __fmaf_rn(we, x.w, acc.w);
  }
  out[r * D4 + c] = acc;
}

__global__ void gather_aggregate_scalar_kernel(const float* __restrict__ table,
                                               const int* __restrict__ erows,
                                               const int* __restrict__ dst,
                                               const float* __restrict__ w,
                                               float* __restrict__ out,
                                               long long E, long long D) {
  const long long r = blockIdx.x;
  const long long c = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  long long lo, hi;
  edge_range(dst, E, r, &lo, &hi);
  if (c >= D) return;
  float acc = 0.f;
  long long e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    float x[kUnroll];
    float we[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      we[k] = w[e + k];
      x[k] = table[(long long)erows[e + k] * D + c];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = __fmaf_rn(we[k], x[k], acc);
  }
  for (; e < hi; ++e) acc = __fmaf_rn(w[e], table[(long long)erows[e] * D + c], acc);
  out[r * D + c] = acc;
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

// threads along the columns: a warp multiple covering `cols`, at most kThreads
int col_threads(long long cols) {
  long long t = ((cols + 31) / 32) * 32;
  return (int)(t < kThreads ? t : kThreads);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
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

extern "C" int gather_aggregate_f32(const float* table, const int* erows,
                                    const int* dst, const float* w, float* out,
                                    long long E, long long n_dst, long long D,
                                    cudaStream_t stream) {
  if (n_dst <= 0 || D <= 0) return (int)cudaGetLastError();
  const bool vec = (D % 4 == 0) && aligned16(table, out);
  const long long cols = vec ? D / 4 : D;
  const int tx = col_threads(cols);
  const dim3 grid((unsigned)n_dst, (unsigned)((cols + tx - 1) / tx));
  if (vec) {
    gather_aggregate_vec4_kernel<<<grid, tx, 0, stream>>>(
        reinterpret_cast<const float4*>(table), erows, dst, w,
        reinterpret_cast<float4*>(out), E, cols);
  } else {
    gather_aggregate_scalar_kernel<<<grid, tx, 0, stream>>>(
        table, erows, dst, w, out, E, cols);
  }
  return (int)cudaGetLastError();
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
