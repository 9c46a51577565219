// EmbeddingBag over fixed-size bags (the two-tower retrieval model's
// towers), hand written for Hopper (sm_90a). Plain C entry point, loaded
// with ctypes by repro_torch/kernels/embedding_bag/ops.py; it launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().
//
// embedding_bag_f32 replaces embedding_bag_pallas
// (src/repro/kernels/embedding_bag/embedding_bag.py:33):
//   out[b, :] = sum_{k = 0 .. bag_size-1} table[ids[b, k], :]   (sum mode)
//   out[b, :] = that sum / (float)bag_size                       (mean mode)
//   summed in k order, one round-to-nearest add each (__fadd_rn, never
//   contracted into an FMA), the division correctly rounded (__fdiv_rn), so
//   the result equals the plain version in ref.py (a loop of bag_size
//   gathers and adds, then a true division) bitwise. Ids follow jnp.take,
//   which the reference model uses: an id in [-V, 0) wraps to id + V, and
//   any other id outside [0, V) makes its bag a NaN row (no host sync, no
//   out-of-bounds read; the Pallas kernel would DMA out of bounds).
//   The TPU kernel scalar-prefetched the ids and streamed one (1, d_block)
//   row per grid step (n_bags, D / 128, bag_size) into a VMEM accumulator;
//   its wrapper padded D to 128 lanes. None of that carries over: here a
//   warp owns a bag and walks its ids, any D is taken without padding.
//   Bound: memory. It reads each looked-up table row (at least every
//   distinct one once: U * D * 4 bytes), the ids (n_bags * bag_size * 4) and
//   writes the output (n_bags * D * 4); the adds are one per row element,
//   far below the card's float32 rate.
//   Design: one warp per bag (8 bags per 256-thread block), no shared
//   memory and no atomics, no block depends on another. The lanes stride
//   over the row's columns: float4 when D % 4 == 0 and both the table and
//   the output are 16 B aligned, one float otherwise. For each of the lane's
//   columns the k loop reads ids[b, k] (one address for the whole warp: a
//   broadcast from L1) and adds the row's element; the loads of one column
//   for successive k are independent, so the compiler keeps several in
//   flight while the adds stay in k order. Row offsets are 64-bit: id * D
//   passes 2^31 at 10,000,000 x 256.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// the row id[k] names, or -1 for an id outside [-V, V) (a NaN row)
__device__ __forceinline__ long long row_of(int id, long long V) {
  long long r = (long long)id;
  if (r < 0) r += V;
  return (r >= 0 && r < V) ? r : -1;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
  return a;
}

__global__ void embedding_bag_vec4_kernel(const float4* __restrict__ table,
                                          const int* __restrict__ ids,
                                          float4* __restrict__ out,
                                          long long V, long long n_bags,
                                          int bag_size, long long D4,
                                          int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_bags) return;
  const int* bag = ids + b * bag_size;
  const float nan = __int_as_float(0x7fffffff);
  const float fbs = (float)bag_size;
  const float4 nan4 = make_float4(nan, nan, nan, nan);
  for (long long c = lane; c < D4; c += 32) {
    long long r = row_of(bag[0], V);
    float4 acc = r >= 0 ? table[r * D4 + c] : nan4;
    for (int k = 1; k < bag_size; ++k) {
      r = row_of(bag[k], V);
      acc = add4(acc, r >= 0 ? table[r * D4 + c] : nan4);
    }
    if (mean) {
      acc.x = __fdiv_rn(acc.x, fbs);
      acc.y = __fdiv_rn(acc.y, fbs);
      acc.z = __fdiv_rn(acc.z, fbs);
      acc.w = __fdiv_rn(acc.w, fbs);
    }
    out[b * D4 + c] = acc;
  }
}

__global__ void embedding_bag_scalar_kernel(const float* __restrict__ table,
                                            const int* __restrict__ ids,
                                            float* __restrict__ out,
                                            long long V, long long n_bags,
                                            int bag_size, long long D,
                                            int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_bags) return;
  const int* bag = ids + b * bag_size;
  const float nan = __int_as_float(0x7fffffff);
  for (long long c = lane; c < D; c += 32) {
    long long r = row_of(bag[0], V);
    float acc = r >= 0 ? table[r * D + c] : nan;
    for (int k = 1; k < bag_size; ++k) {
      r = row_of(bag[k], V);
      acc = __fadd_rn(acc, r >= 0 ? table[r * D + c] : nan);
    }
    if (mean) acc = __fdiv_rn(acc, (float)bag_size);
    out[b * D + c] = acc;
  }
}

}  // namespace

extern "C" int embedding_bag_f32(const float* table, const int* ids, float* out,
                                 long long V, long long n_bags,
                                 long long bag_size, long long D, int mean,
                                 cudaStream_t stream) {
  if (n_bags <= 0 || bag_size <= 0 || D <= 0 || V <= 0 || bag_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const long long grid = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec4 = D % 4 == 0 && ((uintptr_t)table % 16 == 0) &&
                    ((uintptr_t)out % 16 == 0);
  if (vec4) {
    embedding_bag_vec4_kernel<<<(unsigned)grid, kWarpsPerBlock * 32, 0, stream>>>(
        reinterpret_cast<const float4*>(table), ids,
        reinterpret_cast<float4*>(out), V, n_bags, (int)bag_size, D / 4, mean);
  } else {
    embedding_bag_scalar_kernel<<<(unsigned)grid, kWarpsPerBlock * 32, 0, stream>>>(
        table, ids, out, V, n_bags, (int)bag_size, D, mean);
  }
  return (int)cudaGetLastError();
}
