// Causal / sliding-window GQA attention with an online softmax (the LM's
// prefill attention), hand written for Hopper (sm_90a). Plain C entry point,
// loaded with ctypes by repro_torch/kernels/flash_attention/ops.py; it
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// flash_attention_fwd replaces flash_attention_kernel
// (src/repro/kernels/flash_attention/flash_attention.py:72) and the KV repeat
// of its wrapper (ops.py there):
//   q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), float32 or bf16, one dtype
//   for all three; query head h reads KV head h / (Hq / Hkv), the reference's
//   reshape(B, S, Hkv, G, D) order, read in place (nothing is repeated or
//   transposed in memory). Positions start at 0 for q and k alike.
//   s = (q . k) * (1 / sqrt(D)), then s = -1e30 where causal and qpos < kpos
//   or where qpos - kpos >= window; the online softmax keeps m, l and acc in
//   float32 (m from -1e30, p = exp(s - m), l = l * corr + sum p, acc = acc *
//   corr + p @ v), and o = acc / max(l, 1e-30) is rounded once to the input
//   dtype (round to nearest even for bf16). Every product, score and sum is
//   float32, as at flash_attention.py:39-58; only the order of the sums
//   differs from the plain version (ops.py's flash_attention_ref).
//   Keys past Skv (the ragged last tile) are -inf, so they add exactly 0; a
//   KV tile masked for every row of the query tile is skipped, which is
//   exact because exp(-1e30 - m) is 0 in float32 once a row has met an
//   unmasked key, and wipes what masked keys added before (corr = 0). A row
//   with no unmasked key at all (the reference would return the mean of v)
//   is refused by the wrapper before the launch.
//   The TPU kernel ran a sequential (BH, nQ, nKV) grid over 128 x 128 VMEM
//   blocks, carrying m, l and acc in scratch across the kv steps and needing
//   S % 128 == 0. Here the kv sweep is a loop inside one block, the ragged
//   edges of q and kv are masked in the kernel, and the blocks of a launch
//   run in any order.
//   Bound at the prefill shape (B 1, S 32,768, Hq 40, Hkv 10, D 128,
//   causal): 5.37e8 (q, k) pairs per head x 40 heads x 4 x 128 = 1.10e13
//   FLOP, 11.1 ms at the tensor cores' 989 TFLOP/s and 164 ms at the 67
//   TFLOP/s of float32 outside them; q, k, v and o are 0.84 GB, 0.25 ms. So
//   it is bound by operations. This kernel does them all in float32 on the
//   CUDA cores (no tensor cores, no TF32), so 164 ms is its own floor.
//   Design: one block of 256 threads per (64 query rows, query head, batch),
//   the query tiles with the most keys launched first. The block holds its Q
//   tile transposed in shared memory (float32, zero-padded from D to DP =
//   32, 64 or 128) and walks 64-key tiles of K (stored transposed) and V
//   (row-major), converted to float32 as they are staged. Thread (ty, tx)
//   owns query rows 4ty..4ty+3: in S = Q K^T it computes keys 4tx..4tx+3 (a
//   4 x 4 register tile: two 16-byte shared loads per 16 FMAs), and in
//   O += P V the columns {g*64 + 4tx + c} (or 2tx + c at DP 32), DP/16 of
//   them. The 16 threads that share a row are one half-warp, so the row max
//   and row sum are four xor-shuffles. P goes through shared memory over the
//   K tile, which is dead by then. 100 KB of shared memory at DP 128: two
//   blocks per SM. No atomics: a rerun is bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 68;       // row stride (floats) of the transposed tiles
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the c-th output column of thread tx
template <int DP>
__device__ __forceinline__ int out_col(int tx, int c) {
  constexpr int CPT = DP / 16;
  return CPT >= 4 ? (c / 4) * 64 + tx * 4 + (c % 4) : tx * CPT + c;
}

template <int DP>
constexpr size_t smem_bytes() {
  // Q^T, then K^T (with P^T over it), then V
  return sizeof(float) * ((size_t)DP * kPad +
                          (DP * kPad > kBlockK * kPad ? (size_t)DP * kPad
                                                      : (size_t)kBlockK * kPad) +
                          (size_t)kBlockK * DP);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int Hq, int Hkv, int D, float scale, int causal,
                     int has_window, int window) {
  constexpr int CPT = DP / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [DP][kPad]
  float* Ks = Qs + DP * kPad;                   // [DP][kPad]; P^T [kBlockK][kPad]
  float* Vs = Ks + (DP > kBlockK ? DP : kBlockK) * kPad;  // [kBlockK][DP]
  float* Ps = Ks;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;

  for (int e = tid; e < kBlockQ * DP; e += kThreads) {
    const int r = e / DP, d = e % DP, qpos = q0 + r;
    float x = 0.f;
    if (qpos < Sq && d < D) x = to_f32(q[((b * Sq + qpos) * Hq + h) * D + d]);
    Qs[d * kPad + r] = x;
  }

  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  int kt_begin = 0, kt_end = (Skv + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, q_last / kBlockK + 1);
  if (has_window && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBlockK;

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNeg;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the last tile's readers of P and V are done
    for (int e = tid; e < kBlockK * DP; e += kThreads) {
      const int j = e / DP, d = e % DP, kpos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kpos < Skv && d < D) {
        const long long off = ((b * Skv + kpos) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[d * kPad + j] = kx;
      Vs[j * DP + d] = vx;
    }
    __syncthreads();

    // S = Q K^T over this tile: rows 4ty + i, keys 4tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * kPad + ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Ks[d * kPad + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    // scale, mask, online softmax (float32, the reference's m/l/acc update)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (causal && qpos < kpos) x = kNeg;
        if (has_window && qpos - kpos >= window) x = kNeg;
        if (kpos >= Skv) x = -INFINITY;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_i[i], mt);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K^T: P^T goes over it
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * kPad + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V: rows 4ty + i, columns out_col(tx, c)
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Ps[kk * kPad + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[CPT];
      const float* vrow = Vs + kk * DP;
      if constexpr (CPT >= 4) {
#pragma unroll
        for (int g = 0; g < CPT / 4; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(&vrow[g * 64 + tx * 4]);
          vv[4 * g] = t.x;
          vv[4 * g + 1] = t.y;
          vv[4 * g + 2] = t.z;
          vv[4 * g + 3] = t.w;
        }
      } else {
        const float2 t = *reinterpret_cast<const float2*>(&vrow[tx * 2]);
        vv[0] = t.x;
        vv[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(av[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Sq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((b * Sq + qpos) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = out_col<DP>(tx, c);
      if (col < D) put(orow + col, __fdiv_rn(acc[i][c], l));
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long Sq, long long Skv, long long Hq, long long Hkv,
           long long D, int causal, long long window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBlockQ - 1) / kBlockQ), (unsigned)Hq,
                  (unsigned)B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)Sq, (int)Skv, (int)Hq,
      (int)Hkv, (int)D, scale, causal, window >= 0, window >= 0 ? (int)window : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, long long B,
             long long Sq, long long Skv, long long Hq, long long Hkv,
             long long D, int causal, long long window, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, stream);
  return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. window < 0: no window; the wrapper clamps a
// window wider than Sq + Skv and refuses window < 1 and rows without an
// unmasked key.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, long long B, long long Sq,
                                   long long Skv, long long Hq, long long Hkv,
                                   long long D, int causal, long long window,
                                   cudaStream_t stream) {
  const long long kIntMax = 0x7fffffffLL;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || D <= 0 ||
      D > 128 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      Sq > kIntMax - kBlockQ || Skv > kIntMax - kBlockK || window > kIntMax ||
      window == 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                                   window, stream);
  return (int)cudaErrorInvalidValue;
}
