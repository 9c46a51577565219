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
//   dtype (round to nearest even for bf16), as at flash_attention.py:39-58.
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
//   run in any order, the query tiles with the most keys first.
//   Bound at the prefill shape (B 1, S 32,768, Hq 40, Hkv 10, D 128,
//   causal): 5.37e8 (q, k) pairs per head x 40 heads x 4 x 128 = 1.10e13
//   FLOP, 11.1 ms at the tensor cores' 989 TFLOP/s (164 ms at the 67 TFLOP/s
//   of float32 outside them); q, k, v and o are 0.84 GB, 0.25 ms. So it is
//   bound by operations.
//
// bfloat16: flash_fwd_wgmma, on the tensor cores.
//   One block of 384 threads per (128 query rows, query head, batch). The
//   first warpgroup produces: one thread issues TMA loads (4-D tensor maps
//   over (D, H, S, B), boxes of 64 columns x 128 rows with the 128-byte
//   swizzle) of the Q tile once and of 128-key K and V tiles into a ring of
//   two stages, each stage with a "full" mbarrier (transaction bytes) and an
//   "empty" one (256 consumer arrivals). The other two warpgroups consume,
//   64 query rows each: S = Q K^T is a wgmma m64n128k16 chain over D with Q
//   and K from shared memory (both K-major; a bf16 x bf16 product is exact
//   in float32). The online softmax runs in registers on the accumulator
//   fragment (a thread holds 2 rows x 32 keys; row max and sum over the
//   quad of lanes that share a row), with the reference's -1e30 masking,
//   m / l / corr update and final acc / max(l, 1e-30), in float32, and the
//   mask only on tiles that reach a masked key. p = 2^((s - m) log2 e) on
//   the special-function unit (ex2.approx, ~2^-22 relative) instead of the
//   plain version's expf: three instructions against about ten, in the
//   softmax that bounds this kernel (scripts/pt_kernel_variants.py times
//   both and checks both against plain).
//   P V: the plain version multiplies a float32 P; the tensor cores take P
//   in bf16. One bf16 rounding of P moves outputs past one bf16 ulp of
//   plain on every shape of the card tests' grid; two terms, P_hi =
//   bf16(p) and P_lo = bf16(p - P_hi), still miss it at outputs near 0
//   (up to 2^-18 p of error, more than the check's 1e-6 there) and miss
//   the prefill's 2^-7 check (tests/test_torch_flash_attention.py
//   emulates both, scripts/pt_kernel_variants.py runs both on the card,
//   PERF.md has the numbers). So P is three
//   bf16 terms (to 2^-26 of p), each multiplied by V with a register-A
//   wgmma m64nDPk16 (V from shared memory in its natural key-major layout,
//   an MN-major B) into a fresh float32 accumulator pv, the smallest term
//   first; then acc = acc * corr + pv in float32 with two roundings, as the
//   plain version adds them (fed straight into acc, the tensor cores' own
//   float32 sums drift from plain's over a 32k row). The design's tensor
//   work is twice the attention's (Q K^T once, P V three times): its own
//   floor is 22.2 ms at the prefill shape. acc lives in shared memory (64
//   KB, each thread's own float4 slots), which frees the registers for the
//   three terms and pv. No atomics: a rerun is bitwise equal.
//   Scheduling: the two consumer warpgroups take turns on the tensor cores
//   (named barriers 2 and 3). In its turn a warpgroup issues P V of its
//   last tile, waits for it, issues S = Q K^T of the next tile and hands
//   the turn over; its fold of pv into acc, and its softmax of the new S,
//   run under the other's turn. Without turns the two fall into step and
//   leave the tensor cores idle during both softmaxes; turns in the order
//   S, S, P V, P V leave them idle during each softmax.
//   What the design does about each trouble spot: the tensor maps come from
//   cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion (the
//   library links the runtime only, no -lcuda); D pads to DP = 64 or 128
//   (TMA fills columns past D, rows past S and the next batch's rows with
//   zeros, so every D <= 128 and ragged Sq / Skv are taken; keys past Skv
//   are masked to -inf); a 128-wide D is two boxes, and the descriptors
//   step 32 bytes inside a swizzled 128-byte row for the K-major Q and K
//   and 2 KB (16 key rows) for V, with the 8-row groups 1 KB apart and V's
//   64-column boxes 16 KB apart; a tensor that breaks TMA's rules (a base
//   not 16-byte aligned, or D * 2 not a multiple of 16) is loaded by the
//   producer warpgroup's 128 threads into the same swizzled layout
//   (fence.proxy.async before the barrier arrival), so no shape leaves this
//   kernel; register fragments and accumulators are pinned across
//   wgmma.fence / commit_group / wait_group; setmaxnreg gives the producer
//   40 registers and the consumers 232 (24 / 240 measured the same); a
//   barrier wait that outlasts ~2^34 cycles traps instead of hanging.
//   Shared memory at DP 128: Q 32 KB, two stages of K and V 32 KB each,
//   acc 64 KB: 225 KB, one block per SM.
//   Tried and not kept, for being slower at the prefill shape or no
//   faster: a third K/V stage; separate K and V barriers, so K reloads
//   right after Q K^T (more registers, more spills); acc in registers; the
//   fold inside the turn.
//
// float32: flash_fwd_kernel (namespace simt), on the CUDA cores. Float32
//   means float32 here: TF32 tensor cores (10 mantissa bits) would miss the
//   2e-5 check against the float64 oracle. One block of 256 threads per (64
//   query rows, query head, batch) holds its Q tile transposed in shared
//   memory (zero-padded from D to DP = 32, 64 or 128) and walks 64-key
//   tiles of K (stored transposed) and V; thread (ty, tx) owns query rows
//   4ty..4ty+3, keys 4tx..4tx+3 of S (a 4 x 4 register tile) and DP/16
//   output columns; P goes through shared memory over the K tile. 164 ms is
//   its floor at the prefill shape; the LM runs in bf16.
//
// ptxas (nvcc 12.9, sm_90a): flash_fwd_wgmma 168 registers at launch (the
// producer gives up to 40, the consumers take 232); spills 44 bytes (stores;
// 60 loads at DP 128, 72 at DP 64); 16 barriers (the named barriers take
// their ids from registers); 225 KB of dynamic shared memory at DP 128.
// flash_fwd_kernel 113 / 95 / 89 registers at DP 128 / 64 / 32, no spills,
// 100 KB of shared memory at DP 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace simt {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 68;       // row stride (floats) of the transposed tiles
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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

}  // namespace simt

namespace hopper {


constexpr int kM = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kN = 128;        // keys per tile, the plain version's KV block
constexpr int kStages = 2;     // K/V ring
constexpr int kThreads = 384;  // producer warpgroup, then two consumer warpgroups
constexpr int kBox = 64;       // bf16 columns of a TMA box: 128 bytes, the swizzle span
constexpr int kTerms = 3;      // bf16 terms of P in P V
constexpr float kNeg = -1e30f;

// Shared memory of one block, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes). A tile of R rows x DP columns
// is DP / 64 boxes of R x 64 bf16, box after box; Q, the K ring, the V ring,
// the O accumulators, then the mbarriers: q_full, full[kStages],
// empty[kStages].
template <int DP>
struct Layout {
  static constexpr int kQBytes = kM * DP * 2;
  static constexpr int kTileBytes = kN * DP * 2;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  // the consumers' O accumulators, thread-private float4 slots
  static constexpr int kAcc = kV + kStages * kTileBytes;
  static constexpr int kBar = kAcc + 2 * 128 * (DP / 2) * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack for the alignment
};

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
// a wait of more than ~2^34 cycles (seconds: no tile load takes that long)
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

// one box (64 columns x `rows` rows) of a (B, S, H, D) bf16 tensor into
// shared memory, completing `bytes` on the barrier; rows past S and columns
// past D arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
      "r"(s0), "r"(b)
      : "memory");
}

// a wgmma shared-memory descriptor with the 128-byte swizzle; offsets in
// 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins a register across the asynchronous wgmma: reads and writes of it are
// not moved across this point
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

constexpr float kLog2e = 1.4426950408889634f;
// 2^x by the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, float32) += A (64 x 16) B (16 x 128), bf16, A and B from shared
// memory, both K-major (descriptors da, db)
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, bf16, registers a0..a3) B (16 x 128,
// bf16, shared memory, MN-major: descriptor db, transposed)
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, bf16, registers a0..a3) B (16 x 64,
// bf16, shared memory, MN-major: descriptor db, transposed)
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Stores rows [r0, r0 + rows) of one head of a (B, S, H, D) bf16 tensor into
// a tile in the TMA layout (box c / 64, row r at 128 r bytes, 16-byte chunk
// j of the row at chunk j ^ (r % 8)), zeros past S and D, with the 128
// threads of the producer warpgroup. For tensors whose strides or base TMA
// cannot take.
template <int DP>
__device__ void load_tile_by_threads(uint8_t* dst, const __nv_bfloat16* g,
                                     long long bS, int r0, int rows, int S,
                                     int H, int hh, int D, int tid) {
  for (int e = tid; e < rows * DP; e += 128) {
    const int r = e / DP, c = e % DP, pos = r0 + r;
    __nv_bfloat16 x = __float2bfloat16_rn(0.f);
    if (pos < S && c < D) x = g[((bS + pos) * H + hh) * (long long)D + c];
    const int cc = c % kBox;
    const int off = (c / kBox) * rows * 128 + r * 128 +
                    ((((cc >> 3) ^ (r & 7))) << 4) + (cc & 7) * 2;
    *reinterpret_cast<__nv_bfloat16*>(dst + off) = x;
  }
  // make the generic-proxy stores visible to wgmma's (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                    int Hkv, int D, float scale, int causal, int has_window,
                    int window, int tma_mask) {
  using L = Layout<DP>;
  constexpr int NS = kN / 2;   // S accumulator floats a thread
  constexpr int NO = DP / 2;   // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + kStages);

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kM;
  const int q_last = min(q0 + kM, Sq) - 1;
  int kt_begin = 0, kt_end = (Skv + kN - 1) / kN;
  if (causal) kt_end = min(kt_end, q_last / kN + 1);
  if (has_window && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: thread 0 issues the TMA loads; all 128
    // threads load a tensor TMA cannot take
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int tid = threadIdx.x;
    const bool by_threads = tma_mask != 7;
    if (!by_threads && tid != 0) return;
    if (!(tma_mask & 1))
      load_tile_by_threads<DP>(sbase, q, (long long)b * Sq, q0, kM, Sq, Hq, h,
                               D, tid);
    if (by_threads) asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (tid == 0) {
      if (tma_mask & 1) {
        mbar_expect_tx(bar_q, L::kQBytes);
        for (int x = 0; x < DP / kBox; ++x)
          tma_load(sQ + x * kM * 128, &tq, bar_q, x * kBox, h, q0, b);
      } else {
        mbar_arrive(bar_q);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * kN;
      mbar_wait(bar_empty + 8 * stage, phase ^ 1);  // round 0 passes at once
      const uint32_t kdst = sK + stage * L::kTileBytes;
      const uint32_t vdst = sV + stage * L::kTileBytes;
      if (by_threads) {
        if (!(tma_mask & 2))
          load_tile_by_threads<DP>(sbase + (kdst - base), k, (long long)b * Skv,
                                   k0, kN, Skv, Hkv, hk, D, tid);
        if (!(tma_mask & 4))
          load_tile_by_threads<DP>(sbase + (vdst - base), v, (long long)b * Skv,
                                   k0, kN, Skv, Hkv, hk, D, tid);
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      }
      if (tid == 0) {
        const uint32_t bytes = ((tma_mask & 2) ? L::kTileBytes : 0) +
                               ((tma_mask & 4) ? L::kTileBytes : 0);
        const uint32_t full = bar_full + 8 * stage;
        if (bytes) {
          mbar_expect_tx(full, bytes);
          for (int x = 0; x < DP / kBox; ++x) {
            if (tma_mask & 2)
              tma_load(kdst + x * kN * 128, &tk, full, x * kBox, hk, k0, b);
            if (tma_mask & 4)
              tma_load(vdst + x * kN * 128, &tv, full, x * kBox, hk, k0, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroups: rows cw * 64 .. cw * 64 + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // a thread holds rows r and r + 8 of its warp's 16, and in each 8-column
    // group j of an accumulator the columns 8 j + 2 (lane % 4) + {0, 1}:
    // x[4 j + {0, 1}] on row r, x[4 j + {2, 3}] on row r + 8
    const int qpos0 = q0 + cw * 64 + warp * 16 + lane / 4, qpos1 = qpos0 + 8;
    const int col = 2 * (lane % 4);
    const int wg_first = q0 + cw * 64, wg_last = wg_first + 63;

#pragma unroll
    for (int g = 0; g < NO / 4; ++g)
      *reinterpret_cast<float4*>(sbase + L::kAcc +
                                 ((cw * (NO / 4) + g) * 128 + t) * 16) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    float c0 = 1.f, c1 = 1.f;   // the last tile's corr, for its P V
    uint32_t pt[kTerms][NS / 2];  // the last tile's P, kTerms bf16 terms
    const uint32_t qa = sQ + cw * 64 * 128;  // this warpgroup's rows, box 0
    mbar_wait(bar_q, 0);

    // The two warpgroups take turns on the tensor cores (named barriers 2
    // and 3, "warpgroup 0 / 1 may issue"): in its turn a warpgroup issues
    // P V of its last tile and then S = Q K^T of the next; its softmax of
    // that S then runs under the other's turn. Warpgroup 0 goes first.
    if (cw == 1) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
    int stage = 0, prev_stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt <= kt_end; ++kt) {
      asm volatile("bar.sync %0, 256;\n" ::"r"(2 + cw) : "memory");
      // pv = P V of the last tile in a fresh accumulator, the smallest term
      // first; folded below into acc = acc * corr + pv in float32, two
      // roundings, as the plain version adds them
      const bool have_pv = kt > kt_begin;
      float pv[NO];
      if (have_pv) {
        const uint32_t vb = sV + prev_stage * L::kTileBytes;
#pragma unroll
        for (int i = 0; i < NO; ++i) pv[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int tm = kTerms - 1; tm >= 0; --tm) {
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk) {
            // keys 16 kk .. 16 kk + 15: two 8-row groups 1 KB apart (SBO),
            // the 64-column boxes kN * 128 bytes apart (LBO)
            const uint64_t db = desc_sw128(vb + kk * 16 * 128, (kN * 128) >> 4,
                                           1024 >> 4);
            if constexpr (DP == 128)
              wgmma_rs_m64n128_tb(pv, pt[tm][4 * kk], pt[tm][4 * kk + 1],
                                  pt[tm][4 * kk + 2], pt[tm][4 * kk + 3], db);
            else
              wgmma_rs_m64n64_tb(pv, pt[tm][4 * kk], pt[tm][4 * kk + 1],
                                 pt[tm][4 * kk + 2], pt[tm][4 * kk + 3], db);
          }
        }
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int i = 0; i < NO; ++i) pin(pv[i]);
#pragma unroll
        for (int tm = 0; tm < kTerms; ++tm)
#pragma unroll
          for (int i = 0; i < NS / 2; ++i) pin(pt[tm][i]);
        mbar_arrive(bar_empty + 8 * prev_stage);  // its K and V are read
      }
      // acc = acc * corr + pv, in this thread's float4 slots
      auto fold = [&]() {
#pragma unroll
        for (int g = 0; g < NO / 4; ++g) {
          float4* slot = reinterpret_cast<float4*>(
              sbase + L::kAcc + ((cw * (NO / 4) + g) * 128 + t) * 16);
          float4 a = *slot;
          a.x = __fadd_rn(__fmul_rn(a.x, c0), pv[4 * g]);
          a.y = __fadd_rn(__fmul_rn(a.y, c0), pv[4 * g + 1]);
          a.z = __fadd_rn(__fmul_rn(a.z, c1), pv[4 * g + 2]);
          a.w = __fadd_rn(__fmul_rn(a.w, c1), pv[4 * g + 3]);
          *slot = a;
        }
      };
      if (kt == kt_end) {
        // the other warpgroup's last turn (warpgroup 1 ends the exchange)
        if (cw == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
        fold();
        break;
      }

      // S = Q K^T: D in steps of 16 (32 bytes inside a 128-byte swizzled
      // row, the next box every 4 steps); 8-row groups 1024 bytes apart
      const int k0 = kt * kN;
      const uint32_t kb = sK + stage * L::kTileBytes;
      mbar_wait(bar_full + 8 * stage, phase);
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * 128 * 128 + (kk % 4) * 32;
        wgmma_ss_m64n128(s, desc_sw128(qa + off, 1, 1024 >> 4),
                         desc_sw128(kb + off, 1, 1024 >> 4));
      }
      wg_commit();
      // the other warpgroup's P V queues behind this S on the tensor cores;
      // the fold runs while S does
      asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - cw) : "memory");
      if (have_pv) fold();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < NS; ++i) pin(s[i]);

      // scale and mask (only tiles that reach a masked key), row max
      const bool need_mask = k0 + kN > Skv ||
                             (causal && k0 + kN - 1 > wg_first) ||
                             (has_window && wg_last - k0 >= window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale;
          if (need_mask) {
            const int kpos = k0 + 8 * j + col + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            if (causal && qpos < kpos) x = kNeg;
            if (has_window && qpos - kpos >= window) x = kNeg;
            if (kpos >= Skv) x = -INFINITY;
          }
          s[4 * j + e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      }
      // the four lanes of a row are lanes 4 (lane / 4) .. + 3
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      c0 = expf(m0 - mn0);
      c1 = expf(m1 - mn1);

      // p = exp(s - m) = 2^((s - m) log2 e) in float32 on the special-
      // function unit (plain's expf differs by ~2^-22 relative, which moves
      // no output past a bf16 ulp), split into kTerms bf16 terms (each the
      // rounding of what the ones before leave of p: P to 2^-26 of p), packed
      // as the A fragments of P V: the accumulator layout of S is the A
      // fragment layout, registers 2 i and 2 i + 1 make pair i
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        const float mn = (i & 1) ? mn1 : mn0;
        float pa = ex2_approx((s[2 * i] - mn) * kLog2e),
              pb = ex2_approx((s[2 * i + 1] - mn) * kLog2e);
        if (i & 1)
          rs1 += pa + pb;
        else
          rs0 += pa + pb;
#pragma unroll
        for (int tm = 0; tm < kTerms; ++tm) {
          const __nv_bfloat162 t2 = __floats2bfloat162_rn(pa, pb);
          pt[tm][i] = *reinterpret_cast<const uint32_t*>(&t2);
          pa -= __low2float(t2);
          pb -= __high2float(t2);
        }
      }
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
      m0 = mn0;
      m1 = mn1;
      prev_stage = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // o = acc / max(l, 1e-30), rounded once to bf16
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    float acc[NO];
#pragma unroll
    for (int g = 0; g < NO / 4; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(
          sbase + L::kAcc + ((cw * (NO / 4) + g) * 128 + t) * 16);
      acc[4 * g] = a.x;
      acc[4 * g + 1] = a.y;
      acc[4 * g + 2] = a.z;
      acc[4 * g + 3] = a.w;
    }
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? qpos0 : qpos1;
        const int c = 8 * j + col + (e & 1);
        if (qpos < Sq && c < D)
          o[((long long)(b * (long long)Sq + qpos) * Hq + h) * D + c] =
              __float2bfloat16_rn(__fdiv_rn(acc[4 * j + e], e < 2 ? d0 : d1));
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (the
// library is linked against the runtime only, not libcuda)
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &qr) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &qr) != cudaSuccess)
      return nullptr;
#endif
    if (qr != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// TMA's rules for this (D, H, S, B) view: a 16-byte aligned base and strides
// that are multiples of 16 bytes (D * 2 and H * D * 2)
bool tma_can_take(const void* ptr, long long D) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (D * 2) % 16 == 0;
}

// boxes of 64 columns x `rows` rows of one head, 128-byte swizzle, zeros out
// of bounds
int make_map(CUtensorMap* map, const void* ptr, long long B, long long S,
             long long H, long long D, int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(D * 2), (cuuint64_t)(H * D * 2),
                                 (cuuint64_t)(S * H * D * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long Sq, long long Skv, long long Hq, long long Hkv,
           long long D, int causal, long long window, cudaStream_t stream) {
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const void* ptrs[3] = {q, k, v};
  int mask = 0;
  for (int i = 0; i < 3; ++i) {
    if (!tma_can_take(ptrs[i], D)) continue;
    const int err = i == 0 ? make_map(&maps[0], q, B, Sq, Hq, D, kM)
                           : make_map(&maps[i], ptrs[i], B, Skv, Hkv, D, kN);
    if (err) return err;
    mask |= 1 << i;
  }
  constexpr int smem = Layout<DP>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kM - 1) / kM), (unsigned)Hq, (unsigned)B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_wgmma<DP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), (int)Sq, (int)Skv, (int)Hq, (int)Hkv,
      (int)D, scale, causal, window >= 0, window >= 0 ? (int)window : 0, mask);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, long long B,
             long long Sq, long long Skv, long long Hq, long long Hkv,
             long long D, int causal, long long window, cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, stream);
  return launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, stream);
}

}  // namespace hopper

// dtype: 0 float32 (SIMT), 1 bfloat16 (wgmma). window < 0: no window; the
// wrapper clamps a window wider than Sq + Skv and refuses window < 1 and
// rows without an unmasked key.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, long long B, long long Sq,
                                   long long Skv, long long Hq, long long Hkv,
                                   long long D, int causal, long long window,
                                   cudaStream_t stream) {
  const long long kIntMax = 0x7fffffffLL;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || D <= 0 ||
      D > 128 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      Sq > kIntMax - simt::kBlockQ || Skv > kIntMax - simt::kBlockK ||
      window > kIntMax || window == 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return simt::dispatch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                                 window, stream);
  if (dtype == 1)
    return hopper::dispatch(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                            stream);
  return (int)cudaErrorInvalidValue;
}
