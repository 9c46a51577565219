// EmbeddingBag over fixed-size bags (the two-tower retrieval model's
// towers), hand written for Hopper (sm_90a). Plain C entry point, loaded
// with ctypes by repro_torch/kernels/embedding_bag/ops.py; it launches on
// the caller's stream, allocates nothing and returns a CUDA error code.
//
// embedding_bag_f32 replaces embedding_bag_pallas
// (src/repro/kernels/embedding_bag/embedding_bag.py:33):
//   out[b, :] = sum_{k = 0 .. bag_size-1} table[ids[b, k], :]   (sum mode)
//   out[b, :] = that sum / (float)bag_size                       (mean mode)
//   summed in k order, one round-to-nearest add each (__fadd_rn, never
//   contracted into an FMA), starting from row 0 itself (not from a zero,
//   which would turn -0 into +0), the division correctly rounded
//   (__fdiv_rn), so the result equals the plain version in ref.py (a loop
//   of bag_size gathers and adds, then a true division) bitwise. Ids follow
//   jnp.take, which the reference model uses: an id in [-V, 0) wraps to
//   id + V, and any other id outside [0, V) makes its bag a NaN row (no
//   host sync, no out-of-bounds read; the Pallas kernel would DMA out of
//   bounds). The TPU kernel scalar-prefetched the ids and streamed one
//   (1, d_block) row per grid step (n_bags, D / 128, bag_size) into a VMEM
//   accumulator; its wrapper padded D to 128 lanes. None of that carries
//   over: here any D is taken without padding.
//
//   Bound: memory. The least traffic reads each distinct row once (U * D *
//   4 bytes), the ids once and writes the output once; the adds, one per
//   looked-up element, are far below the card's float32 rate. Where ids are
//   uniform over a table many times the 50 MB L2 (serve_bulk: 9.65 M
//   distinct rows of 33.6 M lookups in a 10 GB table, bags scattered over
//   the whole call), no order of the work keeps a row or an output line in
//   cache between its uses, so such a call reads one row per lookup and
//   runs at the memory's rate at best. Where ids repeat inside a few
//   consecutive bags (the training batches: a user's 8 bags of 16 are one
//   id), a row need be read once for all of them.
//   Design: a block owns items, each a tile of `tile` consecutive bags and
//   one part (`slab` columns) of their rows; persistent blocks walk the
//   items. Warps 0-3 (producers) take an item's ids, one a thread, copied
//   kAhead items ahead into shared memory; they wrap them and find for each
//   slot the first slot of the tile naming the same row (__match_any_sync
//   inside a warp, 32 shuffles against each earlier warp), then copy each
//   distinct row once into a stage of a ring in shared memory: one
//   cp.async.bulk a row, completing on the stage's mbarrier, so a fill's
//   bytes stay in flight while the ring's other stages are summed (one
//   block a SM with three 64 KB stages for bulk calls and small calls of
//   128-id items, two blocks a SM with two 48 KB stages for the rest: the
//   plan picks). An item
//   goes in one fill where its distinct rows fit a stage at the part's
//   width (a training tile: one to ~40 rows), else in fills of as many
//   columns as a stage holds for every slot (uniform ids: two 512-byte
//   halves of a 1 KB row). Warps 4-11 (consumers) wait on the stage's full
//   barrier, read the fill's descriptor and each slot's staged-row offset
//   (a NaN row for an id that names none), and sum two columns of one bag
//   a thread in k order; each consumer warp then releases the stage on its
//   empty barrier. A bag with more ids than an item holds (kProducers) is
//   taken in chunks of ids, its sums carried in registers from one fill to
//   the next. Small batches split the columns into narrower parts so every
//   SM gets items. Where D % 4 != 0 or the table or output is not 16-byte
//   aligned, the same kernel moves single floats (4-byte cp.async). The
//   host's launch plan (ops.launch_plan: route, tile, ids per item, slab,
//   parts, stage size, blocks a SM, grid, shared memory) is a function of
//   the shapes alone; this file checks it against its own limits. Row offsets are
//   64-bit: id * D passes 2^31 at 10,000,000 x 256.
//
//   The constants below (copy method, ring depth, ids ahead) were chosen on
//   the H100 by scripts/pt_embedding_bag.py, which builds each alternative
//   from a copy of this file with one substitution.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// warps 0..3 deduplicate an item's ids and copy its rows (the producers),
// warps 4..11 add (the consumers)
constexpr int kProducers = 128;  // also the most ids an item holds
constexpr int kConsumers = 256;  // two values each: the most a fill sums
constexpr int kThreads = kProducers + kConsumers;
constexpr int kPWarps = kProducers / 32;
constexpr int kBatch = 8;  // ids whose staged rows a consumer loads at once
// the two launch shapes: one block a SM with a kStages-deep ring of large
// stages, or two blocks a SM (registers for both) with two stages each
constexpr int kStages = 3;
constexpr int kStagesTwoBlocks = 2;
constexpr int kAhead = 4;  // items whose ids a producer holds
constexpr unsigned kFull = 0xffffffffu;
static_assert(kStages >= 2, "the ring needs two stages to overlap");
static_assert(kBatch % 4 == 0, "offsets are loaded four at a time");

// a fill's geometry, written by producer thread 0 beside the stage
struct Desc {
  long long b0, c0;  // first bag, first column
  int wc, k0, kn;    // columns; the ids k0 .. k0 + kn - 1 of each bag
  int done;          // no more fills
};

// shared memory ahead of S stages: a full and an empty barrier and a
// fill descriptor per stage, then per slot its row and (first slots) its
// distinct row, each stage's slot -> staged row map (the row's offset from
// the first stage, or the NaN row's after the last stage), the ids of the
// next kAhead items, and each producer warp's ballot of first slots;
// padded to 128 bytes (ops.py computes the same)
__host__ __device__ constexpr int meta_bytes(int stages) {
  return (16 * stages + (int)sizeof(Desc) * stages + 16 * kProducers +
          4 * kProducers * (stages + kAhead) + 4 * kPWarps + 127) / 128 * 128;
}

// what the host's launch plan fixes
struct Plan {
  long long V, n_bags, D;
  int bag;    // ids per bag
  int tile;   // bags per tile (1 when a bag spans items)
  int chunk;  // ids of a bag per item
  int slab;   // columns per part (a multiple of the vector width)
  int parts;  // parts per tile
  int stage;  // floats a stage holds
  int mean;
};

// the row id names, or -1 for an id outside [-V, V) (a NaN row)
__device__ __forceinline__ long long row_of(int id, long long V) {
  long long r = (long long)id;
  if (r < 0) r += V;
  return (r >= 0 && r < V) ? r : -1;
}

__device__ __forceinline__ float add_v(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add_v(float4 a, float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
  return a;
}
// a / d correctly rounded; where d is a power of two, a * (1 / d) is the
// same exact quotient rounded once (rcp: 1 / d, or 0 for another d)
__device__ __forceinline__ float div1(float a, float d, float rcp) {
  return rcp != 0.f ? __fmul_rn(a, rcp) : __fdiv_rn(a, d);
}
__device__ __forceinline__ float div_v(float a, float d, float rcp) {
  return div1(a, d, rcp);
}
__device__ __forceinline__ float4 div_v(float4 a, float d, float rcp) {
  a.x = div1(a.x, d, rcp);
  a.y = div1(a.y, d, rcp);
  a.z = div1(a.z, d, rcp);
  a.w = div1(a.w, d, rcp);
  return a;
}
template <typename V>
__device__ __forceinline__ V nan_v();
template <>
__device__ __forceinline__ float nan_v<float>() { return __int_as_float(0x7fffffff); }
template <>
__device__ __forceinline__ float4 nan_v<float4>() {
  const float n = __int_as_float(0x7fffffff);
  return make_float4(n, n, n, n);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one value from shared memory at a 32-bit shared address
__device__ __forceinline__ void lds(uint32_t a, float* v) {
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(*v) : "r"(a) : "memory");
}
__device__ __forceinline__ void lds(uint32_t a, float4* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v->x), "=f"(v->y), "=f"(v->z), "=f"(v->w)
               : "r"(a) : "memory");
}

// one float (4 bytes, aligned) from global to shared memory
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

// one arrival on the barrier once every cp.async this thread has issued
// is complete (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's cp.async groups but the newest N are complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the producer warps' own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::
          "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
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

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory in one bulk copy, completing on the barrier's tx count
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one item: a (tile, part) pair's ids [id0, id0 + n) (a chunk of one
// bag's ids when a bag spans items), columns [c0, c0 + wc)
struct Item {
  long long b0, id0, c0;
  int k0, kn, n, wc;
};

// a block's place in its sequence of items: item blockIdx.x + j * gridDim.x
// is (tile, part) = divmod(item, parts), each n_chunks chunks of its bags'
// ids; advanced without a division
struct Cursor {
  long long tile;
  int part, chunk;

  __device__ __forceinline__ void next(const Plan& p, int n_chunks,
                                       long long grid_tiles, int grid_parts) {
    if (++chunk < n_chunks) return;
    chunk = 0;
    tile += grid_tiles;
    part += grid_parts;
    if (part >= p.parts) {
      part -= p.parts;
      ++tile;
    }
  }

  __device__ __forceinline__ Item item(const Plan& p, int n_chunks) const {
    Item I;
    I.b0 = tile * p.tile;
    I.k0 = chunk * p.chunk;
    I.kn = min(p.chunk, p.bag - I.k0);
    I.n = n_chunks == 1 ? p.tile * p.bag : I.kn;
    I.id0 = I.b0 * p.bag + I.k0;
    I.c0 = (long long)part * p.slab;
    I.wc = (int)min((long long)p.slab, p.D - I.c0);
    return I;
  }
};

// K: the type rows are compared in (int where every row fits, V < 2^31)
// S stages a block, registers for B blocks a SM
template <typename V, typename K, int S, int B>
__global__ void __launch_bounds__(kThreads, B)
embedding_bag_kernel(const V* __restrict__ table, const int* __restrict__ ids,
                     V* __restrict__ out, Plan p) {
  constexpr int W = sizeof(V) / sizeof(float);
  constexpr bool kBulk = W == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem);        // [S]
  const uint32_t empty0 = full0 + 8 * S;  // [S]
  Desc* desc = reinterpret_cast<Desc*>(smem + 16 * S);  // [S]
  long long* rows = reinterpret_cast<long long*>(desc + S);
  long long* uniq = rows + kProducers;  // distinct rows (cp.async copies)
  int* slot_off = reinterpret_cast<int*>(uniq + kProducers);  // [stage][slot]
  int* id_ring = slot_off + S * kProducers;  // [kAhead][slot]
  unsigned* wbal = reinterpret_cast<unsigned*>(id_ring + kAhead * kProducers);
  // [stage][p.stage floats], then one row of NaN
  V* stage0 = reinterpret_cast<V*>(smem + meta_bytes(S));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slots = p.tile * p.chunk;
  const int stage_v = p.stage / W;  // values a stage holds
  const int nan_off = S * stage_v;
  const long long Dv = p.D / W;
  const int n_chunks = (p.bag + p.chunk - 1) / p.chunk;
  for (int i = tid; i < p.slab / W; i += kThreads)
    stage0[nan_off + i] = nan_v<V>();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // each producer's release of its slot map entry (one carrying the
      // fill's bytes for bulk copies; cp.async: also each producer's copies)
      mbar_init(full0 + 8 * s, kBulk ? kProducers : 2 * kProducers);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < kPWarps) {
    // producers: slot `tid` of each item. Its id is copied kAhead items
    // ahead into a ring in shared memory (cp.async, a group an item), since
    // under a saturated memory system a load waits microseconds
    const long long n_items = (p.n_bags + p.tile - 1) / p.tile * p.parts;
    const long long my_items =
        ((n_items - 1 - blockIdx.x) / gridDim.x + 1) * n_chunks;
    const long long grid_tiles = gridDim.x / p.parts;
    const int grid_parts = (int)(gridDim.x % p.parts);
    const long long n_ids = p.n_bags * p.bag;
    // columns a fill takes where every slot of the item names another row
    const int narrow = min(p.slab, p.stage / slots / W * W);
    Cursor cur{(long long)(blockIdx.x / p.parts), (int)(blockIdx.x % p.parts),
               0};
    Cursor lc = cur;  // the next item whose ids to copy
    auto has_id = [&](const Item& I) {
      return tid < I.n && I.id0 + tid < n_ids;
    };
    auto fetch = [&](long long q) {
      if (q < my_items) {
        const Item I = lc.item(p, n_chunks);
        lc.next(p, n_chunks, grid_tiles, grid_parts);
        if (has_id(I))
          cp_async(smem_u32(id_ring + (q % kAhead) * kProducers + tid),
                   reinterpret_cast<const float*>(ids + I.id0 + tid));
      }
      cp_async_commit();
    };
#pragma unroll 1
    for (int j = 0; j < kAhead; ++j) fetch(j);

    long long f = 0;  // fills so far
    // wait for stage f % S to be free, then release it to the
    // consumers with `bytes` in flight (cp.async: this thread's copies)
    auto wait_free = [&]() {
      mbar_wait(empty0 + 8 * (int)(f % S),
                (uint32_t)((f / S) & 1) ^ 1u);
    };
    auto release = [&](uint32_t bytes) {
      const uint32_t full = full0 + 8 * (int)(f % S);
      if constexpr (kBulk) {
        if (tid == 0) mbar_expect_tx(full, bytes);
        else mbar_arrive(full);
      } else {
        cp_async_arrive(full);
        mbar_arrive(full);
      }
    };
#pragma unroll 1
    for (long long q = 0; q < my_items; ++q) {
      cp_async_wait<kAhead - 1>();  // item q's id has landed
      const Item G = cur.item(p, n_chunks);
      cur.next(p, n_chunks, grid_tiles, grid_parts);
      const long long r =
          has_id(G) ? row_of(id_ring[(q % kAhead) * kProducers + tid], p.V)
                    : -1;
      asm volatile("" ::"l"(r));  // the slot is read before it is refilled
      fetch(q + kAhead);
      // the first slot naming each row: the warp's leader for it, unless
      // an earlier warp names it too
      const K key = (K)r;
      const int lead = __ffs(__match_any_sync(kFull, key)) - 1;
      rows[tid] = r;
      producers_sync();
      int first = warp * 32 + lead;
      for (int w = 0; w < warp; ++w) {
        const K theirs = (K)rows[w * 32 + lane];
        unsigned hit = 0;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          hit |= (unsigned)(__shfl_sync(kFull, theirs, i) == key) << i;
        if (hit && r >= 0 && first >= warp * 32) first = w * 32 + __ffs(hit) - 1;
        if (__all_sync(kFull, first < warp * 32 || r < 0)) break;
      }
      // a first slot's index among the item's distinct rows, from each
      // warp's ballot of first slots
      const bool is_first = r >= 0 && first == tid;
      const unsigned bal = __ballot_sync(kFull, is_first);
      if (lane == 0) wbal[warp] = bal;
      producers_sync();
      int U = 0, u_first = 0;
#pragma unroll
      for (int w = 0; w < kPWarps; ++w) {
        const unsigned b = wbal[w];
        const int fw = first >> 5;
        if (w < fw) u_first += __popc(b);
        if (w == fw) u_first += __popc(b & ((1u << (first & 31)) - 1));
        U += __popc(b);
      }
      if constexpr (!kBulk) {
        if (is_first) uniq[u_first] = r;
        producers_sync();
      }
      // the item's columns in one fill where its distinct rows fit a stage
      // at that width, else in fills of `narrow` columns
      const int wf = (long long)U * G.wc <= p.stage ? G.wc : narrow;
#pragma unroll 1
      for (int c = 0; c < G.wc; c += wf, ++f) {
        const int st = (int)(f % S);
        const int wc = min(wf, G.wc - c), wv = wc / W;
        wait_free();
        slot_off[st * kProducers + tid] =
            r >= 0 ? st * stage_v + u_first * wv : nan_off;
        if (tid == 0) desc[st] = Desc{G.b0, G.c0 + c, wc, G.k0, G.kn, 0};
        V* dst = stage0 + (long long)st * stage_v;
        const V* src0 = table + (G.c0 + c) / W;
        if constexpr (kBulk) {
          release((uint32_t)(U * wc * 4));
          // each first slot copies its row's columns: one copy a row
          if (is_first)
            bulk_copy(smem_u32(dst + u_first * wv), src0 + r * Dv,
                      (uint32_t)(wc * 4), full0 + 8 * st);
        } else {
          if (wv >= 32) {
            for (int u = warp; u < U; u += kPWarps) {
              const V* src = src0 + uniq[u] * Dv;
              for (int j = lane; j < wv; j += 32)
                cp_async(smem_u32(dst + u * wv + j), src + j);
            }
          } else {  // narrow fills: several rows a warp
            const int rpw = 32 / wv, j = lane % wv;
            if (lane < rpw * wv)
              for (int u = warp * rpw + lane / wv; u < U; u += kPWarps * rpw)
                cp_async(smem_u32(dst + u * wv + j), src0 + uniq[u] * Dv + j);
          }
          release(0);
        }
      }
    }
    // one more fill that tells the consumers to stop
    wait_free();
    if (tid == 0) desc[f % S].done = 1;
    release(0);
  } else {
    // consumers: the W columns cv and cv + half of bag tb of each fill's
    // tile, summed from the staged rows (or the NaN row) in k order; one
    // offset load serves both
    const int c = tid - kProducers;
    const float fbag = (float)p.bag;
    const float rcp = (p.bag & (p.bag - 1)) == 0 ? 1.f / fbag : 0.f;
    V acc0 = nan_v<V>(), acc1 = acc0;
#pragma unroll 1
    for (long long f = 0;; ++f) {
      const int st = (int)(f % S);
      mbar_wait(full0 + 8 * st, (uint32_t)((f / S) & 1));
      const Desc d = desc[st];
      if (d.done) break;
      const int wv = d.wc / W, half = (wv + 1) / 2;
      const int tb = c / half, cv = c % half;
      if (tb < p.tile && cv < wv && d.b0 + tb < p.n_bags) {
        const uint32_t base = smem_u32(stage0 + cv);
        const uint32_t step = half * (int)sizeof(V);
        const int* so = slot_off + st * kProducers + tb * d.kn;
        for (int k0 = 0; k0 < d.kn; k0 += kBatch) {
          int o[kBatch];
          V x0[kBatch], x1[kBatch];
          if (d.kn % kBatch == 0) {  // 16-byte aligned: four offsets a load
#pragma unroll
            for (int j = 0; j < kBatch; j += 4) {
              const int4 o4 = *reinterpret_cast<const int4*>(so + k0 + j);
              o[j] = o4.x;
              o[j + 1] = o4.y;
              o[j + 2] = o4.z;
              o[j + 3] = o4.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < kBatch; ++j) o[j] = so[min(k0 + j, d.kn - 1)];
          }
          bool one_row = true;  // the batch's ids all name one row
#pragma unroll
          for (int j = 1; j < kBatch; ++j) one_row &= o[j] == o[0];
          if (one_row) {  // one load, kBatch adds
            const uint32_t a = base + o[0] * (int)sizeof(V);
            lds(a, &x0[0]);
            lds(a + step, &x1[0]);
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
              if (k0 + j < d.kn) {
                const bool first = j == 0 && k0 == 0 && d.k0 == 0;
                acc0 = first ? x0[0] : add_v(acc0, x0[0]);
                acc1 = first ? x1[0] : add_v(acc1, x1[0]);
              }
            continue;
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const uint32_t a = base + o[j] * (int)sizeof(V);
            lds(a, &x0[j]);
            lds(a + step, &x1[j]);
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            if (k0 + j < d.kn) {
              const bool first = j == 0 && k0 == 0 && d.k0 == 0;
              acc0 = first ? x0[j] : add_v(acc0, x0[j]);
              acc1 = first ? x1[j] : add_v(acc1, x1[j]);
            }
        }
        if (d.k0 + d.kn == p.bag) {
          V* dst = out + (d.b0 + tb) * Dv + d.c0 / W + cv;
          dst[0] = p.mean ? div_v(acc0, fbag, rcp) : acc0;
          if (cv + half < wv) dst[half] = p.mean ? div_v(acc1, fbag, rcp) : acc1;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
  }
}

template <typename V, typename K, int S, int B>
int launch(const V* table, const int* ids, V* out, const Plan& p, int grid,
           int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        embedding_bag_kernel<V, K, S, B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  embedding_bag_kernel<V, K, S, B><<<grid, kThreads, smem, stream>>>(
      table, ids, out, p);
  return (int)cudaGetLastError();
}

template <typename V>
int launch(const V* table, const int* ids, V* out, const Plan& p,
           int blocks, int grid, int smem, cudaStream_t stream) {
  if (p.V <= 0x7fffffffLL)
    return blocks == 1 ? launch<V, int, kStages, 1>(table, ids, out, p, grid,
                                                    smem, stream)
                       : launch<V, int, kStagesTwoBlocks, 2>(
                             table, ids, out, p, grid, smem, stream);
  return blocks == 1 ? launch<V, long long, kStages, 1>(table, ids, out, p,
                                                        grid, smem, stream)
                     : launch<V, long long, kStagesTwoBlocks, 2>(
                           table, ids, out, p, grid, smem, stream);
}

}  // namespace

// the launch plan (ops.launch_plan) passed in: vec (16-byte values), tile,
// chunk, slab, parts, stage, blocks a SM (1: kStages stages; 2:
// kStagesTwoBlocks), grid and smem; a plan that breaks this kernel's limits
// is refused with cudaErrorInvalidValue and nothing is launched
extern "C" int embedding_bag_f32(const float* table, const int* ids, float* out,
                                 long long V, long long n_bags,
                                 long long bag_size, long long D, int mean,
                                 int vec, int tile, int chunk, int slab,
                                 int parts, int stage, int blocks,
                                 long long grid, long long smem,
                                 cudaStream_t stream) {
  const int stages = blocks == 1 ? kStages : kStagesTwoBlocks;
  const int W = vec ? 4 : 1;
  const bool ok =
      n_bags > 0 && bag_size > 0 && bag_size <= 0x7fffffff && D > 0 && V > 0 &&
      tile >= 1 && chunk >= 1 && chunk <= bag_size && chunk <= kProducers &&
      (chunk == bag_size || tile == 1) &&
      (long long)tile * chunk <= kProducers && slab >= W && slab % W == 0 &&
      (long long)tile * ((slab / W + 1) / 2) <= kConsumers &&
      stage % W == 0 && stage >= tile * chunk * W &&
      (chunk == bag_size || slab <= stage / chunk) &&
      parts >= 1 && (long long)parts * slab >= D &&
      (long long)(parts - 1) * slab < D && grid >= 1 && grid <= 0x7fffffffLL &&
      grid <= (n_bags + tile - 1) / tile * parts &&
      (blocks == 1 || blocks == 2) &&
      smem == meta_bytes(stages) + ((long long)stages * stage + slab) * 4 &&
      smem * blocks <= 232448 &&
      (!vec || (D % 4 == 0 && (uintptr_t)table % 16 == 0 &&
                (uintptr_t)out % 16 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const Plan p{V, n_bags, D, (int)bag_size, tile, chunk, slab, parts, stage,
               mean};
  if (vec)
    return launch(reinterpret_cast<const float4*>(table), ids,
                  reinterpret_cast<float4*>(out), p, blocks, (int)grid,
                  (int)smem, stream);
  return launch(table, ids, out, p, blocks, (int)grid, (int)smem, stream);
}
