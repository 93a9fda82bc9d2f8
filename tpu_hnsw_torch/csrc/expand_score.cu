// Block-expansion scoring for Hopper (sm_90a), grouped by block, with an
// optional fused stage-1 top-r.
//
// Replaces: tpu_hnsw/ops/pallas_expand.py::expand_score (Pallas body
// _mk_kernel), the XLA stage-1 einsums beside it in tpu_hnsw/index/block.py
// (_expand_blocks_body, block.py:127-130; the bf16 and int8 stage 1 of
// _expand_blocks_2stage_body, block.py:189-200), and, in the fused entry,
// the stage-1 approx_min_k of block.py:210-212.
//
// What it computes: for query q and each of its p selected blocks
// b = bids[q, j], the score of every row s of block b,
//   L2:      max(q_sq[q] + blocks_sq[b, s] - 2 * dot, 0)
//   IP/cos:  -dot
//   +inf where block_ids[b, s] < 0 (dead or pad row), where the filter mask
//   is given and allowed[b, s] is false (block.py:135-138, 205-209), and for
//   every row when b is outside [0, B). dot is
//   f32 rows:  f32 row . f32 query, f32 FMAs on the CUDA cores (no TF32);
//   bf16 rows: bf16 row . bf16-rounded query, mma.m16n8k16, f32 sums;
//   int8 rows: int32 dot on mma.m16n8k32 s8, dequantised as
//              dot * (q_scale[q] * score_scale[b]), rounded op by op like
//              the plain version, so int8 scores are bit-equal to it.
// Three entries:
//   expand_score_launch: out[q, j, s] f32, the Pallas function's contract;
//   expand_topr_launch and expand_topr_grouped_launch: each query's rq =
//     min(r, p * S) smallest keys (ordered score bits << 32 | j * S + s),
//     ascending, as scores and positions, where the ordered bits are the
//     f32 score's bits with the magnitude flipped when negative (-0 taken
//     as +0), so key order is (score, position). r <= 128, S <= 256. The
//     two are routes of one function (ops/expand.py::topr_route picks).
//
// What bounds it: bytes. Each probed block's rows are read for S outputs a
// query with one multiply-add per byte, far below the card's
// compute-per-byte line; the least time is the distinct probed blocks'
// bytes over the memory rate. In the fused entry the select is the rest
// of the cost: a pair's r-th key takes a chain of warp reductions, each
// tens of cycles, that no load hides unless another CTA is loading.
//
// Both routes and the all-scores entry share a grouping kernel, which
// counting-sorts the Q * p (query, probe) pairs by block id on the device
// (no host synchronisation) and cuts each block's run of pairs into work
// items of one block and up to 32 of its pairs.
//
// The grouped design (namespace grouped; the all-scores entry and the
// grouped route): CTAs of 32 consecutive grouped pairs, two an SM, each a
// chain of two-stage cp.async steps; the top-r form keeps its pairs'
// scores in a shared tile, writes each pair's R = min(r, S) smallest keys
// as int64 and merge_kernel takes each query's rq smallest of its p * R
// (at most 1,024). While one CTA of an SM selects, the other loads. It
// wins where blocks are probed by several queries each (the main path's
// 1,024 and 4,096-query chunks, sparse rerank_k 50): there the selects
// are much of the work. It holds the SMs poorly when pairs are few (Q * p
// / 32 CTAs) and leaves each CTA's loads serial.
//
// The ring (expand_topr_launch), for blocks mostly probed once (config D's
// partition and stacked shapes), rows of many 128-byte slices (d = 1536)
// and any number of keys a query (the sparse path's 27 probes of r = 100,
// the CLI eval's 105 probes of r = 40):
// - One persistent CTA per SM walks the work items round-robin, with one
//   producer warp and two consumer groups of 4 warps that take alternate
//   items. The producer keeps each group's 2 ring slots full (a group busy
//   with its select holds back only its own loads): a slot is 256 block
//   rows x 128 bytes brought by one TMA load (a 3-D tensor map over [B, S,
//   row bytes] with the 128-byte swizzle, so ldmatrix reads without bank
//   conflicts), the item's query rows and row info by cp.async and bulk
//   copies, all completing on the slot's mbarrier. Each consumer warp
//   holds 64 rows x up to 32 queries of int32 (int8) or f32 (bf16) mma
//   accumulators (f32 rows: FMAs, two rows a lane), stores them raw into
//   its group's tile and scores them a lane a (pair, row), so an item of
//   one or two pairs keeps every lane busy.
// - The select keeps no [Q, p, S] scores and no merge cap. Each query has a
//   running threshold key, an upper bound on its r-th key. A group gathers
//   its pairs' ordered scores in its tile and selects them in batches: a
//   pair keeps only its keys at or below the threshold; when more than r
//   lie there it bounds them by a key below which it holds r to 2r keys
//   (found by a bitwise search that stops at the first bit where the count
//   lands there, or its exact r-th key when ties prevent that), which
//   bounds the query's r-th key too, and lowers the threshold to it
//   (atomicMin). So every key of the answer survives, and a pair writes
//   at most min(2r, S) keys, as uint64, into its own slots in device
//   memory. A select kernel then gathers each query's survivors up to its
//   final threshold into shared memory (a warp a query when it has at most
//   512 slots, else 256 threads and up to 4,096 keys; any count is taken,
//   from the pairs' lists, when they do not fit), finds the rq-th smallest
//   by 8-bit radix digits and writes the rq keys in order. Keys are
//   unique, so the result is exact and deterministic; only the set of
//   survivors varies from run to run.
// - What still holds it back where the grouped route wins: a group's batch
//   select runs between its items, on its critical path, with 8 consumer
//   warps an SM against the grouped design's 16.
// - Block offsets are 64-bit: the tensor map's block coordinate is the
//   block id and every other offset is computed in 64 bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kCWarps = 4;                      // warps of a consumer group
constexpr int kGroups = 2;                      // consumer groups
constexpr int kConsumers = kGroups * kCWarps;   // consumer warps
constexpr int kThreads = (kConsumers + 1) * 32;  // and the producer warp
constexpr int kRows = 256;                      // block rows a stage
constexpr int kWRows = kRows / kCWarps;         // rows a consumer warp
constexpr int kT = 32;                          // pairs a work item
constexpr int kFlush = 8;  // a group's batch of pairs selected at this size
constexpr int kKC = 128;                        // row bytes a stage
constexpr int kStages = 4;                      // the ring
constexpr int kGroupThreads = 1024;             // the grouping kernel's CTA
constexpr int kGroupCtas = 64;                  // and its grid
// The select kernel: a warp a query gathering up to 512 candidates in
// shared memory when a query has at most that many slots (p * cap), else
// 256 threads a query and 4,096 candidates.
constexpr int kSelSmallCap = 512;
constexpr int kSelBigThreads = 256;
constexpr int kSelBigCap = 4096;
constexpr int kMaxR = 128;

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2 };

// The fused entry's arguments.
struct Args {
  const uint8_t* blocks;     // [B, S, row_bytes]
  const float* blocks_sq;    // [B, S]
  const int* block_ids;      // [B, S]
  const bool* allowed;       // [B, S] or null
  const uint8_t* q;          // [Q, row_bytes] in the rows' type
  const float* q_sq;         // [Q]
  const float* q_scale;      // [Q] (int8)
  const float* score_scale;  // [B] (int8)
  const int* gpair;          // [P] pairs (q * p + j) grouped by block
  const int4* items;         // work items (start, pairs, block, -)
  const int* gtab;           // per grouping CTA: items, then first pair
  u64* thresh;               // [Q] running r-th key bound
  int* count;                // [P] candidates of each pair
  u64* cand;                 // [P, cap] candidate keys of each pair
  int ngroups, p, S, row_bytes, l2, R, cap, tma;
};

// A stage: kRows block rows and kT query rows of kKC bytes (swizzled,
// swz), 1024-byte aligned for the TMA. Beside the stages, each stage's
// small part: the rows' ids, norms, filter bytes and the block's scale
// (filled on an item's last stage, which the epilogue reads), then the
// item's per-pair table (query, position base, q_sq, q_scale) and header.
constexpr int kQOff = kRows * kKC;
constexpr int kStageBytes = kQOff + kT * kKC;
constexpr int kInfoBytes = kRows * 9 + 16;
constexpr int kMetaOff = kInfoBytes;
constexpr int kSmallBytes = kMetaOff + kT * 16 + 16;
constexpr int kTilePad = 4;  // tile row stride S + 4: conflict-free stores

struct Layout {
  int small, tile, bars, tab, total;
};

// Shared memory after its 1024-byte alignment: the stages, their small
// parts, the consumer groups' tiles [kT][min(S, kRows) + kTilePad] (each
// pair's raw products, then its scores), the ring's barriers,
// the groups' batch tables, the item table.
__host__ __device__ inline Layout layout(int S) {
  Layout L;
  L.small = kStages * kStageBytes;
  L.tile = L.small + kStages * kSmallBytes;
  L.bars = L.tile + kGroups * kT * ((S < kRows ? S : kRows) + kTilePad) * 4;
  L.tab = L.bars + 2 * kStages * 8 + kGroups * 2 * kT * 4;
  L.total = L.tab + (2 * kGroupCtas + 1) * 4 + 1024;  // + alignment slack
  return L;
}

template <int MODE>
using acc_t = typename std::conditional<MODE == kI8, int, float>::type;

// A warp's accumulators: 64 rows x up to 32 queries as 4 x 4 m16n8
// fragments (mma modes), or two rows a lane x the item's queries (f32).
template <int MODE>
struct Acc {
  acc_t<MODE> v[kWRows / 16][kT / 8][4];
};
template <>
struct Acc<kF32> {
  float v[2][kT];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const uint32_t d = smem_u32(dst);
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// The arrive of this thread's earlier cp.async copies, when they land.
__device__ __forceinline__ void mbar_cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// Whether the phase of this parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// One tile of the 3-D tensor map (row bytes, row, block) into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k0, int r0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<u64>(map)), "r"(k0), "r"(r0), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kCWarps * 32) : "memory");
}

__device__ __forceinline__ u64 ld_cg(const u64* p) {
  u64 v;
  asm volatile("ld.global.cg.u64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}

// Byte k of staged row `row`: its 16-byte chunk XOR the row's low 3 bits,
// so the 8 rows an ldmatrix (or a phase of float4 loads) reads from one
// logical chunk sit in 8 different bank groups. On a 1024-byte aligned
// stage this is the TMA's 128-byte swizzle.
__device__ __forceinline__ int swz(int row, int k) {
  return row * kKC + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += A . B: A 16 rows x 32 bytes (row), B 32 bytes x 8 queries (col).
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Groups the P pairs by block (a counting sort) into gpair[P], equal block
// ids adjacent (ids outside [0, B) in one last group), in no order within
// a group, and cuts each group into work items of at most kT pairs. CTA c
// owns the buckets [c * per, (c + 1) * per) of the B + 1: it reads every id
// twice (from L2), counts those below its range for its first pair, places
// its own, and writes its items from items[first pair] on (a range holds
// no more items than pairs); gtab[c] is its item count and
// gtab[gridDim.x + c] its first pair. With gbid non-null it also writes
// each grouped pair's block id (-1 outside [0, B)), and with thresh
// non-null it resets the top-r entry's per-query threshold.
__global__ void __launch_bounds__(kGroupThreads)
group_kernel(const i64* __restrict__ bids, int P, int B,
             int* __restrict__ gpair, int4* __restrict__ items,
             int* __restrict__ gtab, int* __restrict__ gbid,
             u64* __restrict__ thresh, int Q) {
  extern __shared__ int cnt[];  // this CTA's buckets
  __shared__ u64 wsum[kGroupThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (thresh != nullptr)
    for (int i = blockIdx.x * kGroupThreads + tid; i < Q;
         i += gridDim.x * kGroupThreads)
      thresh[i] = ~0ull;
  const int nb = B + 1;
  const int per = (nb + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per, hi = min(lo + per, nb);
  for (int i = tid; i < per; i += kGroupThreads) cnt[i] = 0;
  __syncthreads();
  // a thread's ids are loaded 8 at a time, ahead of their atomics
  constexpr int kBatch = 8;
  auto bucket = [&](i64 b) {
    return b >= 0 && b < B ? static_cast<int>(b) : B;
  };
  int below = 0;
  for (int i0 = 0; i0 < P; i0 += kGroupThreads * kBatch) {
    int k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kGroupThreads + tid;
      k[u] = i < P ? bucket(bids[i]) : nb;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      below += k[u] < lo;
      if (k[u] >= lo && k[u] < hi) atomicAdd(&cnt[k[u] - lo], 1);
    }
  }
  // the ids below this range, over the CTA (every warp sums the totals)
  below = __reduce_add_sync(0xffffffffu, below);
  if (lane == 0) wsum[warp] = static_cast<u64>(below);
  __syncthreads();
  const int base = __reduce_add_sync(0xffffffffu,
                                     static_cast<unsigned>(wsum[lane]));
  __syncthreads();  // wsum is the scan's next
  // exclusive scan of the range's (pairs << 32 | items): each thread a
  // contiguous slice (both sums stay below 2^31)
  const int m = hi - lo;
  const int chunk = (m + kGroupThreads - 1) / kGroupThreads;
  const int c0 = min(tid * chunk, m), c1 = min(c0 + chunk, m);
  u64 sum = 0;
  for (int i = c0; i < c1; ++i)
    sum += (static_cast<u64>(cnt[i]) << 32) | ((cnt[i] + kT - 1) / kT);
  u64 x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    u64 w = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const u64 run = x - sum + (warp ? wsum[warp - 1] : 0);
  int pos = base + static_cast<int>(run >> 32);
  int item = base + static_cast<int>(run & 0xffffffffu);
  for (int i = c0; i < c1; ++i) {
    const int c = cnt[i];
    const int bid = lo + i == B ? -1 : lo + i;
    for (int s = 0; s < c; s += kT)
      items[item++] = make_int4(pos + s, min(kT, c - s), bid, 0);
    cnt[i] = pos;
    pos += c;
  }
  if (tid == kGroupThreads - 1) {
    gtab[blockIdx.x] = static_cast<int>(wsum[31] & 0xffffffffu);
    gtab[gridDim.x + blockIdx.x] = base;
  }
  __syncthreads();
  for (int i0 = 0; i0 < P; i0 += kGroupThreads * kBatch) {
    int k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kGroupThreads + tid;
      k[u] = i < P ? bucket(bids[i]) : nb;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k[u] < lo || k[u] >= hi) continue;
      const int at = atomicAdd(&cnt[k[u] - lo], 1);
      gpair[at] = i0 + u * kGroupThreads + tid;
      if (gbid != nullptr) gbid[at] = k[u] == B ? -1 : k[u];
    }
  }
}

// A score's ordered bits as unsigned: unsigned order is score order.
__device__ __forceinline__ uint32_t ordered(float sc) {
  int b = __float_as_int(sc == 0.0f ? 0.0f : sc);  // -0 -> +0
  b ^= (b >> 31) & 0x7fffffff;
  return static_cast<uint32_t>(b) ^ 0x80000000u;
}

// The grouped design, which serves the all-scores entry and the fused
// entry's grouped route. A CTA takes 32 consecutive grouped pairs; each
// run of equal block ids in its range streams that block once, in cp.async
// stages of 256 rows x 128 bytes (two in flight), with the same bytes of
// each query of the run and, on a run's last stage, the rows' ids, norms
// and filter bytes; 8 warps each hold 32 rows x up to 32 queries of
// accumulators. A run that crosses a CTA boundary is read by both CTAs.
// The top-r form keeps its 32 pairs' ordered scores in a [32][S] tile and,
// at the CTA's end, writes each pair's R smallest keys (a warp a pair, a
// bitwise search for the R-th); merge_kernel then takes each query's rq
// smallest of its p * R <= 1,024 keys. The all-scores mainloop on the ring
// below was slower at the stacked config D shape and at 53 sparse probes.
namespace grouped {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupRows = kWarps * 32;  // block rows scored per pass
constexpr int kT = 32;                   // grouped pairs per CTA
constexpr int kKC = 128;                 // row bytes a stage (swizzled)
constexpr int kStages = 2;               // stages in flight

struct Args {
  const uint8_t* blocks;     // [B, S, row_bytes]
  const float* blocks_sq;    // [B, S]
  const int* block_ids;      // [B, S]
  const bool* allowed;       // [B, S] or null
  const uint8_t* q;          // [Q, row_bytes] in the rows' type
  const float* q_sq;         // [Q]
  const float* q_scale;      // [Q] (int8)
  const float* score_scale;  // [B] (int8)
  const int* gbid;           // [P] block ids grouped (-1: outside [0, B))
  const int* gpair;          // [P] pair (q * p + j) of each grouped entry
  float* out;                // [P, S] (all scores)
  i64* keys;                 // [P, R] (top-r)
  i64 pairs;
  int p, S, row_bytes, l2, R;
};

// A stage: kGroupRows block rows and kT query rows of kKC bytes (swizzled,
// swz), then the rows' ids, norms and filter bytes and the block's
// scale (filled on a run's last stage, which the epilogue reads).
constexpr int kInfo = kGroupRows * (4 + 4 + 1) + 16;

// Shared memory: kStages stages, the per-pair tables, then the score tile
// (top-r).
struct Layout {
  int rows, stage, pair_tab, tile, total;
};

__host__ __device__ inline Layout layout(int S, bool topr) {
  Layout L;
  L.rows = (kGroupRows + kT) * kKC;
  L.stage = L.rows + kInfo;
  L.pair_tab = kStages * L.stage;
  // grouped bid, pair, q row, position base, run lo, run hi (int);
  // q_sq, q_scale (f32); the run count and the invalid pairs' mask
  L.tile = (L.pair_tab + kT * 8 * 4 + 16 + 15) / 16 * 16;
  L.total = L.tile + (topr ? kT * S * 4 : 0);
  return L;
}

// A warp's accumulators: 32 rows x up to 32 queries as 2 x 4 m16n8
// fragments (mma modes), or one row a lane x the run's queries (f32).
template <int MODE>
struct Acc {
  acc_t<MODE> v[2][kT / 8][4];
};
template <>
struct Acc<kF32> {
  float v[kT];
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The key of an ordered score at a position: (signed ordered bits << 32) |
// pos, so signed int64 order is (score, position).
__device__ __forceinline__ i64 key_of(uint32_t u, int pos) {
  return static_cast<i64>(
      (static_cast<unsigned long long>(u ^ 0x80000000u) << 32) |
      static_cast<uint32_t>(pos));
}

// Each query's r smallest of its C = p * R candidate keys (C <= kMergeC,
// r <= kMaxR), ascending, decoded to (score, position): a warp a query
// finds the r-th smallest key by a bitwise search, gathers the keys up to
// it and places each by its rank.
constexpr int kMergeC = 1024;

template <int kPer>  // candidates a lane: C <= 32 * kPer
__global__ void __launch_bounds__(kThreads)
merge_kernel(const i64* __restrict__ cand, int Q, int C, int r,
             float* __restrict__ out_score, i64* __restrict__ out_pos) {
  __shared__ i64 sel[kWarps][kMaxR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= Q) return;  // warp-uniform; no CTA barrier below
  constexpr unsigned long long kSign = 1ull << 63;
  unsigned long long v[kPer];  // unsigned order: sign bit flipped
  unsigned long long mn = ~0ull, mx = 0;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = lane + 32 * c;
    v[c] = j < C ? static_cast<unsigned long long>(
                       cand[static_cast<i64>(q) * C + j]) ^ kSign
                 : ~0ull;
    mn = min(mn, v[c]);
    if (j < C) mx = max(mx, v[c]);
  }
  // the answer lies in [min, max]: search below their common prefix
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const unsigned long long diff = mn ^ mx;
  const int top = diff ? 63 - __clzll(static_cast<long long>(diff)) : 0;
  unsigned long long th = mn & ~((2ull << top) - 1);  // 2 << 63 wraps to 0
  for (int bit = top; bit >= 0; --bit) {
    const unsigned long long c2 = th | (1ull << bit);
    int cnt = 0;
#pragma unroll
    for (int c = 0; c < kPer; ++c) cnt += v[c] < c2;
    if (__reduce_add_sync(0xffffffffu, cnt) < r) th = c2;
  }
  const unsigned lt_mask = (1u << lane) - 1;
  int put = 0;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const bool take = v[c] <= th;
    const unsigned mt = __ballot_sync(0xffffffffu, take);
    if (take) sel[warp][put + __popc(mt & lt_mask)] = v[c] ^ kSign;
    put += __popc(mt);
  }
  __syncwarp();
  for (int j = lane; j < r; j += 32) {
    const i64 k = sel[warp][j];
    int rank = 0;
    for (int t = 0; t < r; ++t) rank += sel[warp][t] < k;
    const int hi = static_cast<int>(k >> 32);
    const i64 o = static_cast<i64>(q) * r + rank;
    out_score[o] = __int_as_float(hi ^ ((hi >> 31) & 0x7fffffff));
    out_pos[o] = k & 0xffffffffLL;
  }
}

// Copies nbytes from src to dst (both aligned to the copy width) with the
// CTA's threads, VEC bytes a copy.
template <int VEC>
__device__ __forceinline__ void copy_bytes(char* dst, const void* src,
                                           int nbytes) {
  const uint8_t* s8 = static_cast<const uint8_t*>(src);
  for (int o = threadIdx.x * VEC; o < nbytes; o += kThreads * VEC)
    cp_async<VEC>(dst + o, s8 + o, VEC);
}

// One stage: rows [r0, r0 + nrows) of block b and the run's nq query rows,
// bytes [k0, k0 + kKC) of each. Bytes past the row end are zero-filled;
// rows and queries past the run are not loaded (their outputs are unused).
// On a run's last stage also the rows' ids, norms and filter bytes (16-byte
// copies when S % 16 == 0, else 4-byte copies when S % 4 == 0; otherwise
// the epilogue reads the filter from device memory) and the block's scale.
template <int VEC>
__device__ __forceinline__ void load_stage(const Args& a, char* buf, int b,
                                           int r0, int nrows,
                                           const int* qrow, int nq, int k0,
                                           int kbytes, bool info) {
  constexpr int kCPR = kKC / VEC;            // copies a row
  constexpr int kRowStep = kThreads / kCPR;  // rows a pass of the CTA
  // each thread copies one fixed chunk of every kRowStep-th row
  const int off = (threadIdx.x % kCPR) * VEC;
  const int row0 = threadIdx.x / kCPR;
  const bool ok = off < kbytes;
  const int nbytes = ok ? VEC : 0;
  const i64 stride = a.row_bytes;
  const uint8_t* src = a.blocks + (static_cast<i64>(b) * a.S + r0 + row0) *
                                      stride + (ok ? k0 + off : 0);
  // kRowStep is a multiple of 8, so a thread's rows share their swizzle
  char* dst = buf + swz(row0, off);
  for (int row = row0; row < nrows; row += kRowStep) {
    cp_async<VEC>(dst, src, nbytes);
    src += kRowStep * stride;
    dst += kRowStep * kKC;
  }
  dst = buf + swz(kGroupRows + row0, off);
  for (int t = row0; t < nq; t += kRowStep) {
    cp_async<VEC>(dst, a.q + static_cast<i64>(qrow[t]) * stride +
                           (ok ? k0 + off : 0), nbytes);
    dst += kRowStep * kKC;
  }
  if (!info) return;
  char* inf = buf + (kGroupRows + kT) * kKC;
  const i64 slot0 = static_cast<i64>(b) * a.S + r0;
  if (a.S % 16 == 0) {
    copy_bytes<16>(inf, a.block_ids + slot0, nrows * 4);
    copy_bytes<16>(inf + kGroupRows * 4, a.blocks_sq + slot0, nrows * 4);
    if (a.allowed != nullptr)
      copy_bytes<16>(inf + kGroupRows * 8, a.allowed + slot0, nrows);
  } else {
    copy_bytes<4>(inf, a.block_ids + slot0, nrows * 4);
    copy_bytes<4>(inf + kGroupRows * 4, a.blocks_sq + slot0, nrows * 4);
    if (a.allowed != nullptr && a.S % 4 == 0)
      copy_bytes<4>(inf + kGroupRows * 8, a.allowed + slot0, nrows);
  }
  if (a.score_scale != nullptr && threadIdx.x == 0)
    cp_async<4>(inf + kGroupRows * 9,
                reinterpret_cast<const uint8_t*>(a.score_scale + b), 4);
}
template <int MODE, int VEC, bool TOPR>
__global__ void __launch_bounds__(kThreads, 2)
grouped_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  constexpr int T = kT;
  const int S = a.S;
  const Layout L = layout(S, TOPR);
  int* s_bid = reinterpret_cast<int*>(smem + L.pair_tab);
  int* s_pair = s_bid + T;
  int* s_qrow = s_pair + T;
  int* s_pos0 = s_qrow + T;
  int* s_lo = s_pos0 + T;
  int* s_hi = s_lo + T;
  float* s_qsq = reinterpret_cast<float*>(s_hi + T);
  float* s_qscl = s_qsq + T;
  int* s_nrun = reinterpret_cast<int*>(s_qscl + T);  // runs, bad pairs
  uint32_t* s_u = reinterpret_cast<uint32_t*>(smem + L.tile);  // [T][S]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const i64 base = static_cast<i64>(blockIdx.x) * T;
  const int n = static_cast<int>(min(static_cast<i64>(T), a.pairs - base));

  for (int i = tid; i < n; i += kThreads) {
    const int pair = a.gpair[base + i];
    const int qi = pair / a.p;
    s_bid[i] = a.gbid[base + i];
    s_pair[i] = pair;
    s_qrow[i] = qi;
    s_pos0[i] = (pair - qi * a.p) * S;
    s_qsq[i] = a.q_sq[qi];
    if constexpr (MODE == kI8) s_qscl[i] = a.q_scale[qi];
  }
  __syncthreads();
  // runs of equal block ids (T = 32: one warp, one ballot); only runs of
  // valid blocks are scored
  if (warp == 0) {
    const bool st =
        lane < n && (lane == 0 || s_bid[lane] != s_bid[lane - 1]);
    const unsigned start = __ballot_sync(0xffffffffu, st);
    const unsigned ok = __ballot_sync(0xffffffffu, st && s_bid[lane] >= 0);
    if ((ok >> lane) & 1) {
      const unsigned later = start & ~((2u << lane) - 1);
      const int v = __popc(ok & ((1u << lane) - 1));
      s_lo[v] = lane;
      s_hi[v] = later ? __ffs(later) - 1 : n;
    }
    const unsigned bad =
        __ballot_sync(0xffffffffu, lane < n && s_bid[lane] < 0);
    if (lane == 0) {
      *s_nrun = __popc(ok);
      s_nrun[1] = bad;
    }
  }
  __syncthreads();
  // pairs of invalid blocks (rare) score +inf on every row
  for (unsigned bad = s_nrun[1]; bad; bad &= bad - 1) {
    const int i = __ffs(bad) - 1;
    for (int s = tid; s < S; s += kThreads) {
      if constexpr (TOPR)
        s_u[i * S + s] = ordered(INFINITY);
      else
        a.out[static_cast<i64>(s_pair[i]) * S + s] = INFINITY;
    }
  }
  __syncthreads();

  const int G = (S + kGroupRows - 1) / kGroupRows;
  const int NS = (a.row_bytes + kKC - 1) / kKC;
  const int per_run = G * NS;
  const int steps = *s_nrun * per_run;
  const bool allow_staged = a.S % 4 == 0;

  auto issue = [&](int s) {
    if (s < steps) {
      const int v = s / per_run, rem = s - v * per_run;
      const int g = rem / NS, sl = rem - g * NS;
      const int lo = s_lo[v];
      const int r0 = g * kGroupRows;
      load_stage<VEC>(a, smem + (s % kStages) * L.stage, s_bid[lo], r0,
                      min(kGroupRows, S - r0), s_qrow + lo, s_hi[v] - lo,
                      sl * kKC, min(kKC, a.row_bytes - sl * kKC),
                      sl == NS - 1);
    }
    cp_commit();  // empty groups at the end keep the wait count exact
  };

  Acc<MODE> acc;
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    const int v = s / per_run, rem = s - v * per_run;
    const int g = rem / NS, sl = rem - g * NS;
    const int lo = s_lo[v], nq = s_hi[v] - lo;
    const int b = s_bid[lo];
    const int r0 = g * kGroupRows, nrows = min(kGroupRows, S - r0);
    const int kbytes = min(kKC, a.row_bytes - sl * kKC);
    const int wrow = warp * 32;
    issue(s + kStages - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    const char* buf = smem + (s % kStages) * L.stage;
    if (sl == 0) {
      if constexpr (MODE == kF32) {
#pragma unroll
        for (int t = 0; t < kT; ++t) acc.v[t] = 0.0f;
      } else {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < kT / 8; ++nj)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc.v[mi][nj][c] = 0;
      }
    }
    if (wrow < nrows) {
      if constexpr (MODE == kF32) {
        const int xrow = wrow + lane;
        if constexpr (VEC == 16) {
          for (int k = 0; k < kbytes; k += 16) {
            const float4 x =
                *reinterpret_cast<const float4*>(buf + swz(xrow, k));
#pragma unroll
            for (int t = 0; t < kT; ++t) {
              if (t < nq) {
                const float4 y = *reinterpret_cast<const float4*>(
                    buf + swz(kGroupRows + t, k));
                float r = fmaf(x.x, y.x, acc.v[t]);
                r = fmaf(x.y, y.y, r);
                r = fmaf(x.z, y.z, r);
                acc.v[t] = fmaf(x.w, y.w, r);
              }
            }
          }
        } else {
          for (int k = 0; k < kbytes; k += 4) {
            const float x = *reinterpret_cast<const float*>(buf + swz(xrow, k));
#pragma unroll
            for (int t = 0; t < kT; ++t)
              if (t < nq)
                acc.v[t] = fmaf(x,
                                *reinterpret_cast<const float*>(
                                    buf + swz(kGroupRows + t, k)),
                                acc.v[t]);
          }
        }
      } else {
        const int nfr = (nq + 7) >> 3;
#pragma unroll
        for (int ks = 0; ks < kKC / 32; ++ks) {
          if (ks * 32 >= kbytes) break;
          uint32_t fa[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldsm_x4(fa[mi], buf + swz(wrow + mi * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8,
                                      ks * 32 + (lane >> 4) * 16));
#pragma unroll
          for (int nb = 0; nb < kT / 16; ++nb) {
            if (nb * 2 >= nfr) break;
            uint32_t fb[4];
            ldsm_x4(fb, buf + swz(kGroupRows + nb * 16 + (lane & 7) +
                                      (lane >> 4) * 8,
                                  ks * 32 + ((lane >> 3) & 1) * 16));
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma(acc.v[mi][2 * nb], fa[mi], fb[0], fb[1]);
              if (2 * nb + 1 < nfr)
                mma(acc.v[mi][2 * nb + 1], fa[mi], fb[2], fb[3]);
            }
          }
        }
      }
    }
    if (sl == NS - 1 && wrow < nrows) {
      // epilogue: op by op, as the plain version rounds
      const char* inf = buf + (kGroupRows + T) * kKC;
      const int* r_ids = reinterpret_cast<const int*>(inf);
      const float* r_sq = reinterpret_cast<const float*>(inf + kGroupRows * 4);
      const bool* r_ok = reinterpret_cast<const bool*>(inf + kGroupRows * 8);
      float bscl = 1.0f;
      if constexpr (MODE == kI8)
        bscl = *reinterpret_cast<const float*>(inf + kGroupRows * 9);
      // a row's score against query t of the run
      auto emit = [&](int row, bool dead, float xsq, int t,
                      acc_t<MODE> val) {
        const int i = lo + t;
        float dot;
        if constexpr (MODE == kI8)
          dot = __fmul_rn(__int2float_rn(val), __fmul_rn(s_qscl[i], bscl));
        else
          dot = val;
        float sc;
        if (dead) {
          sc = INFINITY;
        } else if (a.l2) {
          sc = fmaxf(__fsub_rn(__fadd_rn(s_qsq[i], xsq),
                               __fmul_rn(2.0f, dot)),
                     0.0f);
        } else {
          sc = -dot;
        }
        if constexpr (TOPR)
          s_u[i * S + r0 + row] = ordered(sc);
        else
          a.out[static_cast<i64>(s_pair[i]) * S + r0 + row] = sc;
      };
      auto row_dead = [&](int row) {
        bool dead = r_ids[row] < 0;
        if (a.allowed != nullptr)
          dead = dead || !(allow_staged
                               ? r_ok[row]
                               : a.allowed[static_cast<i64>(b) * S + r0 +
                                           row]);
        return dead;
      };
      if constexpr (MODE == kF32) {
        const int row = wrow + lane;
        if (row < nrows) {
          const bool dead = row_dead(row);
          const float xsq = r_sq[row];
#pragma unroll
          for (int t = 0; t < kT; ++t) {
            if (t >= nq) break;
            emit(row, dead, xsq, t, acc.v[t]);
          }
        }
      } else {
        // acc.v[mi][nj][c]: row wrow + mi*16 + g + 8*(c>>1), query
        // nj*8 + 2*tg + (c&1) of the run
        const int g8 = lane >> 2, tg = lane & 3;
        bool dead[4];
        float xsq[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int row = wrow + (m >> 1) * 16 + g8 + 8 * (m & 1);
          dead[m] = row >= nrows || row_dead(row);
          xsq[m] = row < nrows ? r_sq[row] : 0.0f;
        }
#pragma unroll
        for (int nj = 0; nj < kT / 8; ++nj) {
          if (nj * 8 >= nq) break;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int t = nj * 8 + 2 * tg + (c & 1);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const int m = mi * 2 + (c >> 1);
              const int row = wrow + mi * 16 + g8 + 8 * (c >> 1);
              if (t < nq && row < nrows)
                emit(row, dead[m], xsq[m], t, acc.v[mi][nj][c]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage's buffer is free for step s + kStages
  }
  if constexpr (TOPR) {
    // each pair's R smallest keys, a warp a pair: the R-th smallest
    // ordered score by a bitwise search (S <= 256: 8 a lane), then every
    // row below it and the first rows equal to it (the lowest positions)
    const int R = a.R;
    const unsigned lt_mask = (1u << lane) - 1;
    // two pairs a warp at once, so the two searches' reductions overlap
    for (int i0 = warp; i0 < n; i0 += 2 * kWarps) {
      const int np = i0 + kWarps < n ? 2 : 1;
      uint32_t u[2][8], th[2] = {0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int sr = lane + 32 * c;
          u[h][c] = h < np && sr < S ? s_u[(i0 + h * kWarps) * S + sr]
                                     : 0xffffffffu;
        }
      // the answer lies in [min, max]: start below their common prefix
      int top = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t mn = 0xffffffffu, mx = 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          mn = min(mn, u[h][c]);
          if (lane + 32 * c < S) mx = max(mx, u[h][c]);
        }
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        const uint32_t diff = mn ^ mx;
        if (h < np) top = max(top, diff ? 31 - __clz(diff) : 0);
        th[h] = mn;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) th[h] &= ~((2u << top) - 1u);
      for (int bit = top; bit >= 0; --bit) {
        int cnt[2] = {0, 0};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 8; ++c) cnt[h] += u[h][c] < (th[h] | (1u << bit));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (__reduce_add_sync(0xffffffffu, cnt[h]) < R) th[h] |= 1u << bit;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= np) break;
        const int i = i0 + h * kWarps;
        int less = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) less += u[h][c] < th[h];
        const int need = R - __reduce_add_sync(0xffffffffu, less);
        i64* o = a.keys + static_cast<i64>(s_pair[i]) * R;
        int put = 0, eqs = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const bool eq = u[h][c] == th[h];
          const unsigned meq = __ballot_sync(0xffffffffu, eq);
          const bool take =
              u[h][c] < th[h] || (eq && eqs + __popc(meq & lt_mask) < need);
          const unsigned mt = __ballot_sync(0xffffffffu, take);
          if (take)
            o[put + __popc(mt & lt_mask)] =
                key_of(u[h][c], s_pos0[i] + lane + 32 * c);
          put += __popc(mt);
          eqs += __popc(meq);
        }
      }
    }
  }
}

template <int MODE, int VEC, bool TOPR>
int launch(const Args& a, cudaStream_t st) {
  auto kern = grouped_kernel<MODE, VEC, TOPR>;
  const int bytes = layout(a.S, TOPR).total;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const i64 grid = (a.pairs + kT - 1) / kT;
  kern<<<static_cast<unsigned int>(grid), kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grouped

// The ring: stage s's full and empty barriers at full + 8 s and empty +
// 8 s. Consumer group g owns slots [g * kSlots, (g + 1) * kSlots) and
// takes its items' stages from them in order; a group busy with its select
// holds only its own slots.
constexpr int kSlots = kStages / kGroups;
struct Ring {
  uint32_t full, empty;
  // group grp's cnt-th stage: its slot, and the parity of that use
  __device__ __forceinline__ static int slot(int grp, int cnt) {
    return grp * kSlots + cnt % kSlots;
  }
  __device__ __forceinline__ static uint32_t parity(int cnt) {
    return (cnt / kSlots) & 1;
  }
};

// The item table of the persistent kernel: item g's slot in a.items.
struct ItemTable {
  const int* off;    // [kGroupCtas + 1] first item of each grouping CTA
  const int* first;  // [kGroupCtas] its first pair, where its items start
  __device__ __forceinline__ int slot(int g, int lane) const {
    const unsigned b0 = __ballot_sync(0xffffffffu, off[lane + 1] <= g);
    const unsigned b1 = __ballot_sync(0xffffffffu, off[lane + 33] <= g);
    const int c = __popc(b0) + __popc(b1);
    return first[c] + g - off[c];
  }
};

// The producer warp: two streams of this CTA's items, one a consumer
// group's (local items k with k % kGroups == g), each item's stages in
// order (128-byte slices of the rows) into the group's
// slots; it fills whichever group has a free slot, so a group busy with
// its select does not hold the other's loads back. Lane t carries pair t
// of the stream's current item.
template <int MODE, int VEC>
__device__ __forceinline__ void produce(const Args& a, const CUtensorMap* map,
                                        char* smem, char* small, Ring ring,
                                        ItemTable tab, int total, int NS) {
  const int lane = threadIdx.x & 31;
  const int S = a.S, nrows = S;
  const bool bulk_info = a.tma && S % 16 == 0;
  const int4 none = make_int4(0, 0, -1, 0);
  auto item = [&](int g) {
    return g < total ? a.items[tab.slot(g, lane)] : none;
  };
  auto pair_of = [&](int4 it) {
    return lane < it.y ? a.gpair[it.x + lane] : 0;
  };
  int g[kGroups], step[kGroups], cnt[kGroups], pair[kGroups];
  int4 it[kGroups], next[kGroups];
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    g[grp] = blockIdx.x + grp * gridDim.x;
    step[grp] = cnt[grp] = 0;
    it[grp] = item(g[grp]);
    next[grp] = item(g[grp] + kGroups * gridDim.x);
    pair[grp] = pair_of(it[grp]);
  }
  while (g[0] < total || g[1] < total) {
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp) {
      if (g[grp] >= total) continue;
      const int s = Ring::slot(grp, cnt[grp]);
      if (!__shfl_sync(0xffffffffu,
                       mbar_test(ring.empty + 8 * s,
                                 Ring::parity(cnt[grp]) ^ 1),
                       0))
        continue;  // the group still holds this slot
      const int nq = it[grp].y, b = it[grp].z;
      const int qi = pair[grp] / a.p;
      const uint8_t* qrow = a.q + static_cast<i64>(qi) * a.row_bytes;
      const int sl = step[grp];
      char* st = smem + s * kStageBytes;
      char* inf = small + s * kSmallBytes;
      const uint32_t fb = ring.full + 8 * s;
      int* m_q = reinterpret_cast<int*>(inf + kMetaOff);
      int* m_pos0 = m_q + kT;
      float* m_qsq = reinterpret_cast<float*>(m_pos0 + kT);
      float* m_qscl = m_qsq + kT;
      int* m_hdr = reinterpret_cast<int*>(m_qscl + kT);
      if (lane < nq) {
        m_q[lane] = qi;
        m_pos0[lane] = (pair[grp] - qi * a.p) * S;
        cp_async<4>(m_qsq + lane, a.q_sq + qi, 4);
        if constexpr (MODE == kI8)
          cp_async<4>(m_qscl + lane, a.q_scale + qi, 4);
      }
      if (lane == 0) {
        m_hdr[0] = nq;
        m_hdr[1] = b;
      }
      const int k0 = sl * kKC, kbytes = min(kKC, a.row_bytes - k0);
      const bool info = sl == NS - 1;
      const i64 slot0 = static_cast<i64>(b) * S;
      if (b >= 0) {
        // the query row of lane t, zero past the row end
        if (lane < nq)
          for (int o = 0; o < kKC; o += VEC)
            cp_async<VEC>(st + swz(kRows + lane, o),
                          qrow + (o < kbytes ? k0 + o : 0),
                          o < kbytes ? VEC : 0);
        if (!a.tma) {
          // the block rows by cp.async: each lane one fixed chunk of every
          // kRowStep-th row
          constexpr int kCPR = kKC / VEC, kRowStep = 32 / kCPR;
          const int off = (lane % kCPR) * VEC, row0 = lane / kCPR;
          const bool ok = off < kbytes;
          const uint8_t* src = a.blocks + (slot0 + row0) * a.row_bytes +
                               (ok ? k0 + off : 0);
          for (int row = row0; row < nrows; row += kRowStep) {
            cp_async<VEC>(st + swz(row, off), src, ok ? VEC : 0);
            src += kRowStep * static_cast<i64>(a.row_bytes);
          }
        }
        if (info) {
          if (!bulk_info) {
            for (int i = lane; i < nrows; i += 32) {
              cp_async<4>(inf + 4 * i, a.block_ids + slot0 + i, 4);
              cp_async<4>(inf + kRows * 4 + 4 * i, a.blocks_sq + slot0 + i,
                          4);
            }
            if (a.allowed != nullptr && S % 4 == 0)
              for (int i = 4 * lane; i < nrows; i += 128)
                cp_async<4>(inf + kRows * 8 + i, a.allowed + slot0 + i, 4);
          }
          if (a.score_scale != nullptr && lane == 0)
            cp_async<4>(inf + kRows * 9, a.score_scale + b, 4);
        }
      }
      __syncwarp();  // the table above is written before the arrive
      if (lane == 0) {
        if (b >= 0 && a.tma) {
          uint32_t bytes = kKC * min(S, kRows);
          const bool binf = info && bulk_info;
          if (binf) bytes += nrows * (8 + (a.allowed != nullptr));
          mbar_expect(fb, bytes);
          tma_load(smem_u32(st), map, fb, k0, 0, b);
          if (binf) {
            bulk_load(inf, a.block_ids + slot0, nrows * 4, fb);
            bulk_load(inf + kRows * 4, a.blocks_sq + slot0, nrows * 4, fb);
            if (a.allowed != nullptr)
              bulk_load(inf + kRows * 8, a.allowed + slot0, nrows, fb);
          }
        } else {
          mbar_arrive(fb);
        }
      }
      mbar_cp_async_arrive(fb);
      ++cnt[grp];
      if (++step[grp] == NS) {  // the stream's next item
        step[grp] = 0;
        g[grp] += kGroups * gridDim.x;
        it[grp] = next[grp];
        pair[grp] = pair_of(it[grp]);
        next[grp] = item(g[grp] + kGroups * gridDim.x);
      }
    }
  }
}

// The candidates of a consumer group's batch of n pairs, whose
// ordered scores are rows [0, n) of the group's tile (stride ts) and whose
// queries and position bases are bq[n], bpos0[n]. Warp wg of the group
// takes rows wg, wg + 4, ...; their queries' thresholds are read once, at
// the start. A pair keeps its keys at or below its query's threshold, in
// its list cand[pair * cap ...] (count[pair] of them, cap = min(2R, S)).
// When more than R lie there, it bounds them by a key E below which it
// holds between R and 2R keys, which also bounds the query's R-th key, and
// lowers the threshold to E (an atomicMin that returns nothing). E comes
// from a bitwise search over the ordered scores that stops at the first
// bit where the count lands in [R, 2R]: a few warp reductions, where the
// exact R-th key takes 32 (that search still runs, to the last bit and
// the tie order by position, when ties keep the count out of the range).
__device__ __forceinline__ void select_batch(const Args& a, const uint32_t* su,
                                             int ts, const int* bq,
                                             const int* bpos0, int n) {
  constexpr int C = kRows / 32;
  const int lane = threadIdx.x & 31, wg = (threadIdx.x >> 5) % kCWarps;
  const int S = a.S, R = a.R, cap = a.cap, nc = (S + 31) / 32;
  const unsigned lt_mask = (1u << lane) - 1;
  // lane l: the threshold of this warp's l-th pair (l < kT / kCWarps)
  const int jl = wg + kCWarps * lane;
  const u64 thl = lane < kT / kCWarps && jl < n ? ld_cg(a.thresh + bq[jl]) : 0;
  for (int jj = 0; wg + kCWarps * jj < n; ++jj) {
    const int j = wg + kCWarps * jj;
    const int q = bq[j], pos0 = bpos0[j];
    const u64 th0 = __shfl_sync(0xffffffffu, thl, jj);
    uint32_t u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int sr = lane + 32 * c;
      u[c] = sr < S ? su[j * ts + sr] : 0xffffffffu;
    }
    // at or below the key (kh, kl); rows past S never
    auto le = [&](int c, uint32_t kh, uint32_t kl) {
      const int sr = lane + 32 * c;
      return sr < S && (u[c] < kh || (u[c] == kh &&
                                      static_cast<uint32_t>(pos0 + sr) <= kl));
    };
    // rows for which pred(c) holds, over the warp
    auto count = [&](auto pred) {
      int k = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < nc) k += pred(c);
      return static_cast<int>(__reduce_add_sync(0xffffffffu, k));
    };
    uint32_t eh = static_cast<uint32_t>(th0 >> 32),
             el = static_cast<uint32_t>(th0);
    if (count([&](int c) { return le(c, eh, el); }) > R) {
      // the search runs below the common prefix of the least score and
      // the greatest at or below the threshold; count(u < th) < R holds
      uint32_t mn = 0xffffffffu, mx = 0u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        mn = min(mn, u[c]);
        if (le(c, eh, el)) mx = max(mx, u[c]);
      }
      mn = __reduce_min_sync(0xffffffffu, mn);
      mx = __reduce_max_sync(0xffffffffu, mx);
      const int top = mn ^ mx ? 31 - __clz(mn ^ mx) : 0;
      uint32_t th = mn & ~((2u << top) - 1u);
      u64 e = 0;
      bool found = false;
      for (int bit = top; bit >= 0; --bit) {
        const uint32_t c2 = th | (1u << bit);
        const int k = count([&](int c) { return u[c] < c2; });
        if (k < R) {
          th = c2;
        } else if (k <= cap) {  // every key scoring below c2: R to cap
          e = (static_cast<u64>(c2 - 1) << 32) | 0xffffffffull;
          found = true;
          break;
        }
      }
      if (!found) {
        // th is the R-th smallest score; the R-th key is the need-th row
        // scoring th, by position
        const int need = R - count([&](int c) { return u[c] < th; });
        uint32_t pos_r = 0;
        int eqs = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c >= nc) break;
          const bool eq = u[c] == th && lane + 32 * c < S;
          const unsigned meq = __ballot_sync(0xffffffffu, eq);
          const unsigned hit = __ballot_sync(
              0xffffffffu, eq && eqs + __popc(meq & lt_mask) == need - 1);
          if (hit) pos_r = pos0 + __ffs(hit) - 1 + 32 * c;
          eqs += __popc(meq);
        }
        e = (static_cast<u64>(th) << 32) | pos_r;
      }
      if (lane == 0) atomicMin(a.thresh + q, e);
      e = min(th0, e);
      eh = static_cast<uint32_t>(e >> 32);
      el = static_cast<uint32_t>(e);
    }
    const int pair = q * a.p + pos0 / S;
    u64* o = a.cand + static_cast<i64>(pair) * cap;
    int put = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c >= nc) break;
      const bool take = le(c, eh, el);
      const unsigned mt = __ballot_sync(0xffffffffu, take);
      if (take)
        o[put + __popc(mt & lt_mask)] =
            (static_cast<u64>(u[c]) << 32) |
            static_cast<uint32_t>(pos0 + lane + 32 * c);
      put += __popc(mt);
    }
    if (lane == 0) a.count[pair] = put;
  }
}

// A consumer group: its items' stages (128-byte slices of the rows) as
// the ring delivers them, the products, the epilogue, then, a batch at a
// time, each pair's candidates. The epilogue first stores each warp's raw
// products into the group's tile ([pair][row]), then scores them a lane a
// (pair, row), op by op as the plain version rounds, into ordered bits in
// place: an item of one or two pairs keeps every lane busy.
template <int MODE, int VEC>
__device__ __forceinline__ void consume(const Args& a, char* smem,
                                        char* small, uint32_t* tile,
                                        int* batch, Ring ring, int total,
                                        int NS) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / kCWarps, wg = warp % kCWarps;
  const int wrow = wg * kWRows;
  const int S = a.S;
  const bool allow_staged = S % 4 == 0;
  const int ts = min(S, kRows) + kTilePad;  // the tile's row stride
  uint32_t* su = tile + grp * kT * ts;
  // the group's batch of pairs awaiting their select: tile rows [0, fill),
  // their queries bq and position bases bpos0
  int* bq = batch + grp * 2 * kT;
  int* bpos0 = bq + kT;
  int fill = 0;
  int cnt = 0;  // the group's stages so far
  for (int g = blockIdx.x + grp * gridDim.x; g < total;
       g += kGroups * gridDim.x) {
    int nq = 0;
    Acc<MODE> acc;
    {
      const int nrows = S;
      for (int sl = 0; sl < NS; ++sl, ++cnt) {
        const int s = Ring::slot(grp, cnt);
        mbar_wait(ring.full + 8 * s, Ring::parity(cnt));
        const char* buf = smem + s * kStageBytes;
        const char* inf = small + s * kSmallBytes;
        const int* m_q = reinterpret_cast<const int*>(inf + kMetaOff);
        const int* m_pos0 = m_q + kT;
        const float* m_qsq = reinterpret_cast<const float*>(m_pos0 + kT);
        const float* m_qscl = m_qsq + kT;
        const int* m_hdr = reinterpret_cast<const int*>(m_qscl + kT);
        nq = m_hdr[0];
        const int b = m_hdr[1];
        const int kbytes = min(kKC, a.row_bytes - sl * kKC);
        if (sl == 0) {
          // no room for this item: select the batch first (no products are
          // live yet)
          if (fill + nq > kT) {
            group_sync(1 + grp);
            select_batch(a, su, ts, bq, bpos0, fill);
            group_sync(1 + grp);
            fill = 0;
          }
          if constexpr (MODE == kF32) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int t = 0; t < kT; ++t) acc.v[h][t] = 0.0f;
          } else {
#pragma unroll
            for (int mi = 0; mi < kWRows / 16; ++mi)
#pragma unroll
              for (int nj = 0; nj < kT / 8; ++nj)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc.v[mi][nj][c] = 0;
          }
        }
        if (b >= 0 && wrow < nrows) {
          if constexpr (MODE == kF32) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int xrow = wrow + 32 * h + lane;
              if constexpr (VEC == 16) {
                for (int k = 0; k < kbytes; k += 16) {
                  const float4 x =
                      *reinterpret_cast<const float4*>(buf + swz(xrow, k));
#pragma unroll
                  for (int t = 0; t < kT; ++t) {
                    if (t < nq) {
                      const float4 y = *reinterpret_cast<const float4*>(
                          buf + swz(kRows + t, k));
                      float r = fmaf(x.x, y.x, acc.v[h][t]);
                      r = fmaf(x.y, y.y, r);
                      r = fmaf(x.z, y.z, r);
                      acc.v[h][t] = fmaf(x.w, y.w, r);
                    }
                  }
                }
              } else {
                for (int k = 0; k < kbytes; k += 4) {
                  const float x =
                      *reinterpret_cast<const float*>(buf + swz(xrow, k));
#pragma unroll
                  for (int t = 0; t < kT; ++t)
                    if (t < nq)
                      acc.v[h][t] = fmaf(x,
                                         *reinterpret_cast<const float*>(
                                             buf + swz(kRows + t, k)),
                                         acc.v[h][t]);
                }
              }
            }
          } else {
            const int nfr = (nq + 7) >> 3;
#pragma unroll
            for (int ks = 0; ks < kKC / 32; ++ks) {
              if (ks * 32 >= kbytes) break;
              uint32_t fa[kWRows / 16][4];
#pragma unroll
              for (int mi = 0; mi < kWRows / 16; ++mi)
                ldsm_x4(fa[mi], buf + swz(wrow + mi * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          ks * 32 + (lane >> 4) * 16));
#pragma unroll
              for (int nb = 0; nb < kT / 16; ++nb) {
                if (nb * 2 >= nfr) break;
                uint32_t fb[4];
                ldsm_x4(fb, buf + swz(kRows + nb * 16 + (lane & 7) +
                                          (lane >> 4) * 8,
                                      ks * 32 + ((lane >> 3) & 1) * 16));
#pragma unroll
                for (int mi = 0; mi < kWRows / 16; ++mi) {
                  mma(acc.v[mi][2 * nb], fa[mi], fb[0], fb[1]);
                  if (2 * nb + 1 < nfr)
                    mma(acc.v[mi][2 * nb + 1], fa[mi], fb[2], fb[3]);
                }
              }
            }
          }
        }
        if (sl == NS - 1) {
          // this item's pairs are tile rows [fill, fill + nq)
          uint32_t* st = su + fill * ts;
          // the warp's raw products into the tile
          if (wrow < nrows) {
            if constexpr (MODE == kF32) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = wrow + 32 * h + lane;
#pragma unroll
                for (int t = 0; t < kT; ++t)
                  if (t < nq && row < nrows)
                    st[t * ts + row] = __float_as_uint(acc.v[h][t]);
              }
            } else {
              // acc.v[mi][nj][c]: row wrow + mi*16 + g8 + 8*(c>>1), pair
              // nj*8 + 2*tg + (c&1) of the item
              const int g8 = lane >> 2, tg = lane & 3;
#pragma unroll
              for (int nj = 0; nj < kT / 8; ++nj) {
                if (nj * 8 >= nq) break;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int t = nj * 8 + 2 * tg + (c & 1);
#pragma unroll
                  for (int mi = 0; mi < kWRows / 16; ++mi) {
                    const int row = wrow + mi * 16 + g8 + 8 * (c >> 1);
                    if (t < nq && row < nrows) {
                      if constexpr (MODE == kI8)
                        st[t * ts + row] =
                            static_cast<uint32_t>(acc.v[mi][nj][c]);
                      else
                        st[t * ts + row] = __float_as_uint(acc.v[mi][nj][c]);
                    }
                  }
                }
              }
            }
          }
          __syncwarp();
          // then each (pair, row) of the warp's rows, a lane each
          const int* r_ids = reinterpret_cast<const int*>(inf);
          const float* r_sq = reinterpret_cast<const float*>(inf + kRows * 4);
          const bool* r_ok = reinterpret_cast<const bool*>(inf + kRows * 8);
          float bscl = 1.0f;
          if constexpr (MODE == kI8)
            if (b >= 0)
              bscl = *reinterpret_cast<const float*>(inf + kRows * 9);
          const int nr = min(kWRows, nrows - wrow);
          for (int e = lane; e < nq * kWRows; e += 32) {
            const int t = e / kWRows, row = wrow + e % kWRows;
            if (e % kWRows >= nr) continue;
            bool dead = b < 0;
            if (!dead) {
              dead = r_ids[row] < 0;
              if (a.allowed != nullptr)
                dead = dead || !(allow_staged
                                     ? r_ok[row]
                                     : a.allowed[static_cast<i64>(b) * S +
                                                 row]);
            }
            const uint32_t raw = st[t * ts + row];
            float dot;
            if constexpr (MODE == kI8)
              dot = __fmul_rn(__int2float_rn(static_cast<int>(raw)),
                              __fmul_rn(m_qscl[t], bscl));
            else
              dot = __uint_as_float(raw);
            float sc;
            if (dead) {
              sc = INFINITY;
            } else if (a.l2) {
              sc = fmaxf(__fsub_rn(__fadd_rn(m_qsq[t], r_sq[row]),
                                   __fmul_rn(2.0f, dot)),
                         0.0f);
            } else {
              sc = -dot;
            }
            st[t * ts + row] = ordered(sc);
          }
        }
        if (sl == NS - 1) {
          if (wg == 0 && lane < nq) {
            bq[fill + lane] = m_q[lane];
            bpos0[fill + lane] = m_pos0[lane];
          }
          fill += nq;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty + 8 * s);  // the slot is free
      }
    }
    // a batch past kFlush pairs is selected once its last item's slot is
    // free, so the ring keeps loading
    if (fill >= kFlush) {
      group_sync(1 + grp);
      select_batch(a, su, ts, bq, bpos0, fill);
      group_sync(1 + grp);
      fill = 0;
    }
  }
  if (fill > 0) {
    group_sync(1 + grp);
    select_batch(a, su, ts, bq, bpos0, fill);
  }
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
stage_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(a.S);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const Ring ring{full0, full0 + 8 * kStages};
  int* s_off = reinterpret_cast<int*>(smem + L.tab);  // [kGroupCtas + 1]
  int* s_first = s_off + kGroupCtas + 1;              // [kGroupCtas]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 33);  // producer lane 0 + 32 cp.async
      mbar_init(ring.empty + 8 * s, kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 0) {
    // each grouping CTA's first item: a scan of their item counts
    const int n0 = lane < a.ngroups ? a.gtab[lane] : 0;
    const int n1 = lane + 32 < a.ngroups ? a.gtab[lane + 32] : 0;
    int x0 = n0, x1 = n1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y0 = __shfl_up_sync(0xffffffffu, x0, o);
      const int y1 = __shfl_up_sync(0xffffffffu, x1, o);
      if (lane >= o) {
        x0 += y0;
        x1 += y1;
      }
    }
    const int t0 = __shfl_sync(0xffffffffu, x0, 31);
    s_off[lane + 1] = x0;
    s_off[lane + 33] = t0 + x1;
    if (lane == 0) s_off[0] = 0;
    s_first[lane] = lane < a.ngroups ? a.gtab[a.ngroups + lane] : 0;
    s_first[lane + 32] = lane + 32 < a.ngroups ? a.gtab[a.ngroups + lane + 32]
                                               : 0;
  }
  __syncthreads();
  const int total = s_off[kGroupCtas];
  const int NS = (a.row_bytes + kKC - 1) / kKC;
  if (warp == kConsumers)
    produce<MODE, VEC>(a, &map, smem, smem + L.small, ring,
                       ItemTable{s_off, s_first}, total, NS);
  else
    consume<MODE, VEC>(a, smem, smem + L.small,
                       reinterpret_cast<uint32_t*>(smem + L.tile),
                       reinterpret_cast<int*>(smem + L.bars + 16 * kStages),
                       ring, total, NS);
}

// An inclusive scan of v over the CTA (wtot: a word a warp). Ends in a
// CTA barrier.
__device__ __forceinline__ int cta_scan(int v, int* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wtot[w];
  __syncthreads();
  return v;
}

// Each query's rq smallest candidate keys, ascending, decoded to (score,
// position): a CTA of TH threads a query gathers its pairs' lists
// (count[pair] keys at cand[pair * cap]) up to its final threshold (n >= rq
// keys) into shared memory when they fit in CAP (else it reads them from
// the lists on every pass),
// finds the rq-th smallest by 8-bit radix digits (a 256-bin count each,
// from the highest digit where the keys differ), keeps the keys up to it
// and places each by its rank.
template <int TH, int CAP>
__global__ void __launch_bounds__(TH)
select_kernel(const u64* __restrict__ cand, const int* __restrict__ count,
              const u64* __restrict__ thresh, int p, int cap, int rq,
              float* __restrict__ out_score, i64* __restrict__ out_pos) {
  constexpr int kBins = 256 / TH;  // histogram bins a thread scans
  __shared__ u64 keys[CAP];
  __shared__ int hist[256];
  __shared__ int pre[TH];
  __shared__ u64 sel[kMaxR];
  __shared__ u64 red[2][TH / 32];
  __shared__ int wtot[TH / 32];
  __shared__ int found[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 q = blockIdx.x;
  const u64* kq = cand + q * p * cap;
  const int* cq = count + q * p;
  // the query's final threshold bounds its answer: candidates above it,
  // kept while it was higher, are dropped as they are gathered
  const u64 tq = thresh[q];
  const unsigned lt_mask = (1u << lane) - 1;
  if (tid == 0) found[0] = 0;
  for (int j0 = 0; j0 < p; j0 += TH) {
    const int nj = j0 + tid < p ? cq[j0 + tid] : 0;
    pre[tid] = cta_scan(nj, wtot);  // each pair's end offset in the chunk
    __syncthreads();
    const int m = pre[TH - 1];
    // candidate i of the chunk: the pair whose end offset first passes i
    for (int i0 = 0; i0 < m; i0 += TH) {
      const int i = i0 + tid;
      u64 key = ~0ull;
      if (i < m) {
        int jj = 0;
#pragma unroll
        for (int step = TH / 2; step > 0; step >>= 1)
          if (pre[jj + step - 1] <= i) jj += step;
        key = kq[static_cast<i64>(j0 + jj) * cap + i - (jj ? pre[jj - 1] : 0)];
      }
      const bool keep = i < m && key <= tq;
      const unsigned mk = __ballot_sync(0xffffffffu, keep);
      int at = 0;
      if (lane == 0 && mk) at = atomicAdd(&found[0], __popc(mk));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(mk & lt_mask);
      if (keep && at < CAP) keys[at] = key;
    }
    __syncthreads();  // pre is read: the next chunk may write it
  }
  const int n = found[0];
  __syncthreads();  // n is read: found is written again below
  // fn(key, valid) for every candidate, called by all threads together
  const bool held = n <= CAP;
  auto each = [&](auto fn) {
    if (held) {
      for (int i0 = 0; i0 < n; i0 += TH) {
        const int i = i0 + tid;
        fn(i < n ? keys[i] : ~0ull, i < n);
      }
    } else {
      for (int j = 0; j < p; ++j) {
        const int c = cq[j];
        for (int o0 = 0; o0 < c; o0 += TH) {
          const int o = o0 + tid;
          const u64 key = o < c ? kq[static_cast<i64>(j) * cap + o] : ~0ull;
          fn(key, o < c && key <= tq);
        }
      }
    }
  };
  u64 up = ~0ull;  // keys at or below it are the answer
  if (n > rq) {
    u64 lo = ~0ull, hi = 0;
    each([&](u64 k, bool ok) {
      if (ok) {
        lo = min(lo, k);
        hi = max(hi, k);
      }
    });
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      red[0][warp] = lo;
      red[1][warp] = hi;
    }
    __syncthreads();
    for (int w = 0; w < TH / 32; ++w) {
      lo = min(lo, red[0][w]);
      hi = max(hi, red[1][w]);
    }
    int d = (63 - __clzll(static_cast<i64>(lo ^ hi))) / 8;
    u64 fixed = d == 7 ? 0ull : ~0ull << (8 * (d + 1));
    u64 prefix = lo & fixed;
    int k = rq;
    for (;; --d) {
      const int sh = 8 * d;
      for (int i = tid; i < 256; i += TH) hist[i] = 0;
      __syncthreads();
      each([&](u64 key, bool ok) {
        if (ok && (key & fixed) == prefix)
          atomicAdd(&hist[static_cast<int>((key >> sh) & 255)], 1);
      });
      __syncthreads();
      int h[kBins], sum = 0;
#pragma unroll
      for (int e = 0; e < kBins; ++e) {
        h[e] = hist[kBins * tid + e];
        sum += h[e];
      }
      int run = cta_scan(sum, wtot) - sum;  // the keys in lower bins
#pragma unroll
      for (int e = 0; e < kBins; ++e) {
        if (run < k && k <= run + h[e]) {
          found[0] = kBins * tid + e;
          found[1] = run;
          found[2] = h[e];
        }
        run += h[e];
      }
      __syncthreads();
      const int bin = found[0], before = found[1], in_bin = found[2];
      __syncthreads();  // found and hist are read: the next digit may reset
      prefix |= static_cast<u64>(bin) << sh;
      fixed |= 255ull << sh;
      if (before + in_bin == k) {  // always so at the last digit
        up = prefix | ~fixed;
        break;
      }
      k -= before;
    }
  }
  if (tid == 0) found[0] = 0;
  __syncthreads();
  each([&](u64 key, bool ok) {
    if (ok && key <= up) sel[atomicAdd(&found[0], 1)] = key;
  });
  __syncthreads();
  for (int j = tid; j < rq; j += TH) {
    const u64 key = sel[j];
    int rank = 0;
    for (int t = 0; t < rq; ++t) rank += sel[t] < key;
    const int hb = static_cast<int>(static_cast<uint32_t>(key >> 32) ^
                                    0x80000000u);
    const i64 o = q * rq + rank;
    out_score[o] = __int_as_float(hb ^ ((hb >> 31) & 0x7fffffff));
    out_pos[o] = static_cast<i64>(key & 0xffffffffull);
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error codes of this file beyond cudaError_t's.
constexpr int kErrNoEncode = 10001;  // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10002;    // it refused the map

// The tensor map of the rows: dims (row bytes, S, B), box (128, min(S,
// 256), 1), 128-byte swizzle, zeros past each row's end and block's rows.
// The last few maps are kept: a serving loop reuses one table.
int row_map(CUtensorMap* map, const void* blocks, i64 B, int S,
            int row_bytes) {
  struct Entry {
    const void* ptr;
    i64 B;
    int S, row_bytes;
    CUtensorMap map;
  };
  constexpr int kCache = 8;
  static Entry cache[kCache];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].ptr == blocks && cache[i].B == B && cache[i].S == S &&
        cache[i].row_bytes == row_bytes) {
      *map = cache[i].map;
      return 0;
    }
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr)
      return kErrNoEncode;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(S) * row_bytes};
  const cuuint32_t box[3] = {kKC, static_cast<cuuint32_t>(min(S, kRows)), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(blocks), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode;
  cache[next] = Entry{blocks, B, S, row_bytes, *map};
  next = (next + 1) % kCache;
  used = min(used + 1, kCache);
  return 0;
}

// The current device's SM count, and whether each kernel has had its
// shared-memory limit raised there (once a device).
int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

int sm_count(int dev) {
  static int n[64] = {};
  if (dev < 0 || dev >= 64) return 132;
  if (n[dev] == 0)
    cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

template <int MODE, int VEC>
int launch(const Args& a, const CUtensorMap& map, cudaStream_t st) {
  auto kern = stage_kernel<MODE, VEC>;
  const int dev = device_index();
  static unsigned long long raised = 0;  // a bit a device
  const int most = layout(kRows).total;
  if (dev < 0 || dev >= 64 || !((raised >> dev) & 1)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 0 && dev < 64) raised |= 1ull << dev;
  }
  kern<<<sm_count(dev), kThreads, layout(a.S).total, st>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

// The grouping kernel's launch: pairs grouped by block (gbid, when
// non-null, their block ids), work items and the table; with thresh
// non-null, the thresholds reset. Returns its CTA count, or minus a
// cudaError_t.
int group(const i64* bids, i64 pairs, i64 n_blocks, int p, int* gpair,
          int4* items, int* gtab, int* gbid, u64* thresh, cudaStream_t st) {
  const int nb = static_cast<int>(n_blocks) + 1;
  const int ctas = min(kGroupCtas, nb);
  const int per = (nb + ctas - 1) / ctas;
  cudaError_t e = cudaSuccess;
  if (per * 4 > 48 * 1024)
    e = cudaFuncSetAttribute(group_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             per * 4);
  if (e != cudaSuccess) return -static_cast<int>(e);
  group_kernel<<<ctas, kGroupThreads, per * 4, st>>>(
      bids, static_cast<int>(pairs), static_cast<int>(n_blocks), gpair,
      items, gtab, gbid, thresh, static_cast<int>(pairs / p));
  e = cudaGetLastError();
  return e == cudaSuccess ? ctas : -static_cast<int>(e);
}

bool bad_shape(int vec, int row_bytes, i64 n_blocks, i64 pairs) {
  return row_bytes <= 0 || row_bytes % vec || n_blocks >= 0x7fffffffLL ||
         pairs >= 0x7fffffffLL;
}

template <int VEC>
int launch_mode(int mode, const Args& a, const CUtensorMap& map,
                cudaStream_t st) {
  if (mode == kF32) return launch<kF32, VEC>(a, map, st);
  if (mode == kBF16) return launch<kBF16, VEC>(a, map, st);
  if (mode == kI8) return launch<kI8, VEC>(a, map, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int VEC, bool TOPR>
int launch_grouped(int mode, const grouped::Args& a, cudaStream_t st) {
  if (mode == kF32) return grouped::launch<kF32, VEC, TOPR>(a, st);
  if (mode == kBF16) return grouped::launch<kBF16, VEC, TOPR>(a, st);
  if (mode == kI8) return grouped::launch<kI8, VEC, TOPR>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

grouped::Args grouped_args(const void* blocks, const float* blocks_sq,
                           const int* block_ids, const bool* allowed,
                           const void* q, const float* q_sq,
                           const float* q_scale, const float* score_scale,
                           const int* gbid, const int* gpair, i64 pairs, int p,
                           int S, int row_bytes, int l2) {
  grouped::Args a{};
  a.blocks = static_cast<const uint8_t*>(blocks);
  a.blocks_sq = blocks_sq;
  a.block_ids = block_ids;
  a.allowed = allowed;
  a.q = static_cast<const uint8_t*>(q);
  a.q_sq = q_sq;
  a.q_scale = q_scale;
  a.score_scale = score_scale;
  a.gbid = gbid;
  a.gpair = gpair;
  a.pairs = pairs;
  a.p = p;
  a.S = S;
  a.row_bytes = row_bytes;
  a.l2 = l2;
  return a;
}

}  // namespace

// mode: 0 f32, 1 bf16, 2 int8. vec: 16 (16-byte copies; rows 16-byte
// multiples, blocks and q 16-byte aligned) or 4. allowed: [B, S] bool
// filter mask, or null. bids: [Q, p] int64 block ids. Scratch: gpair and
// gbid [Q * p] int32, items [Q * p] int4 (16-byte aligned), gtab [128]
// int32. out: [Q, p, S] f32. Returns a cudaError_t.
extern "C" int expand_score_launch(
    int mode, int vec, const void* blocks, const float* blocks_sq,
    const int* block_ids, const bool* allowed, const void* q,
    const float* q_sq, const float* q_scale, const float* score_scale,
    const long long* bids, int* gpair, void* items, int* gtab, int* gbid,
    float* out, long long n_blocks, long long pairs, int p, int S,
    int row_bytes, int l2, void* stream) {
  if (pairs == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(vec, row_bytes, n_blocks, pairs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group(bids, pairs, n_blocks, p, gpair,
                      static_cast<int4*>(items), gtab, gbid, nullptr, st);
  if (g < 0) return -g;
  grouped::Args a = grouped_args(blocks, blocks_sq, block_ids, allowed, q,
                                 q_sq, q_scale, score_scale, gbid, gpair,
                                 pairs, p, S, row_bytes, l2);
  a.out = out;
  if (vec == 16) return launch_grouped<16, false>(mode, a, st);
  if (vec == 4) return launch_grouped<4, false>(mode, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused top-r's grouped route (p * R <= 1,024): each pair's R = min(r,
// S) smallest keys into keys [Q, p, R] int64, then each query's rq smallest
// of its p * R, ascending, as [Q, rq] f32 scores and int64 positions (rq <=
// min(128, p * R); S <= 256). Arguments and scratch as
// expand_score_launch's, keys in place of out. Returns a cudaError_t.
extern "C" int expand_topr_grouped_launch(
    int mode, int vec, const void* blocks, const float* blocks_sq,
    const int* block_ids, const bool* allowed, const void* q,
    const float* q_sq, const float* q_scale, const float* score_scale,
    const long long* bids, int* gpair, void* items, int* gtab, int* gbid,
    long long* keys, long long n_blocks, long long pairs, int p, int S,
    int row_bytes, int l2, int R, float* top_score, long long* top_pos,
    int rq, void* stream) {
  if (pairs == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const int C = p * R;
  if (bad_shape(vec, row_bytes, n_blocks, pairs) || S > kRows || R < 1 ||
      R > S || C > grouped::kMergeC || rq < 1 || rq > kMaxR || rq > C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group(bids, pairs, n_blocks, p, gpair,
                      static_cast<int4*>(items), gtab, gbid, nullptr, st);
  if (g < 0) return -g;
  grouped::Args a = grouped_args(blocks, blocks_sq, block_ids, allowed, q,
                                 q_sq, q_scale, score_scale, gbid, gpair,
                                 pairs, p, S, row_bytes, l2);
  a.keys = keys;
  a.R = R;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (vec == 16) err = launch_grouped<16, true>(mode, a, st);
  if (vec == 4) err = launch_grouped<4, true>(mode, a, st);
  if (err != 0) return err;
  const i64 Q = pairs / p;
  const auto grid =
      static_cast<unsigned int>((Q + grouped::kWarps - 1) / grouped::kWarps);
  if (C <= grouped::kMergeC / 2)
    grouped::merge_kernel<grouped::kMergeC / 64>
        <<<grid, grouped::kThreads, 0, st>>>(
            keys, static_cast<int>(Q), C, rq, top_score, top_pos);
  else
    grouped::merge_kernel<grouped::kMergeC / 32>
        <<<grid, grouped::kThreads, 0, st>>>(
            keys, static_cast<int>(Q), C, rq, top_score, top_pos);
  return static_cast<int>(cudaGetLastError());
}

// The fused top-r: each query's rq smallest keys, ascending, as [Q, rq] f32
// scores and int64 positions (rq <= min(128, p * R); R = min(r, S); S <=
// 256). Arguments and scratch as expand_score_launch's without gbid and
// out, and thresh [Q] uint64, count [Q * p] int32, cand [Q * p, cap]
// uint64 with cap = min(2R, S). Returns a cudaError_t, or 10001 (the
// driver has no cuTensorMapEncodeTiled) or 10002 (it refused the rows'
// tensor map).
extern "C" int expand_topr_launch(
    int mode, int vec, const void* blocks, const float* blocks_sq,
    const int* block_ids, const bool* allowed, const void* q,
    const float* q_sq, const float* q_scale, const float* score_scale,
    const long long* bids, int* gpair, void* items, int* gtab,
    unsigned long long* thresh, int* count, unsigned long long* cand,
    long long n_blocks, long long pairs, int p, int S, int row_bytes, int l2,
    int R, float* top_score, long long* top_pos, int rq, void* stream) {
  if (pairs == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(vec, row_bytes, n_blocks, pairs) || S > kRows || R < 1 ||
      R > S || rq < 1 || rq > kMaxR || rq > static_cast<i64>(p) * R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group(bids, pairs, n_blocks, p, gpair,
                      static_cast<int4*>(items), gtab, nullptr, thresh, st);
  if (g < 0) return -g;
  Args a{};
  a.blocks = static_cast<const uint8_t*>(blocks);
  a.blocks_sq = blocks_sq;
  a.block_ids = block_ids;
  a.allowed = allowed;
  a.q = static_cast<const uint8_t*>(q);
  a.q_sq = q_sq;
  a.q_scale = q_scale;
  a.score_scale = score_scale;
  a.gpair = gpair;
  a.items = static_cast<const int4*>(items);
  a.gtab = gtab;
  a.thresh = thresh;
  a.count = count;
  a.cand = cand;
  a.ngroups = g;
  a.p = p;
  a.S = S;
  a.row_bytes = row_bytes;
  a.l2 = l2;
  a.R = R;
  a.cap = min(2 * R, S);
  a.tma = vec == 16;
  CUtensorMap map = {};
  if (a.tma) {
    const int err = row_map(&map, blocks, n_blocks, S, row_bytes);
    if (err != 0) return err;
  }
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (vec == 16) err = launch_mode<16>(mode, a, map, st);
  if (vec == 4) err = launch_mode<4>(mode, a, map, st);
  if (err != 0) return err;
  const i64 Q = pairs / p;
  if (static_cast<i64>(p) * a.cap <= kSelSmallCap)
    select_kernel<32, kSelSmallCap>
        <<<static_cast<unsigned int>(Q), 32, 0, st>>>(
            cand, count, thresh, p, a.cap, rq, top_score, top_pos);
  else
    select_kernel<kSelBigThreads, kSelBigCap>
        <<<static_cast<unsigned int>(Q), kSelBigThreads, 0, st>>>(
            cand, count, thresh, p, a.cap, rq, top_score, top_pos);
  return static_cast<int>(cudaGetLastError());
}
