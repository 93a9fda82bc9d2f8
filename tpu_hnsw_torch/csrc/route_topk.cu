// Query-centroid routing for Hopper (sm_90a): f32 scores with each row's
// exact top-p fused, so the score matrix never reaches device memory.
//
// Replaces no Pallas kernel. It serves two routes that the reference runs
// as an XLA dot and top_k, which the port served as a cuBLAS f32 GEMM
// writing a score matrix, elementwise passes over it and torch.topk's
// radix select reading it again:
// - the block engine's route (tpu_hnsw/index/block.py::_route_exact_body,
//   block.py:287-306; the stacked searcher of tpu_hnsw/parallel/
//   partition.py routes the same way over its stacked centroids): p ids of
//   each [Q, L * b] row, p 8 in the cells;
// - the graph engine's dense route over its level >= 1 elements
//   (tpu_hnsw/index/search.py::_scan_seeds_body, search.py:405-442; the
//   port's index/search.py::_scan_seeds_body passes the gathered upper
//   vectors as one group with its live count): one seed of each [Q, U] row
//   at descent_ef 1, U ~62,400 at SIFT-1M, a 1.02 GB score matrix before.
//
// What it computes: for query q, group l (L groups of b centroids: L = 1
// for BlockHnswIndex and the graph route, the P / R stacked partitions for
// ShardedBlockSearcher) and centroid n < live[l],
//   L2:      (q_sq[q] + c_sq[l, n]) - 2 * dot
//   IP/cos:  -dot
// with dot the f32 query . f32 centroid, f32 FMAs on the CUDA cores in k
// order (no TF32): only the summation order differs from a library GEMM
// (at p 1 the L2 sum starts at -c_sq / 2 and the score is q_sq - 2 * sum).
// Each (q, l) row keeps its p smallest keys (ordered score bits << 32 | n),
// ascending, so ties go to the lower index and -0 counts as +0; ids out
// [Q, L, p] int64 are n + l * off, and -1 past the row's live centroids.
//
// What bounds it: operations. 2 * Q * L * b * d f32 FLOPs (32.3 GFLOP at
// the stacked DEEP-10M shape, 0.48 ms at 67 TFLOP/s; 65.4 GFLOP at the
// graph route's 4,096 x 62,400 x 128, 0.98 ms) against the queries and
// centroids read once (tens of MB): two orders above the card's f32
// operations-per-byte line once the score matrix (672 MB; 1.02 GB) is gone.
//
// Design (route_topk_tile): a CTA of 8 warps scores a tile of 128 queries
// against one range of one group's centroids, 128 at a time; two CTAs an
// SM (registers; shared memory too above p of about 30).
// - Operands stream through a 2-stage cp.async ring of 32-wide k chunks of
//   both the query tile and the centroid tile (rows padded to 36 floats, so
//   the float4 reads below are free of bank conflicts); a chunk's 4,096
//   FMAs a lane hide the next chunk's load. Rows past Q or the range, and
//   columns past d, arrive as zeros.
// - Register tiles: a lane holds 8 queries x 8 centroids of f32 sums; a
//   half-warp owns 8 query rows of the tile (rows 2i + h of its warp's 16)
//   and all 128 centroids of each, so a row's selection stays inside one
//   half-warp.
// - Epilogue, p >= 2: each row keeps its running top-p, sorted, in shared
//   memory; its last entry is the threshold. An unrolled pass flags the
//   rows whose lane minimum may beat it (the flagged share falls as ~p /
//   tiles seen); for each flagged row the half-warp computes its keys and
//   keeps those below the threshold in the row's slots (up to 24, by an
//   atomic count). A row that kept keys is merged into its list (each key
//   placed by its rank: a binary search in the list and a count over the
//   slots) at the end of the tile, so the next tile meets the newest
//   threshold (merging only when the slots were half full flagged more
//   rows under a staler threshold: 1% slower at the stacked DEEP-10M shape,
//   3.5% at SIFT-1M's, p 8, H100). A range's first tile bounds the
//   threshold at once for p <= 16 (the p-th smallest of the 16 lanes'
//   minima), so about p keys take slots, not 128.
// - Epilogue, p == 1 (route_topk_tile<VEC, true>, chosen by p): no lists,
//   slots, atomics or merges, one key a row (top1_flags, top1_keep). The
//   L2 sums start at -c_sq / 2 (the tile's norms come with its first
//   chunk), so a row's best score here is that of its largest sum: the flag
//   pass is 8 fmaxf, one fma and one compare a row, against ~3 operations
//   a score when each is formed; only flagged rows form scores, and a
//   half-warp's shuffles take its smallest key. At the graph route's shape
//   on an H100: 1.987 ms (49.1% of the bound; the survivor epilogue took
//   2.032 there, the GEMM + top-k chain 8.01). With its epilogue stubbed
//   out the kernel takes 1.777. Slower designs measured there: each lane's
//   running best of each row in shared memory or registers, every score
//   formed and compared (2.10-2.23, spilling at the 128-register cap); the
//   same flags from formed scores (2.05-2.06; 2.08 without the full-tile
//   instantiation; 2.11 with half-warp loops); the rows in a loop that is
//   not unrolled (2.24, spilling). The time follows the code's size as much
//   as its instruction count (the FMA loop shares the instruction cache).
// - Where the time goes at p 8 (clock counters of warp time at the stacked
//   DEEP-10M shape, on an H100): the FMA loop 42%, the flagged rows 23%,
//   merges 13%, the ring's barrier 14%, the flag pass 7%. With the epilogue
//   stubbed out the kernel takes 0.90 ms there against 1.30 (the bound is
//   0.48). The epilogue is bound by its instruction count (about 1,400 a
//   warp a tile beside 6,600 of the FMA loop), not by the barrier: a ring
//   refilled by the last warp to release a stage, with no block barrier,
//   was slower with TMA (the swizzle's address arithmetic) and with
//   cp.async (1.69 ms, 1.30 with the epilogue stubbed out: one warp issuing
//   a stage's 2,048 copies); 255 registers at one CTA an SM took 1.62 ms.
// - The split over centroids follows the shape (ops/route.py::split_count):
//   the fewest ranges whose CTAs fill 90% of the card's CTA slots (SMs x
//   CTAs an SM holds). The SIFT-1M shape's 32 query tiles take 9 ranges of
//   4 tiles (0.2185 ms, against 0.287 at 4 ranges), the stacked DEEP-10M
//   shape's 256 CTAs none, 32 interactive queries 33 ranges of one tile,
//   the graph route's 32 query tiles 8 ranges of 61 tiles (256 CTAs).
//   With more than one range each CTA writes its rows' p keys to scratch,
//   and route_topk_reduce (a warp a row, two list heads a lane) takes the p
//   smallest of the S sorted lists.
// Keys are unique per row, so the result is exact and deterministic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTM = 128;                 // query rows of a CTA
constexpr int kTN = 128;                 // centroids a tile
constexpr int kKC = 32;                  // k a chunk
constexpr int kKCP = kKC + 4;            // a chunk row in shared memory
constexpr int kStages = 2;
constexpr int kStageFloats = (kTM + kTN) * kKCP;
constexpr int kHalves = kWarps * 2;
constexpr int kSlotsMax = 24;            // survivor slots a row
constexpr int kSlotsMin = 8;
constexpr int kSmemMax = 232448;         // dynamic shared memory a CTA
constexpr int kMaxP = 128;
constexpr int kMaxSplit = 64;            // ranges a row (two a reduce lane)
constexpr int kRedWarps = 4;
constexpr int kRedKeys = 1024;           // S * p a reduce warp holds
constexpr u64 kEmpty = ~0ull;

struct Args {
  const float* q;      // [Q, d]
  const float* q_sq;   // [Q]
  const float* cent;   // [L, b, d]
  const float* c_sq;   // [L, b]
  const int* live;     // [L] live centroids a group, or null (all b)
  u64* keys;           // [Q, L, S, p] when S > 1
  i64* out;            // [Q, L, p] when S == 1
  i64 Q, off;
  int L, b, d, p, S, span, l2;
  int slots;           // survivor slots a row
};

// A score's ordered bits as unsigned: unsigned order is score order.
__device__ __forceinline__ uint32_t ordered(float sc) {
  int b = __float_as_int(sc == 0.0f ? 0.0f : sc);  // -0 -> +0
  b ^= (b >> 31) & 0x7fffffff;
  return static_cast<uint32_t>(b) ^ 0x80000000u;
}

__device__ __forceinline__ i64 decode(u64 key, i64 base) {
  return key == kEmpty ? -1 : static_cast<i64>(key & 0xffffffffull) + base;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory a tile CTA takes at width p with `slots` survivor slots a
// row: the ring, each stage's tile norms, the query norms, the rows' slot
// counts, lists and slots, and the half-warps' merge buffers.
__host__ __device__ inline int tile_smem(int p, int slots) {
  return (kStages * kStageFloats + kStages * kTN + kTM + kTM) * 4 +
         (kTM * p + kTM * slots + kHalves * p) * 8;
}

// Shared memory of the top-1 instantiation: the ring, its tile norms, the
// query norms, and each row's best key.
constexpr int kTop1Smem =
    (kStages * kStageFloats + kStages * kTN + kTM) * 4 + kTM * 8;

// One CTA's place: its query tile, group and range.
struct Range {
  int q0, l, s, lo, hi;
  const float* cent;
  const float* csq;
};

// Enqueues chunk g (tile g / kch, k chunk g % kch) into a stage: the
// query tile's and the centroid tile's 32-wide k slices, and with a tile's
// last chunk (TOP1: its first) its centroid norms. VEC 16 copies 16 bytes
// (d % 4 == 0, rows 16-byte aligned), else 4.
template <int VEC, bool TOP1>
__device__ __forceinline__ void enqueue(const Args& a, const Range& r, int g,
                                      int kch, float* st, float* st_csq) {
  const int tid = threadIdx.x;
  const int t = g / kch, kc = g - t * kch;
  const int k0 = kc * kKC, n0 = r.lo + t * kTN;
  constexpr int kParts = kKC / (VEC / 4);  // copies a row
  constexpr int kPer = (kTM + kTN) * kParts / kThreads;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int idx = tid + u * kThreads;
    const int row = idx / kParts, part = idx - row * kParts;
    const int col = k0 + part * (VEC / 4);
    const float* src = a.q;
    bool ok = col < a.d;
    if (row < kTM) {
      const i64 q = static_cast<i64>(r.q0) + row;
      ok = ok && q < a.Q;
      if (ok) src = a.q + q * a.d + col;
    } else {
      const int n = n0 + row - kTM;
      ok = ok && n < r.hi;
      if (ok) src = r.cent + static_cast<i64>(n) * a.d + col;
    }
    float* dst = st + row * kKCP + part * (VEC / 4);
    if (VEC == 16)
      cp16(dst, src, ok ? 16 : 0);
    else
      cp4(dst, src, ok ? 4 : 0);
  }
  if (kc == (TOP1 ? 0 : kch - 1) && tid < kTN) {
    const int n = n0 + tid;
    const bool ok = n < r.hi;
    cp4(st_csq + tid, ok ? r.csq + n : a.c_sq, ok ? 4 : 0);
  }
}

// A centroid's score from its f32 dot, rounded as ops/route.py's
// centroid_scores rounds it: (q_sq + c_sq) - 2 * dot (2 * dot is exact, so
// one fused multiply-add rounds once, as the subtraction does), or -dot.
__device__ __forceinline__ float score(int l2, float qs, float cs,
                                       float dot) {
  return l2 ? __fmaf_rn(-2.0f, dot, __fadd_rn(qs, cs)) : -dot;
}

// Row I of a lane's sums, by a compile-time index (the sums stay in
// registers).
template <int I>
__device__ __forceinline__ void take_row(const float (&acc)[8][8],
                                         float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = acc[I][j];
}

// The keys of the lane's row i (runtime) of its tile: (ordered score bits
// << 32) | centroid, the lane's centroids being n, n + 16, ...
__device__ __forceinline__ void row_keys(const float (&acc)[8][8], int i,
                                         int l2, float qs,
                                         const float (&cs)[8], int n,
                                         u64 (&key)[8]) {
  float v[8];
  switch (i) {
    case 0: take_row<0>(acc, v); break;
    case 1: take_row<1>(acc, v); break;
    case 2: take_row<2>(acc, v); break;
    case 3: take_row<3>(acc, v); break;
    case 4: take_row<4>(acc, v); break;
    case 5: take_row<5>(acc, v); break;
    case 6: take_row<6>(acc, v); break;
    default: take_row<7>(acc, v); break;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    key[j] = (static_cast<u64>(ordered(score(l2, qs, cs[j], v[j]))) << 32) |
             static_cast<uint32_t>(n + 16 * j);
}

// Component kk (compile-time) of a float4.
__device__ __forceinline__ float comp(const float4& v, int kk) {
  return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

// Keeps a key in its row's next free slot, by an atomic count; false when
// the slots are full.
__device__ __forceinline__ bool push_one(u64 key, int* cnt, u64* slot,
                                         int slots) {
  const int pos = atomicAdd(cnt, 1);
  if (pos >= slots) return false;
  slot[pos] = key;
  return true;
}

// Keeps each key of a row that is below thr (bits: the lane's keys to try)
// in the row's next free slot, by an atomic count; a key that finds the
// slots full sets its bit (8 i + j) in pend, to try again after a merge.
__device__ __forceinline__ void push(const u64 (&key)[8], unsigned bits,
                                     u64 thr, int* cnt, u64* slot, int slots,
                                     int i, u64& pend) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (((bits >> j) & 1u) && key[j] < thr && !push_one(key[j], cnt, slot,
                                                         slots))
      pend |= 1ull << (8 * i + j);
  }
}

// Merges n (<= kSlotsMax) unique keys buf[0, n), none in the list, into a
// row's ascending list[0, p): each key of the union is placed by its rank
// (the list's empty keys keep their order), the p smallest go to tmp and
// back to the list. c: the lane in its half-warp.
__device__ __forceinline__ void merge_row(u64* list, const u64* buf,
                                          u64* tmp, int n, int p, int c,
                                          unsigned hmask) {
  for (int x = c; x < n; x += 16) {
    const u64 key = buf[x];
    int lo = 0, hi = p;  // the first list entry not below key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    int rank = lo;
    for (int k = 0; k < n; ++k) rank += buf[k] < key;
    if (rank < p) tmp[rank] = key;
  }
  for (int j = c; j < p; j += 16) {
    const u64 e = list[j];
    int rank = j;
    for (int k = 0; k < n; ++k) rank += buf[k] < e;
    if (rank < p) tmp[rank] = e;
  }
  __syncwarp(hmask);
  for (int j = c; j < p; j += 16) list[j] = tmp[j];
}

// The top-1 epilogue (p == 1). Its tile's sums start at -c_sq / 2 for L2
// (exact; 0 for -dot), so each score is one fma(mul, sum, qs) (mul -2 and
// the query's norm for L2, -1 and 0 for -dot: never -0) and decreases as
// the sum grows: a row's smallest score here is that of its largest sum,
// and no score is formed until it may win. Each row's best key so far,
// (ordered score bits << 32) | centroid, sits in shared memory; its score
// bits are the row's threshold.
// Pass 1 (unrolled): a bit for each of the lane's rows whose largest sum
// here scores below the row's threshold: 8 fmaxf, one fma and a compare a
// row (a share that falls as ~2 / tiles seen a warp). ALL: every column of
// the tile is live.
template <bool ALL>
__device__ __forceinline__ unsigned top1_flags(
    const float (&acc)[8][8], const float* s_qsq, float mul, unsigned valid,
    int w, int h, const u64* s_best) {
  unsigned beat = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 16 * w + h + 2 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, ALL || ((valid >> j) & 1u) ? acc[i][j] : -INFINITY);
    const float m = __fmaf_rn(mul, mx, s_qsq[row]);
    if ((ALL || valid != 0) &&
        ordered(m) < static_cast<uint32_t>(s_best[row] >> 32))
      beat |= 1u << i;
  }
  return beat;
}

// Pass 2, for a row some lane of the warp flagged, in code written once: a
// flagged lane scores its 8 columns and takes the lowest of the smallest
// score, the half-warp the smallest of its 16 keys by shuffles, kept if
// below the row's key. A later tile's equal score, at a higher index,
// never replaces the kept one.
__device__ __forceinline__ void top1_keep(const float (&acc)[8][8], int i,
                                          bool flagged, const float* s_qsq,
                                          float mul, unsigned valid, int n,
                                          int w, int h, int c, u64* s_best) {
  const int row = 16 * w + h + 2 * i;
  float v[8];
  switch (i) {
    case 0: take_row<0>(acc, v); break;
    case 1: take_row<1>(acc, v); break;
    case 2: take_row<2>(acc, v); break;
    case 3: take_row<3>(acc, v); break;
    case 4: take_row<4>(acc, v); break;
    case 5: take_row<5>(acc, v); break;
    case 6: take_row<6>(acc, v); break;
    default: take_row<7>(acc, v); break;
  }
  const float qs = s_qsq[row];
  const u64 cur = s_best[row];
  u64 key = kEmpty;
  if (flagged) {
    float m = INFINITY;
    int at = -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float sc = __fmaf_rn(mul, v[j], qs);
      if (((valid >> j) & 1u) && (at < 0 || sc < m)) {
        m = sc;
        at = j;
      }
    }
    key = (static_cast<u64>(ordered(m)) << 32) |
          static_cast<uint32_t>(n + 16 * at);
  }
#pragma unroll
  for (int x = 8; x > 0; x >>= 1) {
    const u64 o = __shfl_xor_sync(0xffffffffu, key, x, 16);
    key = o < key ? o : key;
  }
  if (c == 0 && key < cur) s_best[row] = key;
}

template <int VEC, bool TOP1>
__global__ void __launch_bounds__(kThreads, 2) route_topk_tile(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float* s_csq = stages + kStages * kStageFloats;  // [kStages][kTN]
  float* s_qsq = s_csq + kStages * kTN;            // [kTM]
  // p > 1
  int* s_cnt = reinterpret_cast<int*>(s_qsq + kTM);  // [kTM]
  u64* s_list = reinterpret_cast<u64*>(s_cnt + kTM);  // [kTM][p]
  u64* s_slot = s_list + kTM * a.p;                   // [kTM][slots]
  u64* s_tmp = s_slot + kTM * a.slots;                // [kHalves][p]
  // p == 1: each row's best key so far
  u64* s_best = reinterpret_cast<u64*>(s_qsq + kTM);  // [kTM]

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, h = lane >> 4, c = lane & 15;
  const unsigned hmask = 0xffffu << (16 * h);
  const int p = a.p;

  // blockIdx.x = qt + QT * (s + S * l): the CTAs that run together share a
  // range of centroids
  const i64 QT = (a.Q + kTM - 1) / kTM;
  Range r;
  i64 bx = blockIdx.x;
  r.q0 = static_cast<int>(bx % QT) * kTM;
  bx /= QT;
  r.s = static_cast<int>(bx % a.S);
  r.l = static_cast<int>(bx / a.S);
  const int live = a.live != nullptr ? min(max(a.live[r.l], 0), a.b) : a.b;
  r.lo = r.s * a.span;
  r.hi = min(r.lo + a.span, live);
  r.cent = a.cent + static_cast<i64>(r.l) * a.b * a.d;
  r.csq = a.c_sq + static_cast<i64>(r.l) * a.b;
  const int ntiles = r.hi > r.lo ? (r.hi - r.lo + kTN - 1) / kTN : 0;
  const int kch = (a.d + kKC - 1) / kKC;
  const int G = ntiles * kch;

  if constexpr (TOP1) {
    for (int e = tid; e < kTM; e += kThreads) s_best[e] = kEmpty;
  } else {
    for (int e = tid; e < kTM * p; e += kThreads) s_list[e] = kEmpty;
  }
  for (int e = tid; e < kTM; e += kThreads) {
    const i64 q = static_cast<i64>(r.q0) + e;
    s_qsq[e] = a.l2 && q < a.Q ? a.q_sq[q] : 0.0f;
    if (!TOP1) s_cnt[e] = 0;
  }
  if (G > 0) enqueue<VEC, TOP1>(a, r, 0, kch, stages, s_csq);
  cp_commit();

  u64* tmp = s_tmp + (2 * w + h) * p;
  float acc[8][8];
  for (int g = 0; g < G; ++g) {
    cp_wait_all();
    __syncthreads();
    if (g + 1 < G)
      enqueue<VEC, TOP1>(a, r, g + 1, kch,
                         stages + ((g + 1) & 1) * kStageFloats,
                         s_csq + ((g + 1) & 1) * kTN);
    cp_commit();
    const int t = g / kch, kc = g - t * kch;
    if (kc == 0) {
      // top-1 L2: each sum starts at -c_sq / 2 (top1_flags)
      const float* csq0 = s_csq + (g & 1) * kTN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float init = TOP1 && a.l2 ? -0.5f * csq0[c + 16 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = init;
      }
    }
    const float* st = stages + (g & 1) * kStageFloats;
    const float* A = st + (16 * w + h) * kKCP;  // rows 16w + h + 2i
    const float* B = st + (kTM + c) * kKCP;     // centroids c + 16j
    // a k step of 4: the lane's 8 query float4s, then two halves of its
    // centroid float4s; each sum gets its k terms in order, and a row of
    // 32 independent FMAs follows each load
#pragma unroll 2
    for (int k = 0; k < kKC; k += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(A + i * 2 * kKCP + k);
#pragma unroll
      for (int jh = 0; jh < 8; jh += 4) {
        float4 bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(B + (jh + j) * 16 * kKCP +
                                                   k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][jh + j] = fmaf(comp(av[i], kk), comp(bv[j], kk),
                                    acc[i][jh + j]);
      }
    }
    if (kc != kch - 1) continue;

    if constexpr (TOP1) {
      const int n = r.lo + t * kTN + c;
      unsigned valid = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) valid |= (n + 16 * j < r.hi) << j;
      const float mul = a.l2 ? -2.0f : -1.0f;
      const unsigned beat =
          valid == 0xffu
              ? top1_flags<true>(acc, s_qsq, mul, valid, w, h, s_best)
              : top1_flags<false>(acc, s_qsq, mul, valid, w, h, s_best);
      unsigned rows = __reduce_or_sync(0xffffffffu, beat);
      while (rows != 0) {
        const int i = __ffs(rows) - 1;
        rows &= rows - 1;
        top1_keep(acc, i, (beat >> i) & 1u, s_qsq, mul, valid, n, w, h, c,
                  s_best);
      }
      continue;
    }

    // the tile's epilogue. An unrolled pass flags each of the lane's rows
    // whose smallest score here may beat the row's threshold; each half-warp
    // then takes its flagged rows one at a time, in code written once (so it
    // stays in the instruction cache: unrolled by row, or pushing keys in
    // the unrolled pass, it ran slower), and keeps each key below the row's
    // threshold in the row's next free slot
    const float* csq = s_csq + (g & 1) * kTN;
    const int n0 = r.lo + t * kTN;
    unsigned valid = 0;
    float cs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      valid |= (n0 + c + 16 * j < r.hi) << j;
      cs[j] = csq[c + 16 * j];
    }
    unsigned flag = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 16 * w + h + 2 * i;
      const float qs = s_qsq[row];
      float best = INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((valid >> j) & 1u)
          best = fminf(best, score(a.l2, qs, cs[j], acc[i][j]));
      const u64 thr = s_list[row * p + p - 1];
      if (valid != 0 && ordered(best) <= static_cast<uint32_t>(thr >> 32) &&
          static_cast<i64>(r.q0) + row < a.Q)
        flag |= 1u << i;
    }
    unsigned rows = __reduce_or_sync(hmask, flag);
    u64 pend = 0;
    while (rows != 0) {
      const int i = __ffs(rows) - 1;
      rows &= rows - 1;
      const int row = 16 * w + h + 2 * i;
      u64 key[8];
      row_keys(acc, i, a.l2, s_qsq[row], cs, n0 + c, key);
      u64 thr = s_list[row * p + p - 1];
      // a row with fewer than p keys (a range's first tile): for p <= 16
      // the p-th smallest of the lanes' smallest keys bounds the tile's
      // p-th, so about p keys, not all 128, take slots
      if (p <= 16 && thr == kEmpty) {
        u64 mine = kEmpty;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if ((valid >> j) & 1u) mine = key[j] < mine ? key[j] : mine;
        int below = 0;
#pragma unroll
        for (int o = 0; o < 16; ++o)
          below += __shfl_sync(hmask, mine, o, 16) < mine;
        const unsigned at =
            __ballot_sync(hmask, below == p - 1 && mine != kEmpty) & hmask;
        if (at != 0)
          thr = __shfl_sync(hmask, mine, __ffs(at) - 1 - 16 * h, 16) + 1;
      }
      push(key, valid, thr, s_cnt + row, s_slot + row * a.slots, a.slots, i,
           pend);
    }
    while (true) {
      __syncwarp(hmask);
      const bool want = c < 8 && s_cnt[16 * w + h + 2 * c] > 0;
      unsigned m = (__ballot_sync(hmask, want) & hmask) >> (16 * h);
      while (m != 0) {
        const int i = __ffs(m) - 1;
        m &= m - 1;
        const int row = 16 * w + h + 2 * i;
        merge_row(s_list + row * p, s_slot + row * a.slots, tmp,
                  min(s_cnt[row], a.slots), p, c, hmask);
        __syncwarp(hmask);
        if (c == 0) s_cnt[row] = 0;
        __syncwarp(hmask);
      }
      unsigned waiting = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if ((pend >> (8 * i)) & 0xffu) waiting |= 1u << i;
      waiting = __reduce_or_sync(hmask, waiting);
      if (waiting == 0) break;
      while (waiting != 0) {
        const int i = __ffs(waiting) - 1;
        waiting &= waiting - 1;
        const int row = 16 * w + h + 2 * i;
        u64 key[8];
        row_keys(acc, i, a.l2, s_qsq[row], cs, n0 + c, key);
        const unsigned bits = static_cast<unsigned>(pend >> (8 * i)) & 0xffu;
        pend &= ~(0xffull << (8 * i));
        push(key, bits, s_list[row * p + p - 1], s_cnt + row,
             s_slot + row * a.slots, a.slots, i, pend);
      }
    }
  }
  __syncthreads();  // the lists' initial values, when no tile ran

  // each half-warp writes its own rows
  const i64 base = static_cast<i64>(r.l) * a.off;
  if constexpr (TOP1) {
    // lane i of a half-warp writes row i's key
    const int row = 16 * w + h + 2 * c;
    const i64 q = static_cast<i64>(r.q0) + row;
    if (c < 8 && q < a.Q) {
      const u64 key = s_best[row];
      const i64 at = q * a.L + r.l;
      if (a.S == 1)
        a.out[at] = decode(key, base);
      else
        a.keys[at * a.S + r.s] = key;
    }
    return;
  }
  for (int i = 0; i < 8; ++i) {
    const int row = 16 * w + h + 2 * i;
    const i64 q = static_cast<i64>(r.q0) + row;
    if (q >= a.Q) continue;
    const u64* list = s_list + row * p;
    const i64 at = q * a.L + r.l;
    if (a.S == 1) {
      for (int j = c; j < p; j += 16) a.out[at * p + j] = decode(list[j], base);
    } else {
      u64* dst = a.keys + (at * a.S + r.s) * p;
      for (int j = c; j < p; j += 16) dst[j] = list[j];
    }
  }
}

// The p smallest of a row's S sorted lists of p keys (S <= 64): a warp a
// row, the lists in shared memory, lane s the heads of lists s and s + 32;
// each step takes the warp's smallest head (keys are unique but for the
// empty key) and advances it.
__global__ void __launch_bounds__(kRedWarps * 32)
    route_topk_reduce(const u64* __restrict__ keys, i64 rows, int L, int S,
                      int p, i64 off, i64* __restrict__ out) {
  extern __shared__ u64 sk[];  // [kRedWarps][S * p]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const i64 row = static_cast<i64>(blockIdx.x) * kRedWarps + w;
  if (row >= rows) return;  // the warp agrees
  const int n = S * p;
  u64* my = sk + w * n;
  const u64* src = keys + row * n;
  for (int e = lane; e < n; e += 32) my[e] = src[e];
  __syncwarp();
  int at0 = 0, at1 = 0;
  u64 h0 = lane < S ? my[lane * p] : kEmpty;
  u64 h1 = lane + 32 < S ? my[(lane + 32) * p] : kEmpty;
  const i64 base = (row % L) * off;
  i64* o = out + row * p;
  for (int t = 0; t < p; ++t) {
    u64 m = h0 < h1 ? h0 : h1;
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      const u64 v = __shfl_xor_sync(0xffffffffu, m, x);
      m = v < m ? v : m;
    }
    if (lane == (t & 31)) o[t] = decode(m, base);
    if (m == kEmpty) continue;
    if (h0 == m) {
      ++at0;
      h0 = at0 < p ? my[lane * p + at0] : kEmpty;
    } else if (h1 == m) {
      ++at1;
      h1 = at1 < p ? my[(lane + 32) * p + at1] : kEmpty;
    }
  }
}

// Lets route_topk_tile<VEC, TOP1> take up to kSmemMax bytes of dynamic shared
// memory on the current device, with the whole carveout as shared memory
// (so that two CTAs of a narrow p fit an SM): once a device, as the
// attributes hold per device.
template <int VEC, bool TOP1>
int allow_smem() {
  static std::atomic<unsigned long long> raised{0};  // a bit a device
  int dev = -1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool track = dev >= 0 && dev < 64;
  if (track && ((raised.load() >> dev) & 1ull)) return 0;
  err = cudaFuncSetAttribute(
      route_topk_tile<VEC, TOP1>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(route_topk_tile<VEC, TOP1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (track) raised.fetch_or(1ull << dev);
  return 0;
}

// Survivor slots a row at width p: kSlotsMax, fewer where a wide p leaves
// no room.
int slots_for(int p) {
  int slots = kSlotsMax;
  while (slots > kSlotsMin && tile_smem(p, slots) > kSmemMax) --slots;
  return slots;
}

// Shared memory a tile CTA takes at width p.
int smem_for(int p) {
  return p == 1 ? kTop1Smem : tile_smem(p, slots_for(p));
}

template <int VEC, bool TOP1>
int launch_tile(const Args& a, unsigned int grid, cudaStream_t st) {
  const int err = allow_smem<VEC, TOP1>();
  if (err != 0) return err;
  route_topk_tile<VEC, TOP1><<<grid, kThreads, smem_for(a.p), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each (query, group) row's p nearest centroids. vec: 16 (d % 4 == 0, q and
// cent 16-byte aligned) or 4. q [Q, d], q_sq [Q], cent [L, b, d], c_sq [L,
// b] f32; live [L] int32 or null; p in [1, 128]; S ranges of span
// centroids a group (S in [1, 64], S * p <= 1024, S * span >= b); l2: the
// L2 form, else -dot; off: the id offset of a group. keys: [Q, L, S, p]
// uint64 scratch when S > 1. out: [Q, L, p] int64 ids, ascending by (score,
// id). Returns a cudaError_t.
extern "C" int route_topk_launch(int vec, const float* q, const float* q_sq,
                                 const float* cent, const float* c_sq,
                                 const int* live, long long Q, int L, int b,
                                 int d, int p, int S, int span, int l2,
                                 long long off, unsigned long long* keys,
                                 long long* out, void* stream) {
  if (Q == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  if (p < 1 || p > kMaxP || S < 1 || S > kMaxSplit || S * p > kRedKeys ||
      d < 1 || b < 0 || span < 1 || static_cast<i64>(S) * span < b ||
      (S > 1 && keys == nullptr) || (vec != 16 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const i64 grid = (Q + kTM - 1) / kTM * L * S;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.q = q;
  a.q_sq = q_sq;
  a.cent = cent;
  a.c_sq = c_sq;
  a.live = live;
  a.keys = keys;
  a.out = out;
  a.Q = Q;
  a.off = off;
  a.L = L;
  a.b = b;
  a.d = d;
  a.p = p;
  a.S = S;
  a.span = span;
  a.l2 = l2;
  a.slots = slots_for(p);
  const unsigned int g = static_cast<unsigned int>(grid);
  const int err =
      p == 1 ? (vec == 16 ? launch_tile<16, true>(a, g, st)
                          : launch_tile<4, true>(a, g, st))
             : (vec == 16 ? launch_tile<16, false>(a, g, st)
                          : launch_tile<4, false>(a, g, st));
  if (err != 0 || S == 1) return err;
  const i64 rows = Q * L;
  route_topk_reduce<<<static_cast<unsigned int>(
                          (rows + kRedWarps - 1) / kRedWarps),
                      kRedWarps * 32, kRedWarps * S * p * 8, st>>>(
      keys, rows, L, S, p, off, out);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the tile kernel an SM holds at width p (16-byte copies), or a
// negative cudaError_t.
extern "C" int route_topk_occupancy(int p) {
  if (p < 1 || p > kMaxP) return -static_cast<int>(cudaErrorInvalidValue);
  const int err = p == 1 ? allow_smem<16, true>() : allow_smem<16, false>();
  if (err != 0) return -err;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n,
      p == 1 ? route_topk_tile<16, true> : route_topk_tile<16, false>,
      kThreads, smem_for(p));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
