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
// Two entries:
//   expand_score_launch: out[q, j, s] f32, the Pallas function's contract;
//   expand_topr_launch:  for each pair (q, j), the R = min(r, S) smallest
//     keys (ordered score bits << 32 | j * S + s) of its S rows, where the
//     ordered bits are the f32 score's bits with the magnitude flipped when
//     negative (-0 taken as +0), so signed int64 order is (score, position);
//     then each query's top r of its p lists, ascending (a merge kernel up
//     to 1024 keys a query; above that the wrapper's torch.topk).
//
// What bounds it: bytes. Each probed block's rows are read for S outputs a
// query with one multiply-add per byte: far below the card's
// compute-per-byte line. The earlier design ran one CTA per (query, probe)
// pair and so read a block once for every query that probed it.
//
// What the design does about it: a first kernel groups the Q * p pairs by
// block id on the device (a counting sort; no host synchronisation), and
// each CTA of the scorer takes T = 32 consecutive grouped pairs. Within its
// range each run of equal block ids streams that block once, in stages of
// 256 rows x 128 bytes, through shared memory with cp.async (the next
// stage is in flight while this one is scored), with the same bytes of
// each query of the run; a run's last stage also brings the rows' ids,
// norms and filter bytes. 8 warps each hold 32 rows x up to 32 queries of
// int32 (int8) or f32 (bf16) mma accumulators, fed by ldmatrix. A run that
// crosses a CTA boundary is read by both CTAs: at most Q * p / T extra
// block reads. The fused entry keeps each pair's S ordered scores in
// shared memory and a warp a pair finds the R-th smallest by a bitwise
// search, keeping every row below it and the lowest positions equal to it;
// a merge kernel (a warp a query, the same search over the p * R keys)
// writes each query's top r ascending. No [Q, p, S] scores reach device
// memory. Block offsets are 64-bit. TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef long long i64;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupRows = kWarps * 32;  // block rows scored per pass
constexpr int kT = 32;                   // grouped pairs per CTA
constexpr int kKC = 128;                 // row bytes a stage (swizzled)
constexpr int kStages = 2;               // stages in flight
constexpr int kGroupThreads = 1024;      // the grouping kernel's CTA
constexpr int kGroupCtas = 64;           // and its grid

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2 };

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

// Shared memory: kStages stages, the per-pair tables, then the score tile.
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

template <int MODE>
using acc_t = typename std::conditional<MODE == kI8, int, float>::type;

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

template <int VEC>
__device__ __forceinline__ void cp_async(char* dst, const uint8_t* src,
                                         int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte k of staged row `row`: its 16-byte chunk XOR the row's low 3 bits,
// so the 8 rows an ldmatrix (or a phase of float4 loads) reads from one
// logical chunk sit in 8 different bank groups.
__device__ __forceinline__ int swz(int row, int k) {
  return row * kKC + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// Groups the P pairs by block (a counting sort): gbid[P] the block id of
// each entry (-1 for ids outside [0, B), all in one group) and gpair[P] its
// pair; equal ids are adjacent, in no order within a group. CTA c owns the
// buckets [c * per, (c + 1) * per) of the B + 1 (the last for bad ids): it
// reads every id twice (from L2), counts those below its range for its
// base offset, and places its own.
__global__ void __launch_bounds__(kGroupThreads)
group_kernel(const i64* __restrict__ bids, int P, int B,
             int* __restrict__ gbid, int* __restrict__ gpair) {
  extern __shared__ int cnt[];  // this CTA's buckets
  __shared__ int wsum[kGroupThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  if (lane == 0) wsum[warp] = below;
  __syncthreads();
  const int base = __reduce_add_sync(0xffffffffu, wsum[lane]);
  __syncthreads();  // wsum is the scan's next
  // exclusive scan of the range's counts: each thread a contiguous slice
  const int m = hi - lo;
  const int chunk = (m + kGroupThreads - 1) / kGroupThreads;
  const int c0 = min(tid * chunk, m), c1 = min(c0 + chunk, m);
  int sum = 0;
  for (int i = c0; i < c1; ++i) sum += cnt[i];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  int run = base + x - sum + (warp ? wsum[warp - 1] : 0);
  for (int i = c0; i < c1; ++i) {
    const int c = cnt[i];
    cnt[i] = run;
    run += c;
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
      gbid[at] = k[u] == B ? -1 : k[u];
      gpair[at] = i0 + u * kGroupThreads + tid;
    }
  }
}

// Each query's r smallest of its C = p * R candidate keys (C <= kMergeC,
// r <= kMaxR), ascending, decoded to (score, position): a warp a query
// finds the r-th smallest key by a bitwise search, gathers the keys up to
// it and places each by its rank.
constexpr int kMergeC = 1024;
constexpr int kMaxR = 128;

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

// A score's ordered bits as unsigned: unsigned order is score order.
__device__ __forceinline__ uint32_t ordered(float sc) {
  int b = __float_as_int(sc == 0.0f ? 0.0f : sc);  // -0 -> +0
  b ^= (b >> 31) & 0x7fffffff;
  return static_cast<uint32_t>(b) ^ 0x80000000u;
}

// The key of an ordered score at a position: (signed ordered bits << 32) |
// pos, so signed int64 order is (score, position).
__device__ __forceinline__ i64 key_of(uint32_t u, int pos) {
  return static_cast<i64>(
      (static_cast<unsigned long long>(u ^ 0x80000000u) << 32) |
      static_cast<uint32_t>(pos));
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

template <bool TOPR>
int dispatch(int mode, int vec, const Args& a, i64 n_blocks,
             const i64* bids, int* gbid, int* gpair, void* stream) {
  if (a.pairs == 0 || a.S == 0) return static_cast<int>(cudaGetLastError());
  if (a.row_bytes <= 0 || a.row_bytes % vec || n_blocks >= 0x7fffffffLL ||
      a.pairs >= 0x7fffffffLL ||
      (TOPR && (a.S > kGroupRows || a.R < 1 || a.R > a.S)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(n_blocks) + 1;
  const int ctas = min(kGroupCtas, nb);
  const int per = (nb + ctas - 1) / ctas;
  cudaError_t e = cudaSuccess;
  if (per * 4 > 48 * 1024)
    e = cudaFuncSetAttribute(group_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             per * 4);
  if (e != cudaSuccess) return static_cast<int>(e);
  group_kernel<<<ctas, kGroupThreads, per * 4, st>>>(
      bids, static_cast<int>(a.pairs), static_cast<int>(n_blocks), gbid,
      gpair);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vec == 16) {
    if (mode == kF32) return launch<kF32, 16, TOPR>(a, st);
    if (mode == kBF16) return launch<kBF16, 16, TOPR>(a, st);
    if (mode == kI8) return launch<kI8, 16, TOPR>(a, st);
  } else if (vec == 4) {
    if (mode == kF32) return launch<kF32, 4, TOPR>(a, st);
    if (mode == kBF16) return launch<kBF16, 4, TOPR>(a, st);
    if (mode == kI8) return launch<kI8, 4, TOPR>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* blocks, const float* blocks_sq,
               const int* block_ids, const bool* allowed, const void* q,
               const float* q_sq, const float* q_scale,
               const float* score_scale, int* gbid, int* gpair,
               long long pairs, int p, int S, int row_bytes, int l2) {
  Args a{};
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
// filter mask, or null. bids: [Q, p] int64 block ids; gbid and gpair
// [Q * p] int32 scratch (the pairs grouped by block). out: [Q, p, S] f32.
// Returns a cudaError_t.
extern "C" int expand_score_launch(
    int mode, int vec, const void* blocks, const float* blocks_sq,
    const int* block_ids, const bool* allowed, const void* q,
    const float* q_sq, const float* q_scale, const float* score_scale,
    const long long* bids, int* gbid, int* gpair, float* out,
    long long n_blocks, long long pairs, int p, int S, int row_bytes, int l2,
    void* stream) {
  Args a = make_args(blocks, blocks_sq, block_ids, allowed, q, q_sq, q_scale,
                     score_scale, gbid, gpair, pairs, p, S, row_bytes, l2);
  a.out = out;
  return dispatch<false>(mode, vec, a, n_blocks, bids, gbid, gpair,
                         stream);
}

// The fused top-r: keys [Q, p, R] int64, each pair's R = min(r, S) smallest
// keys, in no order; S <= 256. With top_score and top_pos non-null
// (p * R <= 1024, rq <= min(128, p * R)), also each query's rq smallest of
// its p * R keys, ascending, as [Q, rq] f32 scores and int64 positions.
// Otherwise as expand_score_launch.
extern "C" int expand_topr_launch(
    int mode, int vec, const void* blocks, const float* blocks_sq,
    const int* block_ids, const bool* allowed, const void* q,
    const float* q_sq, const float* q_scale, const float* score_scale,
    const long long* bids, int* gbid, int* gpair, long long* keys,
    long long n_blocks, long long pairs, int p, int S, int row_bytes, int l2,
    int R, float* top_score, long long* top_pos, int rq, void* stream) {
  Args a = make_args(blocks, blocks_sq, block_ids, allowed, q, q_sq, q_scale,
                     score_scale, gbid, gpair, pairs, p, S, row_bytes, l2);
  a.keys = keys;
  a.R = R;
  const int C = p * R;
  const bool merge = top_score != nullptr && top_pos != nullptr;
  if (merge && (C > kMergeC || rq < 1 || rq > kMaxR || rq > C))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = dispatch<true>(mode, vec, a, n_blocks, bids, gbid,
                                 gpair, stream);
  if (err != 0 || !merge || pairs == 0) return err;
  const i64 Q = pairs / p;
  const auto grid = static_cast<unsigned int>((Q + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= kMergeC / 2)
    merge_kernel<kMergeC / 64><<<grid, kThreads, 0, st>>>(
        keys, static_cast<int>(Q), C, rq, top_score, top_pos);
  else
    merge_kernel<kMergeC / 32><<<grid, kThreads, 0, st>>>(
        keys, static_cast<int>(Q), C, rq, top_score, top_pos);
  return static_cast<int>(cudaGetLastError());
}
