// The graph engine's level-0 serving beam for Hopper (sm_90a): the whole
// ef-bounded search of each query in one launch, a warp a query.
//
// Replaces no Pallas kernel. The reference's beam is a lax.while_loop of
// XLA ops (tpu_hnsw/index/search.py::_search_layer_body, search.py:86-271,
// the loop at :243), which the port ran as a Python loop of ~65 torch ops a
// step (index/search.py::_search_layer_body) with a host sync every
// CHECK_EVERY steps: ~3,300 launches and 13 syncs a 4,096-query request at
// ef 40, the host's dispatch slower than the device's work.
//
// What it computes, for each query (the loop's function at level 0,
// expand 1, skip_deleted and mask_deleted_results):
// - the pool: the seeds [Q, S] scored (a sentinel at +inf), the best ef in
//   (score, column) order, padded with (+inf, sentinel);
// - each step, up to max_steps: the first unexpanded valid pool entry; the
//   query stops when there is none or its score exceeds the pool's worst
//   (+inf while a slot holds the sentinel), the d_c > f break. Else it is
//   marked expanded and written to ring slot step % H; its neighbours that
//   are not the sentinel, not deleted, allowed (when a mask is given), and
//   in neither the pool nor the ring are fresh; each is scored in f32,
//   elementwise (L2 sum (q - x)^2, L1 sum |q - x|, IP and cosine
//   -sum q * x; no norms expansion, no TF32), and merged into the pool in
//   the loop's stable order over [pool, new]: at equal scores the pool's
//   entry first, then the lower column; the best ef stay.
// - the end: pool entries that are deleted or disallowed are dropped, the
//   rest keep their order, +inf entries read as the sentinel; the ring
//   [Q, H] (the sentinel where a query did not step), hops (its steps) and
//   evals (its fresh neighbours, summed).
// A query that fails the test changes nothing at any later step of the
// loop (it expands the sentinel row, nothing is fresh), so stopping it
// there, alone, gives the lockstep loop's pool and counters; the loop's
// idle steps write the sentinel into the ring, which differs only after
// the ring wrapped. Only the sum order of the scores differs from the
// loop's torch reductions.
//
// What bounds it: bytes, gathered at random. A query's step reads one
// adjacency row (2m int32: 128 bytes at m 16) and the vectors of its fresh
// neighbours (512 bytes each at d 128), on a dependent chain of memory
// round trips: the row, then the vectors (the tombstone and filter bytes
// are read beside them). At the sift1m-graph cell's shape (4,096 queries,
// ef 40, ~40 steps, ~20 fresh neighbours a step) that is ~1.5 GB a
// request, about 0.44 ms at 3.35 TB/s (hnswbench/roofline_graph.py's count
// of the least bytes: each expanded row and each distinct vector once).
//
// Design (beam_kernel):
// - A warp a query, four a CTA, 72-80 registers a lane: 6-7 CTAs an SM,
//   so 3,168-3,696 of a 4,096-query request's warps are resident at once
//   and hide each other's round trips. A warp runs its own loop and stops
//   at its own test: no lockstep, no host sync. (On an H100 at the cell's
//   shape: 1.09 ms against the 0.44-ms bound; 8 or 2 warps a CTA, or 64
//   registers and 8 CTAs an SM, all resident, came within 5% of it, so
//   occupancy does not bound it.)
// - Shared memory a warp: the query (d floats), the pool twice (scores and
//   ids, the expanded flag in the id's top bit; one copy is read while the
//   merge writes the other), the ring, and the step's candidates (ids and
//   scores): ~1.9 KB at d 128, ef 40.
// - Lane j takes neighbour j (j + 32 too past degree 32): its adjacency
//   entry, then the dedup against the pool and the ring (16-byte reads of
//   shared memory, broadcast to the warp); the survivors are compacted by
//   ballot in column order.
// - Scores: kRows candidate rows in flight a warp, each lane loading 16
//   bytes of each (512 bytes a row a warp at d 128, one 128-byte line a
//   quarter-warp); a transposed butterfly (9 shuffles for 8 rows) leaves
//   row r's sum on lanes 4r..4r+3.
// - The merge places each entry by its rank: a candidate's is the pool
//   entries at or below its score (a binary search of the sorted pool)
//   plus the candidates before it in (score, column) order; a pool entry's
//   is its position plus the candidates strictly below it. No sort.
// Rows are read with __ldg (read-only path): the vectors and adjacency do
// not change during a search.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;             // queries a CTA (at most)
constexpr int kMaxEF = 256;
constexpr int kMaxDeg = 64;           // candidates a step; seeds a chunk
constexpr int kRows = 8;              // vector rows in flight a warp
constexpr int kSmemMax = 232448;      // dynamic shared memory a CTA
constexpr int kSmemDefault = 49152;   // without the opt-in attribute
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMask = 0x7fffffff;     // an id without the expanded flag

enum { kL2 = 0, kL1 = 1, kIP = 2 };

struct Args {
  const float* q;          // [Q, d]
  const int* seeds;        // [Q, S]
  const float* vec;        // [cap + 1, d]; row cap (the sentinel) zeros
  const int* nbr;          // [cap + 1, deg]; sentinel padded
  const uint8_t* deleted;  // [cap + 1]
  const uint8_t* allowed;  // [cap + 1], or null: every id
  float* out_d;            // [Q, ef]
  int* out_i;              // [Q, ef]
  int* hist;               // [Q, H]
  int* hops;               // [Q]
  int* evals;              // [Q]
  int Q, S, d, deg, ef, H, max_steps, sent;
  int qw, efp, hp;         // words of the query, a pool array, the ring
  int warp_words;          // shared words a warp
};

template <int M>
__device__ __forceinline__ float acc1(float q, float x, float s) {
  if (M == kL2) {
    const float t = q - x;
    return fmaf(t, t, s);
  }
  if (M == kL1) return s + fabsf(q - x);
  return fmaf(q, x, s);
}

template <int M>
__device__ __forceinline__ float acc4(float4 q, float4 x, float s) {
  s = acc1<M>(q.x, x.x, s);
  s = acc1<M>(q.y, x.y, s);
  s = acc1<M>(q.z, x.z, s);
  return acc1<M>(q.w, x.w, s);
}

// v[r]: this lane's partial sum of row r. Returns the warp's sum of row
// (lane >> 2) & 7: three halving exchanges (lanes 16, 8, 4 apart) each keep
// half of the rows and add the partner's half, then two plain ones.
__device__ __forceinline__ float reduce8(float (&v)[kRows], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h16 ? v[i] : v[i + 4];
    const float keep = h16 ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h8 ? v[i] : v[i + 2];
    const float keep = h8 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  const float send = h4 ? v[0] : v[1];
  float s = (h4 ? v[1] : v[0]) + __shfl_xor_sync(kFull, send, 4);
  s += __shfl_xor_sync(kFull, s, 2);
  return s + __shfl_xor_sync(kFull, s, 1);
}

// Scores of the n rows ids[0, n) (shared) against the query qs (shared)
// into out[0, n) (shared). The whole warp calls it.
template <int M, bool V4>
__device__ void score_rows(const Args& a, const float* qs, const int* ids,
                           float* out, int n, int lane) {
  for (int b0 = 0; b0 < n; b0 += kRows) {
    const int nr = min(kRows, n - b0);
    const float* row[kRows];
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      row[r] = a.vec + static_cast<size_t>(ids[b0 + (r < nr ? r : 0)]) * a.d;
      v[r] = 0.f;
    }
    if (V4) {
      for (int e = lane * 4; e < a.d; e += 128) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + e);
        float4 x[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          x[r] = r < nr ? __ldg(reinterpret_cast<const float4*>(row[r] + e))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = acc4<M>(qv, x[r], v[r]);
      }
    } else {
      for (int e = lane; e < a.d; e += 32) {
        const float qv = qs[e];
        float x[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          x[r] = r < nr ? __ldg(row[r] + e) : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = acc1<M>(qv, x[r], v[r]);
      }
    }
    const float s = reduce8(v, lane);
    const int r = (lane >> 2) & 7;
    if ((lane & 3) == 0 && r < nr) out[b0 + r] = M == kIP ? -s : s;
  }
}

// Whether nb (not the sentinel) is in the pool (ids, flag masked) or the
// ring; both padded to a multiple of 4 with the sentinel.
__device__ __forceinline__ bool seen(int nb, const int* pi, int efp,
                                     const int* ring, int hp) {
  bool hit = false;
  for (int i = 0; i < efp; i += 4) {
    const int4 t = *reinterpret_cast<const int4*>(pi + i);
    hit |= ((t.x & kMask) == nb) | ((t.y & kMask) == nb) |
           ((t.z & kMask) == nb) | ((t.w & kMask) == nb);
  }
  for (int i = 0; i < hp; i += 4) {
    const int4 t = *reinterpret_cast<const int4*>(ring + i);
    hit |= (t.x == nb) | (t.y == nb) | (t.z == nb) | (t.w == nb);
  }
  return hit;
}

// The pool (pd, pi; ef entries sorted by (score, position)) merged with n
// candidates (cid, csc in column order; +inf: not fresh) into (nd, ni): the
// best ef of [pool, candidates] in stable order, each entry placed by its
// rank. The whole warp calls it; every slot of [0, ef) is written once.
__device__ void merge(const float* pd, const int* pi, float* nd, int* ni,
                      const int* cid, const float* csc, int n, int ef,
                      int lane) {
  int rank[kMaxDeg / 32];
#pragma unroll
  for (int t = 0; t < kMaxDeg / 32; ++t) {
    const int j = lane + 32 * t;
    rank[t] = ef;
    const float s = j < n ? csc[j] : INFINITY;
    if (s < INFINITY) {
      int lo = 0, hi = ef;  // the pool entries at or below s
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pd[mid] <= s) lo = mid + 1;
        else hi = mid;
      }
      for (int k = 0; k < n; ++k) {
        const float o = csc[k];
        lo += (o < s) | ((o == s) & (k < j));
      }
      rank[t] = lo;
    }
  }
  for (int i = lane; i < ef; i += 32) {
    const float p = pd[i];
    int r = i;
    for (int k = 0; k < n; ++k) r += csc[k] < p;
    if (r < ef) {
      nd[r] = p;
      ni[r] = pi[i];
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxDeg / 32; ++t) {
    if (rank[t] < ef) {
      nd[rank[t]] = csc[lane + 32 * t];
      ni[rank[t]] = cid[lane + 32 * t];
    }
  }
  __syncwarp();
}

template <int M, bool V4>
__global__ void __launch_bounds__(kWarps * 32) beam_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int qi = blockIdx.x * (blockDim.x >> 5) + w;
  if (qi >= a.Q) return;  // a whole warp: no CTA barrier below
  const unsigned lt = (1u << lane) - 1;
  const int sent = a.sent, ef = a.ef;

  float* qs = smem + static_cast<size_t>(w) * a.warp_words;
  float* pd[2];
  int* pi[2];
  pd[0] = qs + a.qw;
  pi[0] = reinterpret_cast<int*>(pd[0] + a.efp);
  pd[1] = reinterpret_cast<float*>(pi[0] + a.efp);
  pi[1] = reinterpret_cast<int*>(pd[1] + a.efp);
  int* ring = pi[1] + a.efp;
  int* cid = ring + a.hp;
  float* csc = reinterpret_cast<float*>(cid + kMaxDeg);

  const float* q = a.q + static_cast<size_t>(qi) * a.d;
  for (int e = lane; e < a.qw; e += 32) qs[e] = e < a.d ? q[e] : 0.f;
  for (int i = lane; i < a.efp; i += 32) {
    pd[0][i] = pd[1][i] = INFINITY;
    pi[0][i] = pi[1][i] = sent;
  }
  for (int i = lane; i < a.hp; i += 32) ring[i] = sent;
  __syncwarp();

  // the seeds, kMaxDeg at a time, merged into the empty pool
  int cur = 0;
  const int* seeds = a.seeds + static_cast<size_t>(qi) * a.S;
  for (int c0 = 0; c0 < a.S; c0 += kMaxDeg) {
    const int n = min(kMaxDeg, a.S - c0);
    for (int j = lane; j < n; j += 32) cid[j] = seeds[c0 + j];
    __syncwarp();
    score_rows<M, V4>(a, qs, cid, csc, n, lane);
    __syncwarp();
    for (int j = lane; j < n; j += 32)
      if (cid[j] == sent) csc[j] = INFINITY;
    __syncwarp();
    merge(pd[cur], pi[cur], pd[cur ^ 1], pi[cur ^ 1], cid, csc, n, ef, lane);
    cur ^= 1;
  }

  int hops = 0, evals = 0;
  for (int step = 0; step < a.max_steps; ++step) {
    const float* d0 = pd[cur];
    int* i0 = pi[cur];
    // the first unexpanded valid entry, and whether a slot is empty
    int first = -1;
    bool open = false;
    for (int b = 0; b < ef; b += 32) {
      const int i = b + lane;
      const int id = i < ef ? i0[i] : sent;
      const bool valid = (id & kMask) != sent;
      const unsigned u = __ballot_sync(kFull, valid && id >= 0);
      open |= __ballot_sync(kFull, i < ef && !valid) != 0;
      if (first < 0 && u != 0) first = b + __ffs(u) - 1;
    }
    if (first < 0) break;
    const float best = d0[first];
    const float worst = open ? INFINITY : d0[ef - 1];
    if (!(isfinite(best) && best <= worst)) break;
    const int node = i0[first];
    const int* row = a.nbr + static_cast<size_t>(node) * a.deg;
    const int nb0 = lane < a.deg ? __ldg(row + lane) : sent;
    const int nb1 = lane + 32 < a.deg ? __ldg(row + lane + 32) : sent;
    __syncwarp();
    if (lane == 0) {
      i0[first] = node | static_cast<int>(0x80000000u);
      ring[step % a.H] = node;
    }
    ++hops;
    __syncwarp();

    // candidates: not the sentinel, in neither the pool nor the ring
    const bool c0 = nb0 != sent && !seen(nb0, i0, a.efp, ring, a.hp);
    const bool c1 = nb1 != sent && !seen(nb1, i0, a.efp, ring, a.hp);
    const unsigned m0 = __ballot_sync(kFull, c0);
    const unsigned m1 = __ballot_sync(kFull, c1);
    const int n0 = __popc(m0), n = n0 + __popc(m1);
    if (c0) cid[__popc(m0 & lt)] = nb0;
    if (c1) cid[n0 + __popc(m1 & lt)] = nb1;
    __syncwarp();
    if (n == 0) continue;

    // tombstones and the filter, read beside the vectors
    bool drop[kMaxDeg / 32];
#pragma unroll
    for (int t = 0; t < kMaxDeg / 32; ++t) {
      const int j = lane + 32 * t;
      drop[t] = true;
      if (j < n) {
        const int id = cid[j];
        drop[t] = a.deleted[id] != 0 ||
                  (a.allowed != nullptr && a.allowed[id] == 0);
      }
    }
    score_rows<M, V4>(a, qs, cid, csc, n, lane);
    __syncwarp();
    int fresh = 0;
#pragma unroll
    for (int t = 0; t < kMaxDeg / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < n && drop[t]) csc[j] = INFINITY;
      fresh += __popc(__ballot_sync(kFull, !drop[t]));
    }
    __syncwarp();
    evals += fresh;
    if (fresh == 0) continue;
    merge(pd[cur], pi[cur], pd[cur ^ 1], pi[cur ^ 1], cid, csc, n, ef, lane);
    cur ^= 1;
  }

  // deleted and disallowed entries out, the rest in order
  const float* d0 = pd[cur];
  const int* i0 = pi[cur];
  float* od = a.out_d + static_cast<size_t>(qi) * ef;
  int* oi = a.out_i + static_cast<size_t>(qi) * ef;
  int out = 0;
  for (int b = 0; b < ef; b += 32) {
    const int i = b + lane;
    bool keep = false;
    float s = INFINITY;
    int id = sent;
    if (i < ef) {
      s = d0[i];
      id = i0[i] & kMask;
      keep = !isinf(s) && a.deleted[id] == 0 &&
             (a.allowed == nullptr || a.allowed[id] != 0);
    }
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) {
      const int p = out + __popc(m & lt);
      od[p] = s;
      oi[p] = id;
    }
    out += __popc(m);
  }
  for (int i = out + lane; i < ef; i += 32) {
    od[i] = INFINITY;
    oi[i] = sent;
  }
  int* hist = a.hist + static_cast<size_t>(qi) * a.H;
  for (int i = lane; i < a.H; i += 32) hist[i] = ring[i];
  if (lane == 0) {
    a.hops[qi] = hops;
    a.evals[qi] = evals;
  }
}

template <int M, bool V4>
int launch(const Args& a, int warps, int smem, cudaStream_t st) {
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_kernel<M, V4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (a.Q + warps - 1) / warps;
  beam_kernel<M, V4><<<grid, warps * 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_vec(const Args& a, int vec4, int warps, int smem,
               cudaStream_t st) {
  return vec4 ? launch<M, true>(a, warps, smem, st)
              : launch<M, false>(a, warps, smem, st);
}

}  // namespace

// The level-0 beam of Q queries. metric: 0 L2, 1 L1, 2 IP (cosine on
// normalised rows). vec4: d % 4 == 0 and q, vectors 16-byte aligned. q [Q,
// d] f32; seeds [Q, S] int32 ids (the sentinel allowed); vectors [cap + 1,
// d] f32; nbr [cap + 1, deg] int32; deleted, allowed (or null) [cap + 1]
// bytes; sent = cap; ef in [1, 256]; deg in [1, 64]; H ring slots; steps at
// most max_steps. Out: out_d, out_i [Q, ef]; hist [Q, H]; hops, evals [Q]
// int32. Returns a cudaError_t.
extern "C" int beam_level0_launch(int metric, int vec4, const float* q,
                                  const int* seeds, const float* vectors,
                                  const int* nbr, const uint8_t* deleted,
                                  const uint8_t* allowed, float* out_d,
                                  int* out_i, int* hist, int* hops,
                                  int* evals, int Q, int S, int d, int deg,
                                  int ef, int H, int max_steps, int sent,
                                  void* stream) {
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  if (Q < 0 || S < 0 || d < 1 || deg < 1 || deg > kMaxDeg || ef < 1 ||
      ef > kMaxEF || H < 1 || max_steps < 0 || sent < 0 || metric < kL2 ||
      metric > kIP)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.seeds = seeds;
  a.vec = vectors;
  a.nbr = nbr;
  a.deleted = deleted;
  a.allowed = allowed;
  a.out_d = out_d;
  a.out_i = out_i;
  a.hist = hist;
  a.hops = hops;
  a.evals = evals;
  a.Q = Q;
  a.S = S;
  a.d = d;
  a.deg = deg;
  a.ef = ef;
  a.H = H;
  a.max_steps = max_steps;
  a.sent = sent;
  a.qw = (d + 3) & ~3;
  a.efp = (ef + 3) & ~3;
  a.hp = (H + 3) & ~3;
  a.warp_words = a.qw + 4 * a.efp + a.hp + 2 * kMaxDeg;
  const long long per_warp = 4ll * a.warp_words;
  if (per_warp > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(
      per_warp * kWarps <= kSmemMax ? kWarps : kSmemMax / per_warp);
  const int smem = static_cast<int>(per_warp * warps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2: return launch_vec<kL2>(a, vec4, warps, smem, st);
    case kL1: return launch_vec<kL1>(a, vec4, warps, smem, st);
    default: return launch_vec<kIP>(a, vec4, warps, smem, st);
  }
}
