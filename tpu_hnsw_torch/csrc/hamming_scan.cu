// Hamming and jaccard scans over packed bits on Hopper's tensor cores
// (sm_90a): all pairs, or a fused top-k that writes no [Q, N] matrix.
//
// Replaces: tpu_hnsw/ops/pallas_hamming.py::hamming_scan (Pallas body
// _kernel; wrapper hamming_scan_auto), the exact scan of BinaryFlatIndex
// (tpu_hnsw/ops/bitops.py:74-91), and the top_k that follows it there.
//
// What it computes: for q < Q, n < N over packed 32-bit words (bit j of
// word w is bit 32w + j), and_cnt[q, n] = sum over w of popcount(q & x),
// then h = |q| + |x| - 2 and_cnt from the row popcounts (given for the
// top-k, counted from the staged words for all pairs).
//   hamming_scan_launch: out[q, n] = h, int32 (the TPU kernel's contract).
//   hamming_topk_launch: per CTA and query, the k smallest keys
//     (distance f32 bits << 32 | row id) of the rows the CTA covers, where
//     distance is h (hamming) or 1 - inter / max(union, 1) (jaccard, IEEE
//     f32 through __fdiv_rn / __fsub_rn, as the reference divides). The
//     wrapper merges the [Q, splits * k] candidates by key, so ties order
//     by row id, as lax.top_k(-d) does.
//
// What bounds it: the bit products. At Q = 1024, N = 1M, 1536 bits that is
// 1.57e12 products; counted as int8 MACs on the tensor cores, 3.15e12 ops
// at the data sheet's 1,979 TOP/s: 1.59 ms. The packed table (192 MB) is
// 0.06 ms of HBM; the all-pairs output (4 GB of int32) 1.22 ms.
//
// What the design does about it: the products run on the tensor cores as
// mma.sync.m16n8k256 .b1 .and.popc on the packed words as they are: one
// instruction ANDs and counts 16 x 8 x 256 bit pairs, and the table is read
// once per query tile at 1 bit per bit. (Spreading each word to 32 bytes of
// 0/1 for mma.m16n8k32 .u8 ran slower on the H100; PERF.md.) A CTA of 4
// warps takes a tile of 64 queries x 128 rows; every warp holds all 64
// queries against its own 32 rows as 16 m16n8 fragments of int32 sums. The
// words reach shared memory in chunks of 32 a row with 16-byte loads
// (W % 4 == 0, both tables aligned), else 16 a row with 4-byte loads; the
// next chunk is loaded into registers while the tensor cores work on this
// one. Ragged Q, N and W are zero-filled there, which adds nothing to a
// count, and k-steps past W are skipped. Operands are read with ldmatrix.
//
// Each CTA walks a contiguous range of row tiles (about four CTAs per SM
// over the card), so the top-k keeps one running list per query in shared
// memory: a candidate enters a 64-slot staging list only when it beats the
// query's k-th key (a cheap integer test; jaccard divides only near the
// k-th distance), and when a staging list overflows the warps merge the
// staged keys into the sorted lists (each staged key ranked against the
// others, then against the list). Each metric is its own kernel instance.
// Nothing of size [Q, N] reaches device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBQ = 64;             // queries per CTA tile: 4 m16 fragments
constexpr int kWarps = 4;           // each warp: kBQ queries x 32 rows
constexpr int kBN = kWarps * 32;    // rows per CTA tile
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ + kBN;    // staged rows per chunk
constexpr int kSC = 64;             // staging slots per query (top-k)
constexpr int kMaxK = 128;          // list capacity a warp merges
constexpr u64 kMaxKey = 0x7fffffffffffffffULL;  // above every real key
constexpr int kRS = 32 * 4 + 16;    // smem row stride: ldmatrix conflict-free

// c += popcount(a & b) over 256 bits: A 16 x 256 (row), B 256 x 8 (col).
__device__ __forceinline__ void mma_and_popc(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One chunk (kCW words) of the kBQ query rows and kBN base rows, through
// registers into shared memory; rows or words past the end are zero.
// 4-byte loads take half the chunk, so the prefetch fits in registers.
template <int VEC>
struct Loader {
  static constexpr int kCW = VEC == 4 ? 32 : 16;             // words a row
  static constexpr int kPerRow = kCW / VEC;                  // items a row
  static constexpr int kItems = kRows * kPerRow / kThreads;  // a thread
  static_assert(kRows * kPerRow % kThreads == 0, "items");
  uint32_t v[kItems][VEC];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ q,
                                       const uint32_t* __restrict__ x,
                                       int q0, int Q, long long n0,
                                       long long N, int W, int w0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kPerRow;
      const int w = w0 + (idx % kPerRow) * VEC;
      const uint32_t* src;
      bool ok = w < W;  // VEC = 4 only when W % 4 == 0
      if (row < kBQ) {
        ok = ok && q0 + row < Q;
        src = q + static_cast<long long>(q0 + row) * W + w;
      } else {
        const long long n = n0 + (row - kBQ);
        ok = ok && n < N;
        src = x + n * W + w;
      }
      if constexpr (VEC == 4) {
        uint4 t = make_uint4(0u, 0u, 0u, 0u);
        if (ok) t = __ldg(reinterpret_cast<const uint4*>(src));
        v[i][0] = t.x; v[i][1] = t.y; v[i][2] = t.z; v[i][3] = t.w;
      } else {
        v[i][0] = ok ? __ldg(src) : 0u;
      }
    }
  }

  __device__ __forceinline__ void store(char* sop) const {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kPerRow;
      const int part = idx % kPerRow;
      char* dst = sop + row * kRS + part * VEC * 4;
      if constexpr (VEC == 4)
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
      else
        *reinterpret_cast<uint32_t*>(dst) = v[i][0];
    }
  }

  // The chunk's bits per row into spop (set on the first chunk, added on
  // the others): a row's items sit on kPerRow neighbouring lanes.
  __device__ __forceinline__ void pop(int* spop, bool first) const {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      int c = 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) c += __popc(v[i][j]);
#pragma unroll
      for (int o = kPerRow / 2; o > 0; o >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, o);
      if (idx % kPerRow == 0) {
        const int row = idx / kPerRow;
        spop[row] = first ? c : spop[row] + c;
      }
    }
  }
};

// The running top-k of a CTA: per query a sorted list of up to k keys, a
// staging list, and the key a candidate must beat (kMaxKey until full).
struct TopK {
  u64* list;   // [kBQ][k]
  u64* stage;  // [kBQ][kSC]
  u64* thr;    // [kBQ]
  int* lcnt;   // [kBQ]
  int* scnt;   // [kBQ]
  int k;
};

__device__ __forceinline__ u64 make_key(float d, long long n) {
  return (static_cast<u64>(__float_as_uint(d)) << 32) |
         static_cast<u64>(static_cast<uint32_t>(n));
}

// Jaccard's 1 - inter / max(union, 1) as the reference rounds it; out of
// line, so the rare division keeps its registers out of the scan's loop.
__device__ __noinline__ float jaccard_distance(int a, int pq, int px) {
  const int uni = max(pq + px - a, 1);
  return __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(a),
                                   static_cast<float>(uni)));
}

__device__ __forceinline__ float distance(int a, int pq, int px,
                                          bool jaccard) {
  return jaccard ? jaccard_distance(a, pq, px)
                 : static_cast<float>(pq + px - 2 * a);
}

// Merge query r's c staged keys (1 <= c <= kSC) into its list; one warp.
__device__ void merge_query(const TopK& t, int r, int c, int lane) {
  constexpr int kPer = kSC / 32;  // staged keys a lane
  u64* L = t.list + r * t.k;
  u64* S = t.stage + r * kSC;
  const int len = t.lcnt[r];
  // sort the staged keys in place: each key's rank among them (keys are
  // unique), counted against every staged key at once
  u64 sv[kPer];
  int rs[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    sv[p] = lane + 32 * p < c ? S[lane + 32 * p] : kMaxKey;
    rs[p] = 0;
  }
  for (int j = 0; j < c; ++j) {
    const u64 o = S[j];
#pragma unroll
    for (int p = 0; p < kPer; ++p) rs[p] += o < sv[p];
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    if (lane + 32 * p < c) S[rs[p]] = sv[p];
  __syncwarp();
  // new rank of a staged key: its rank among staged + the list keys below
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    int lo = 0, hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (L[mid] < sv[p]) lo = mid + 1; else hi = mid;
    }
    rs[p] += lo;
  }
  u64 lv[kMaxK / 32];
  int rl[kMaxK / 32];
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int i = lane + 32 * j;
    rl[j] = t.k;  // dropped
    if (i < len) {
      lv[j] = L[i];
      int a = 0, b = c;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (S[mid] < lv[j]) a = mid + 1; else b = mid;
      }
      rl[j] = i + a;
    }
  }
  __syncwarp();  // every read of L before any write
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    if (lane + 32 * p < c && rs[p] < t.k) L[rs[p]] = sv[p];
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j)
    if (rl[j] < t.k) L[rl[j]] = lv[j];
  __syncwarp();
  if (lane == 0) {
    const int nl = min(len + c, t.k);
    t.lcnt[r] = nl;
    t.thr[r] = nl == t.k ? L[t.k - 1] : kMaxKey;
    t.scnt[r] = 0;
  }
  __syncwarp();
}

// Merge every query with at least min_c staged keys; one warp a query.
__device__ __forceinline__ void merge_all(const TopK& t, int min_c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kBQ; r += kWarps) {
    const int c = t.scnt[r];
    if (c >= min_c) merge_query(t, r, min(c, kSC), lane);
  }
}

__device__ __forceinline__ void stage_key(const TopK& t, int r, u64 key,
                                          u64& pend, int bit) {
  const int slot = atomicAdd(&t.scnt[r], 1);
  if (slot < kSC) t.stage[r * kSC + slot] = key;
  else pend |= 1ull << bit;
}

// What a kernel instance writes: all pairs, or the top-k by one metric.
enum Mode { kAllPairs, kHammingTopK, kJaccardTopK };

template <int VEC, int kMode>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
            const int* __restrict__ pop_q, const int* __restrict__ pop_x,
            int Q, long long N, int W, long long rows_per_split, int nsplit,
            int* __restrict__ out, u64* __restrict__ cand, int k) {
  constexpr bool kTopK = kMode != kAllPairs;
  constexpr bool jac = kMode == kJaccardTopK;
  extern __shared__ __align__(16) char smem[];
  char* sop = smem;
  int* spop = reinterpret_cast<int*>(smem + kRows * kRS);
  TopK t;
  t.k = k;
  t.list = reinterpret_cast<u64*>(spop + kRows);
  t.stage = t.list + kBQ * k;
  t.thr = t.stage + kBQ * kSC;
  t.lcnt = reinterpret_cast<int*>(t.thr + kBQ);
  t.scnt = t.lcnt + kBQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const long long r0 = static_cast<long long>(split) * rows_per_split;
  const long long r1 = min(N, r0 + rows_per_split);
  const int ntiles =
      r1 > r0 ? static_cast<int>((r1 - r0 + kBN - 1) / kBN) : 0;
  constexpr int kCW = Loader<VEC>::kCW;
  const int nchunks = (W + kCW - 1) / kCW;
  const int steps = ntiles * nchunks;

  if (kTopK) {
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      t.thr[r] = kMaxKey;
      t.lcnt[r] = 0;
      t.scnt[r] = 0;
    }
  }

  Loader<VEC> ld;
  if (steps > 0) ld.load(q, x, q0, Q, r0, r1, W, 0);
  int acc[4][4][4];

  for (int s = 0; s < steps; ++s) {
    const int tile = s / nchunks, ch = s - tile * nchunks;
    const long long n0 = r0 + static_cast<long long>(tile) * kBN;
    __syncthreads();  // the last chunk's operands and pops are consumed
    ld.store(sop);
    if (!kTopK) {
      ld.pop(spop, ch == 0);
    } else if (ch == 0) {
      for (int i = threadIdx.x; i < kRows; i += kThreads) {
        if (i < kBQ) {
          spop[i] = q0 + i < Q ? pop_q[q0 + i] : 0;
        } else {
          const long long n = n0 + (i - kBQ);
          spop[i] = n < r1 ? pop_x[n] : 0;
        }
      }
    }
    __syncthreads();
    if (s + 1 < steps) {
      const int t2 = (s + 1) / nchunks, c2 = s + 1 - t2 * nchunks;
      ld.load(q, x, q0, Q, r0 + static_cast<long long>(t2) * kBN, r1, W,
              c2 * kCW);
    }
    if (ch == 0) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0;
    }
    // k-steps holding words below W (the last chunk may hold fewer)
    const int ksteps = (min(kCW, W - ch * kCW) + 7) / 8;
#pragma unroll
    for (int ks = 0; ks < kCW / 8; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], sop + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kRS + ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldsm_x4(b[nb], sop + (kBQ + warp * 32 + nb * 16 + (lane & 7) +
                              (lane >> 4) * 8) * kRS +
                           ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_and_popc(acc[mi][nj], a[mi], b[nj >> 1][(nj & 1) * 2],
                       b[nj >> 1][(nj & 1) * 2 + 1]);
    }
    if (ch != nchunks - 1) continue;

    // ---- epilogue: acc[mi][nj][c] is query row mi*16 + g + 8*(c>>1),
    //      base row warp*32 + nj*8 + 2*tg + (c&1) of the tile
    if (!kTopK) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mi * 16 + g + 8 * h;
          if (q0 + r >= Q) continue;
          const int pq = spop[r];
          int* orow = out + static_cast<long long>(q0 + r) * N;
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            const int col = warp * 32 + nj * 8 + 2 * tg;
            const long long n = n0 + col;
            const int v0 = pq + spop[kBQ + col] - 2 * acc[mi][nj][2 * h];
            const int v1 =
                pq + spop[kBQ + col + 1] - 2 * acc[mi][nj][2 * h + 1];
            if ((N & 1) == 0) {  // n even, N even: both or neither valid
              if (n < r1)
                *reinterpret_cast<int2*>(orow + n) = make_int2(v0, v1);
            } else {
              if (n < r1) orow[n] = v0;
              if (n + 1 < r1) orow[n + 1] = v1;
            }
          }
        }
      continue;
    }

    // top-k, first pass: the list's keys all come from earlier tiles, with
    // smaller ids, so a row of this tile beats the k-th key only with a
    // strictly smaller distance. Hamming compares px - 2a < d_k - pq.
    // Jaccard skips the division where a * 2^14 < lq * u with
    // u = pq + px - a, i.e. a/u below lq / 2^14 <= 1 - d_k - 1e-6, a margin
    // far above the division's rounding; rewritten as
    // a * (2^14 + lq) < lq * pq + lq * px, exact in 32 bits while rows hold
    // fewer than 2^16 bits (wider rows skip nothing).
    const bool narrow = W * 32 < 65536;
    int hl[4][2], pqr[4][2];
    float dk[4][2];
    unsigned lq[4][2], lqpq[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g + 8 * h;
        const u64 tk = t.thr[r];
        const float d = __uint_as_float(static_cast<uint32_t>(tk >> 32));
        pqr[mi][h] = spop[r];
        const bool full = tk != kMaxKey;
        const bool live = q0 + r < Q;
        hl[mi][h] = !live ? -0x7fffffff
                          : full ? static_cast<int>(d) - pqr[mi][h]
                                 : 0x7fffffff;
        dk[mi][h] = !live ? __int_as_float(0xff800000)
                          : full ? d : __int_as_float(0x7f800000);
        lq[mi][h] = !narrow ? 0u
                    : !live ? 16385u
                    : full ? static_cast<unsigned>(
                                 fmaxf(1.0f - d - 1e-6f, 0.0f) * 16384.0f)
                           : 0u;
        lqpq[mi][h] = lq[mi][h] * static_cast<unsigned>(pqr[mi][h]);
      }
    u64 pend = 0;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = warp * 32 + nj * 8 + 2 * tg + cc;
        const long long n = n0 + col;
        if (n >= r1) continue;
        const int px = spop[kBQ + col];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int a = acc[mi][nj][2 * h + cc];
            const int r = mi * 16 + g + 8 * h;
            const int bit = (mi * 2 + h) * 8 + nj * 2 + cc;
            if constexpr (!jac) {
              if (px - 2 * a < hl[mi][h])
                stage_key(t, r, make_key(static_cast<float>(
                    pqr[mi][h] + px - 2 * a), n), pend, bit);
            } else {
              if (static_cast<unsigned>(a) * (16384u + lq[mi][h]) >=
                  lq[mi][h] * static_cast<unsigned>(px) + lqpq[mi][h]) {
                const float d = distance(a, pqr[mi][h], px, true);
                if (d < dk[mi][h]) stage_key(t, r, make_key(d, n), pend, bit);
              }
            }
          }
      }
    // staging lists merge only when one overflows, and then all of them
    // (a round costs the CTA two barriers); the candidates that found
    // theirs full retry against the new k-th key (full key compare: ids of
    // this tile may be in the list now)
    while (__syncthreads_or(pend != 0)) {
      merge_all(t, 1);
      __syncthreads();
      u64 still = 0;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int bit = (mi * 2 + h) * 8 + nj * 2 + cc;
              if (!((pend >> bit) & 1)) continue;
              const int col = warp * 32 + nj * 8 + 2 * tg + cc;
              const int r = mi * 16 + g + 8 * h;
              const u64 key = make_key(
                  distance(acc[mi][nj][2 * h + cc], pqr[mi][h],
                           spop[kBQ + col], jac),
                  n0 + col);
              if (key < t.thr[r]) stage_key(t, r, key, still, bit);
            }
      pend = still;
    }
  }

  if (kTopK) {
    __syncthreads();
    merge_all(t, 1);  // what is still staged
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * k; i += kThreads) {
      const int r = i / k, j = i - r * k;
      if (q0 + r < Q)
        cand[(static_cast<long long>(q0 + r) * nsplit + split) * k + j] =
            j < t.lcnt[r] ? t.list[r * k + j] : kMaxKey;
    }
  }
}

int smem_bytes(bool topk, int k) {
  int b = kRows * kRS + kRows * 4;
  if (topk) b += kBQ * (k + kSC + 1) * 8 + 2 * kBQ * 4;
  return b;
}

template <int VEC, int kMode>
int launch(const void* q, const void* x, const void* pop_q,
           const void* pop_x, void* out, void* cand, int Q, long long N,
           int W, long long rows_per_split, int nsplit, int k,
           cudaStream_t st) {
  auto kern = scan_kernel<VEC, kMode>;
  const int bytes = smem_bytes(kMode != kAllPairs, k);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned int>(nsplit),
                  static_cast<unsigned int>((Q + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(x),
      static_cast<const int*>(pop_q), static_cast<const int*>(pop_x), Q, N,
      W, rows_per_split, nsplit, static_cast<int*>(out),
      static_cast<u64*>(cand), k);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int dispatch(const void* q, const void* x, const void* pop_q,
             const void* pop_x, void* out, void* cand, int Q, long long N,
             int W, long long rows_per_split, int nsplit, int k,
             void* stream) {
  if (Q == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (W <= 0 || nsplit <= 0 || rows_per_split <= 0 ||
      rows_per_split % kBN != 0 || (Q + kBQ - 1) / kBQ > 65535 ||
      (kMode != kAllPairs && (k < 1 || k > kMaxK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = W % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HS_ARGS q, x, pop_q, pop_x, out, cand, Q, N, W, rows_per_split, \
                nsplit, k, st
  return vec4 ? launch<4, kMode>(HS_ARGS) : launch<1, kMode>(HS_ARGS);
#undef HS_ARGS
}

}  // namespace

// q [Q, W], x [N, W] packed 32-bit words (row-major, contiguous). Rows are
// cut into nsplit ranges of rows_per_split (a multiple of 128), one CTA per
// range and 64-query tile. Each returns a cudaError_t.
//
// All pairs: out [Q, N] int32 hamming counts (row popcounts are counted
// from the staged words).
extern "C" int hamming_scan_launch(const void* q, const void* x, void* out,
                                   int Q, long long N, int W,
                                   long long rows_per_split, int nsplit,
                                   void* stream) {
  return dispatch<kAllPairs>(q, x, nullptr, nullptr, out, nullptr, Q, N, W,
                             rows_per_split, nsplit, 1, stream);
}

// Top-k: pop_q [Q], pop_x [N] int32 row popcounts; cand [Q, nsplit, k]
// uint64 keys (distance f32 bits << 32 | id), each range's k smallest
// ascending, padded with 2^63 - 1; 1 <= k <= 128; jaccard 0 (hamming) or 1.
extern "C" int hamming_topk_launch(const void* q, const void* x,
                                   const void* pop_q, const void* pop_x,
                                   void* cand, int Q, long long N, int W,
                                   long long rows_per_split, int nsplit,
                                   int k, int jaccard, void* stream) {
  if (jaccard != 0 && jaccard != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return jaccard ? dispatch<kJaccardTopK>(q, x, pop_q, pop_x, nullptr, cand,
                                          Q, N, W, rows_per_split, nsplit,
                                          k, stream)
                 : dispatch<kHammingTopK>(q, x, pop_q, pop_x, nullptr, cand,
                                          Q, N, W, rows_per_split, nsplit,
                                          k, stream);
}
