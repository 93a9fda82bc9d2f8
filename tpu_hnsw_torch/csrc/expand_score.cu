// Fused block-expansion scoring for Hopper (sm_90a).
//
// Replaces: tpu_hnsw/ops/pallas_expand.py::expand_score (Pallas body
// _mk_kernel) and the XLA stage-1 einsums it stood beside in
// tpu_hnsw/index/block.py (_expand_blocks_body, block.py:127-130; the bf16
// and int8 stage 1 of _expand_blocks_2stage_body, block.py:189-200).
//
// What it computes: for query q and each of its p selected blocks
// b = bids[q, j], the score of every row s of block b,
//   L2:      max(q_sq[q] + blocks_sq[b, s] - 2 * dot, 0)
//   IP/cos:  -dot
//   +inf where block_ids[b, s] < 0 (dead or pad row) or, when the filter
//   mask is given, where allowed[b, s] is false (block.py:135-138, 205-209),
// written to out[q, j, s]. dot is
//   f32 rows:  f32 row . f32 query, f32 accumulation;
//   bf16 rows: bf16 row . bf16-rounded query, f32 accumulation;
//   int8 rows: int32 dp4a dot of the int8 row with the int8 query,
//              dequantised by q_scale[q] * score_scale[b].
//
// What bounds it: bytes. Each (query, probe) pair reads one block of S rows
// once, S * row_bytes (32 KB for int8 at S=256, d=128) for S outputs, with
// one multiply-add per byte or less: far below the card's compute-per-byte
// line, so device-memory bandwidth is the ceiling.
//
// What the design does about it: one CTA per (query, probe) pair. The CTA
// stages its query row in shared memory once, then its warps stream the
// block's rows with 16-byte read-only loads: a row is split across L lanes
// (L = 8 for int8 d=128), neighbouring lanes read neighbouring 16-byte
// chunks, and the L lanes of a row meet in a __shfl_xor_sync reduction.
// Every byte read is a candidate scored and only the [Q, p, S] scores are
// written. Block offsets are 64-bit (B * S * row_bytes passes 2^31 at
// large shard sizes). A fused top-r, TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int MODE>
using acc_t = typename std::conditional<MODE == kI8, int, float>::type;

// One 32-bit word of a row against the same word of the query.
template <int MODE>
__device__ __forceinline__ acc_t<MODE> word_dot(acc_t<MODE> acc, uint32_t x,
                                                uint32_t q) {
  if constexpr (MODE == kF32) {
    return fmaf(__uint_as_float(x), __uint_as_float(q), acc);
  } else if constexpr (MODE == kBF16) {
    // two bf16 per word, element 0 in the low half; bf16 -> f32 is a shift
    acc = fmaf(__uint_as_float(x << 16), __uint_as_float(q << 16), acc);
    return fmaf(__uint_as_float(x & 0xffff0000u),
                __uint_as_float(q & 0xffff0000u), acc);
  } else {
    return __dp4a(static_cast<int>(x), static_cast<int>(q), acc);
  }
}

// Chunk c of a row (WORDS 32-bit words: 16 bytes when WORDS == 4).
template <int MODE, int WORDS>
__device__ __forceinline__ acc_t<MODE> chunk_dot(acc_t<MODE> acc,
                                                 const uint8_t* row,
                                                 const uint32_t* qs, int c) {
  if constexpr (WORDS == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + c);
    const uint4 q = reinterpret_cast<const uint4*>(qs)[c];
    acc = word_dot<MODE>(acc, x.x, q.x);
    acc = word_dot<MODE>(acc, x.y, q.y);
    acc = word_dot<MODE>(acc, x.z, q.z);
    return word_dot<MODE>(acc, x.w, q.w);
  } else {
    const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(row) + c);
    return word_dot<MODE>(acc, x, qs[c]);
  }
}

template <int MODE, int WORDS>
__global__ void __launch_bounds__(kThreads)
expand_score_kernel(const uint8_t* __restrict__ blocks,
                    const float* __restrict__ blocks_sq,
                    const int* __restrict__ block_ids,
                    const bool* __restrict__ allowed,
                    const uint8_t* __restrict__ q,
                    const float* __restrict__ q_sq,
                    const long long* __restrict__ bids,
                    const float* __restrict__ q_scale,
                    const float* __restrict__ score_scale,
                    float* __restrict__ out, long long n_blocks, int p, int S,
                    int row_bytes, int l2, int lanes_per_row) {
  extern __shared__ uint4 q_smem[];  // 16-byte aligned query row
  uint32_t* qs = reinterpret_cast<uint32_t*>(q_smem);

  const long long pair = blockIdx.x;  // (query, probe) pair, row-major
  const int qi = static_cast<int>(pair / p);
  const long long bid = bids[pair];
  float* o = out + pair * S;
  if (bid < 0 || bid >= n_blocks) {  // out-of-range block id: no row scores
    for (int s = threadIdx.x; s < S; s += blockDim.x) o[s] = INFINITY;
    return;
  }

  const int nwords = row_bytes / 4;
  const uint32_t* qg =
      reinterpret_cast<const uint32_t*>(q + static_cast<long long>(qi) * row_bytes);
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) qs[w] = qg[w];
  __syncthreads();

  const int L = lanes_per_row;  // power of two, <= 32
  const int lane = threadIdx.x & 31;
  const int sub = lane / L;     // which row of the warp's group
  const int lig = lane % L;     // lane within the row
  const int rows_per_warp = 32 / L;
  const int step = (blockDim.x >> 5) * rows_per_warp;
  const int nchunks = nwords / WORDS;
  const long long slot0 = bid * S;
  const uint8_t* blk = blocks + slot0 * row_bytes;
  const float qsq = q_sq[qi];
  float scl = 1.0f;
  if constexpr (MODE == kI8) scl = __fmul_rn(q_scale[qi], score_scale[bid]);

  for (int r0 = (threadIdx.x >> 5) * rows_per_warp; r0 < S; r0 += step) {
    const int row = r0 + sub;
    acc_t<MODE> acc = 0;
    if (row < S) {
      const uint8_t* rp = blk + static_cast<long long>(row) * row_bytes;
      for (int c = lig; c < nchunks; c += L)
        acc = chunk_dot<MODE, WORDS>(acc, rp, qs, c);
    }
    // r0 is warp-uniform, so every lane of the warp reaches the shuffles
    for (int off = L >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row < S && lig == 0) {
      float dot;
      if constexpr (MODE == kI8) {
        dot = __fmul_rn(__int2float_rn(acc), scl);
      } else {
        dot = acc;
      }
      float sc;
      if (block_ids[slot0 + row] < 0 ||
          (allowed != nullptr && !allowed[slot0 + row])) {
        sc = INFINITY;
      } else if (l2) {
        // (q_sq + x_sq) - 2 dot, rounded op by op like the reference
        sc = fmaxf(__fsub_rn(__fadd_rn(qsq, blocks_sq[slot0 + row]),
                             __fmul_rn(2.0f, dot)),
                   0.0f);
      } else {
        sc = -dot;
      }
      o[row] = sc;
    }
  }
}

template <int MODE, int WORDS>
cudaError_t launch(const void* blocks, const float* blocks_sq,
                   const int* block_ids, const bool* allowed, const void* q,
                   const float* q_sq,
                   const long long* bids, const float* q_scale,
                   const float* score_scale, float* out, long long n_blocks,
                   int Q, int p, int S, int row_bytes, int l2,
                   int lanes_per_row, cudaStream_t stream) {
  auto kernel = expand_score_kernel<MODE, WORDS>;
  if (row_bytes > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, row_bytes);
    if (err != cudaSuccess) return err;
  }
  const long long pairs = static_cast<long long>(Q) * p;
  kernel<<<static_cast<unsigned int>(pairs), kThreads, row_bytes, stream>>>(
      static_cast<const uint8_t*>(blocks), blocks_sq, block_ids, allowed,
      static_cast<const uint8_t*>(q), q_sq, bids, q_scale, score_scale, out,
      n_blocks, p, S, row_bytes, l2, lanes_per_row);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 f32, 1 bf16, 2 int8. words_per_chunk: 4 (16-byte loads; rows and
// base 16-byte aligned) or 1 (4-byte loads). allowed: [B, S] bool filter
// mask, or null for none. Returns a cudaError_t.
extern "C" int expand_score_launch(
    int mode, int words_per_chunk, const void* blocks, const float* blocks_sq,
    const int* block_ids, const bool* allowed, const void* q,
    const float* q_sq,
    const long long* bids, const float* q_scale, const float* score_scale,
    float* out, long long n_blocks, int Q, int p, int S, int row_bytes,
    int l2, int lanes_per_row, void* stream) {
  if (static_cast<long long>(Q) * p == 0 || S == 0) return cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EXPAND_LAUNCH(M, W)                                                   \
  launch<M, W>(blocks, blocks_sq, block_ids, allowed, q, q_sq, bids, q_scale, \
               score_scale, out, n_blocks, Q, p, S, row_bytes, l2,            \
               lanes_per_row, st)
  cudaError_t err;
  if (words_per_chunk == 4) {
    if (mode == kF32) err = EXPAND_LAUNCH(kF32, 4);
    else if (mode == kBF16) err = EXPAND_LAUNCH(kBF16, 4);
    else if (mode == kI8) err = EXPAND_LAUNCH(kI8, 4);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else if (words_per_chunk == 1) {
    if (mode == kF32) err = EXPAND_LAUNCH(kF32, 1);
    else if (mode == kBF16) err = EXPAND_LAUNCH(kBF16, 1);
    else if (mode == kI8) err = EXPAND_LAUNCH(kI8, 1);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EXPAND_LAUNCH
  return static_cast<int>(err);
}
