// All-pairs hamming distances over packed bits, for Hopper (sm_90a).
//
// Replaces: tpu_hnsw/ops/pallas_hamming.py::hamming_scan (Pallas body
// _kernel; wrapper hamming_scan_auto), the exact scan of BinaryFlatIndex
// (tpu_hnsw/ops/bitops.py:74-79).
//
// What it computes: out[q, n] = sum over w < W of popcount(qw[q, w] ^ x[n, w])
// for q < Q, n < N, over packed 32-bit words, as int32. Ragged Q and N are
// masked here; the wrapper pads nothing.
//
// What bounds it: the popcount rate. At Q = 1024, N = 1M, W = 48 (1536
// bits) that is 5.0e10 popcounts; at the data sheet's 16 popc/clk/SM x 132
// SMs that is roughly 10-15 ms, while the 4 GB int32 output is about 1.2 ms
// at 3.35 TB/s and the packed table 192 MB per query tile. Per popcount the
// loop issues one XOR, one POPC and one add; the query word comes from
// shared memory as a broadcast.
//
// What the design does about it: a CTA takes a tile of kTQ queries and
// kThreads base rows. The query tile is staged in shared memory kWC words
// at a time, so any W works (W = 2000, pgvector's widest bit index, too).
// Each thread owns one base row, reads it once per query tile with 16-byte
// loads when W % 4 == 0 (4-byte loads otherwise) and keeps kTQ int32 sums
// in registers; writes of out[q, n] are coalesced over n. A fused top-k (no
// [Q, N] output) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // base rows per CTA
constexpr int kTQ = 32;        // queries per CTA
constexpr int kWC = 64;        // query words staged per pass

template <int VEC>
__global__ void __launch_bounds__(kThreads)
hamming_scan_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ x, int* __restrict__ out,
                    int Q, long long N, int W) {
  __shared__ __align__(16) uint32_t qs[kTQ][kWC];
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int q0 = blockIdx.y * kTQ;
  const bool row_ok = n < N;
  const uint32_t* xr = x + (row_ok ? n : 0) * W;

  int acc[kTQ];
#pragma unroll
  for (int t = 0; t < kTQ; ++t) acc[t] = 0;

  for (int w0 = 0; w0 < W; w0 += kWC) {
    const int wc = min(kWC, W - w0);
    // stage queries [q0, q0 + kTQ) x words [w0, w0 + wc); rows past Q are 0
    for (int i = threadIdx.x; i < kTQ * kWC; i += kThreads) {
      const int t = i / kWC, w = i % kWC;
      qs[t][w] = (q0 + t < Q && w < wc)
                     ? q[static_cast<long long>(q0 + t) * W + w0 + w]
                     : 0u;
    }
    __syncthreads();
    if (row_ok) {
      if constexpr (VEC == 4) {
        for (int w = 0; w < wc; w += 4) {
          const uint4 xv = __ldg(reinterpret_cast<const uint4*>(xr + w0 + w));
#pragma unroll
          for (int t = 0; t < kTQ; ++t) {
            const uint4 qv = *reinterpret_cast<const uint4*>(&qs[t][w]);
            acc[t] += __popc(qv.x ^ xv.x) + __popc(qv.y ^ xv.y) +
                      __popc(qv.z ^ xv.z) + __popc(qv.w ^ xv.w);
          }
        }
      } else {
        for (int w = 0; w < wc; ++w) {
          const uint32_t xv = __ldg(xr + w0 + w);
#pragma unroll
          for (int t = 0; t < kTQ; ++t) acc[t] += __popc(qs[t][w] ^ xv);
        }
      }
    }
    __syncthreads();  // the next pass overwrites qs
  }
  if (!row_ok) return;
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
    if (q0 + t < Q) out[static_cast<long long>(q0 + t) * N + n] = acc[t];
}

}  // namespace

// q [Q, W], x [N, W] packed uint32 words (row-major, contiguous); out [Q, N]
// int32. vec: 4 (16-byte loads: W % 4 == 0 and x 16-byte aligned) or 1.
// Returns a cudaError_t.
extern "C" int hamming_scan_launch(int vec, const void* q, const void* x,
                                   void* out, int Q, long long N, int W,
                                   void* stream) {
  if (Q == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (W <= 0 || (vec != 1 && vec != 4) || (vec == 4 && W % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gx = (N + kThreads - 1) / kThreads;
  const int gy = (Q + kTQ - 1) / kTQ;
  if (gx > 0x7fffffffLL || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(gx), static_cast<unsigned int>(gy));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* qp = static_cast<const uint32_t*>(q);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  int* op = static_cast<int*>(out);
  if (vec == 4)
    hamming_scan_kernel<4><<<grid, kThreads, 0, st>>>(qp, xp, op, Q, N, W);
  else
    hamming_scan_kernel<1><<<grid, kThreads, 0, st>>>(qp, xp, op, Q, N, W);
  return static_cast<int>(cudaGetLastError());
}
