// Native IO for tpu_hnsw_torch: mmap'd TEXMEX (fvecs/bvecs/ivecs) parsing,
// raw array blob IO, multithreaded, and the greedy capacity-balanced block
// assignment. A copy of tpu_hnsw/cpp/io_native.cpp: the two packages build
// and load their own libraries.
//
// This is the host-side data path (dataset parsing, index snapshot IO),
// where Python overhead would dominate at 100M-row scale. Compute stays in
// torch and the CUDA kernels of csrc/; this file is IO only.
//
// Build: g++ -O3 -shared -fPIC -o io_native.so io_native.cpp -lpthread
// (tpu_hnsw_torch/io/native.py does this at first use, into
// tpu_hnsw_torch/_build/) and bound via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>
#include <algorithm>

extern "C" {

// Parse .fvecs (each row: int32 dim, float32[dim]) from `path` into `out`
// (caller-allocated, rows*dim floats). Returns rows parsed, or -1 on error.
// `expected_dim` 0 = take from file. Multithreaded repack over mmap.
long fvecs_read(const char* path, float* out, long max_rows, int expected_dim,
                int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  size_t size = (size_t)st.st_size;
  if (size < 4) { close(fd); return -1; }
  const uint8_t* base =
      (const uint8_t*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;

  int32_t dim;
  memcpy(&dim, base, 4);
  if (dim <= 0 || (expected_dim && dim != expected_dim)) {
    munmap((void*)base, size);
    return -1;
  }
  size_t row_bytes = 4 + (size_t)dim * 4;
  long rows = (long)(size / row_bytes);
  if (max_rows > 0 && rows > max_rows) rows = max_rows;

  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  long per = (rows + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) {
    long lo = t * per, hi = lo + per > rows ? rows : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (long r = lo; r < hi; ++r) {
        memcpy(out + (size_t)r * dim, base + (size_t)r * row_bytes + 4,
               (size_t)dim * 4);
      }
    });
  }
  for (auto& t : ts) t.join();
  munmap((void*)base, size);
  return rows;
}

// Peek (rows, dim) of an fvecs file. Returns 0 on success.
int fvecs_shape(const char* path, long* rows, int* dim) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  int32_t d;
  if (read(fd, &d, 4) != 4) { close(fd); return -1; }
  close(fd);
  if (d <= 0) return -1;
  *dim = d;
  *rows = (long)(st.st_size / (4 + (size_t)d * 4));
  return 0;
}

// Parse .bvecs (int32 dim, uint8[dim]) into float32 out.
long bvecs_read(const char* path, float* out, long max_rows, int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  size_t size = (size_t)st.st_size;
  const uint8_t* base =
      (const uint8_t*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;
  int32_t dim;
  memcpy(&dim, base, 4);
  if (dim <= 0) { munmap((void*)base, size); return -1; }
  size_t row_bytes = 4 + (size_t)dim;
  long rows = (long)(size / row_bytes);
  if (max_rows > 0 && rows > max_rows) rows = max_rows;
  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  long per = (rows + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) {
    long lo = t * per, hi = lo + per > rows ? rows : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (long r = lo; r < hi; ++r) {
        const uint8_t* src = base + (size_t)r * row_bytes + 4;
        float* dst = out + (size_t)r * dim;
        for (int j = 0; j < dim; ++j) dst[j] = (float)src[j];
      }
    });
  }
  for (auto& t : ts) t.join();
  munmap((void*)base, size);
  return rows;
}

// Raw blob write/read (index snapshot arrays), multithreaded pwrite/pread.
long blob_write(const char* path, const uint8_t* data, long nbytes,
                int n_threads) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (ftruncate(fd, nbytes) != 0) { close(fd); return -1; }
  if (n_threads < 1) n_threads = 4;
  long per = (nbytes + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  bool ok = true;
  for (int t = 0; t < n_threads; ++t) {
    long lo = t * per, hi = lo + per > nbytes ? nbytes : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([=, &ok]() {
      long off = lo;
      while (off < hi) {
        ssize_t w = pwrite(fd, data + off, (size_t)(hi - off), off);
        if (w <= 0) { ok = false; return; }
        off += w;
      }
    });
  }
  for (auto& t : ts) t.join();
  close(fd);
  return ok ? nbytes : -1;
}

long blob_read(const char* path, uint8_t* data, long nbytes, int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  if (n_threads < 1) n_threads = 4;
  long per = (nbytes + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  bool ok = true;
  for (int t = 0; t < n_threads; ++t) {
    long lo = t * per, hi = lo + per > nbytes ? nbytes : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([=, &ok]() {
      long off = lo;
      while (off < hi) {
        ssize_t r = pread(fd, data + off, (size_t)(hi - off), off);
        if (r <= 0) { ok = false; return; }
        off += r;
      }
    });
  }
  for (auto& t : ts) t.join();
  close(fd);
  return ok ? nbytes : -1;
}

// ---------------------------------------------------------------------------
// Capacity-balanced greedy block assignment (the host stage of
// tpu_hnsw/index/block.py _balanced_assign; the port's build assigns on the
// device instead). Round r takes, for every block, its closest
// still-unassigned r-th-choice points up to remaining capacity. A numpy
// version lexsorts the full pending set per round; this native pass is
// O(n + B) per round: counting-sort claimants by block, then per overfull
// block an nth_element partition at the remaining capacity — the taken SET
// only needs the cap smallest by (dist, row), not a full ordering. The
// (dist, row) comparator is a strict total order, so the taken set (and
// therefore the whole assignment) is deterministic.
//
// cand_i [n, t] int32 (top-t block choices per row, nearest first)
// cand_d [n, t] float32 (their distances)
// assign [n] int64 out, must be pre-filled with -1
// free_  [B] int64 inout, must be pre-filled with capacity S
// Returns number of rows assigned (rows left at -1 exhausted all t choices).
long balanced_assign_greedy(const int32_t* cand_i, const float* cand_d,
                            long n, int t, long n_blocks,
                            int64_t* assign, int64_t* free_) {
  std::vector<long> pending(n);
  for (long i = 0; i < n; ++i) pending[i] = i;
  struct Item { float d; long row; };
  std::vector<Item> items(n);
  std::vector<long> offsets((size_t)n_blocks + 1);
  std::vector<uint8_t> still_pending(n);
  long assigned = 0;
  auto cmp = [](const Item& a, const Item& b) {
    if (a.d != b.d) return a.d < b.d;
    return a.row < b.row;  // deterministic tie-break
  };
  for (int r = 0; r < t && !pending.empty(); ++r) {
    // counting sort of this round's claims by block id
    std::fill(offsets.begin(), offsets.end(), 0);
    for (long p : pending) {
      int32_t b = cand_i[(size_t)p * t + r];
      if (b >= 0 && b < n_blocks) ++offsets[(size_t)b + 1];
    }
    for (long b = 0; b < n_blocks; ++b) offsets[b + 1] += offsets[b];
    std::vector<long> cursor(offsets.begin(), offsets.end() - 1);
    std::fill(still_pending.begin(), still_pending.begin() + n, 0);
    for (long p : pending) {
      int32_t b = cand_i[(size_t)p * t + r];
      if (b < 0 || b >= n_blocks) {
        // invalid r-th candidate: the row keeps its remaining rounds
        // (matches the numpy fallback, which never drops pending rows)
        still_pending[p] = 1;
        continue;
      }
      items[cursor[b]++] = {cand_d[(size_t)p * t + r], p};
    }
    for (long b = 0; b < n_blocks; ++b) {
      long lo = offsets[b], hi = offsets[b + 1];
      if (lo == hi) continue;
      int64_t cap = free_[b];
      long len = hi - lo;
      if (len <= cap) {
        for (long i = lo; i < hi; ++i) assign[items[i].row] = b;
        free_[b] -= len;
        assigned += len;
      } else {
        if (cap > 0) {
          std::nth_element(items.begin() + lo, items.begin() + lo + cap,
                           items.begin() + hi, cmp);
          for (long i = lo; i < lo + cap; ++i) assign[items[i].row] = b;
          free_[b] = 0;
          assigned += cap;
        }
        for (long i = lo + cap; i < hi; ++i) still_pending[items[i].row] = 1;
      }
    }
    // rebuild pending in ascending row order (deterministic)
    std::vector<long> next_pending;
    next_pending.reserve(pending.size());
    for (long p : pending)
      if (still_pending[p]) next_pending.push_back(p);
    std::sort(next_pending.begin(), next_pending.end());
    pending.swap(next_pending);
  }
  return assigned;
}


}  // extern "C"
