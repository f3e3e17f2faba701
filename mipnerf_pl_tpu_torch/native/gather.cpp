// Host-side batch gather of the training sampler (native/gather.py).
//
// Every training step gathers the same B random rows from each of the 8
// flattened ray / pixel arrays.  numpy fancy indexing does that one array
// at a time: 8 passes over the index vector.  gather_multi_rows makes one
// pass and copies every field's row while the index is at hand, split
// over threads for large batches.  A row is a run of bytes, so fields of
// any element type go through the one pass.
//
// Plain C interface, loaded with ctypes; gather.py builds it with
//   g++ -O3 -shared -fPIC -std=c++17 -pthread
// into mipnerf_pl_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run work(lo, hi) over [0, n), on n_threads threads where n is large.
template <typename Work>
void split(int64_t n, int n_threads, const Work& work) {
  if (n_threads <= 1 || n < 4096) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// The same rows of n_fields row-major arrays, a row of field f being
// row_bytes[f] bytes: dsts[f][i, :] = srcs[f][idx[i], :], one pass over idx.
void gather_multi_rows(const char** srcs, char** dsts,
                       const int64_t* row_bytes, int64_t n_fields,
                       const int64_t* idx, int64_t n_idx, int n_threads) {
  split(n_idx, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t r = idx[i];
      for (int64_t f = 0; f < n_fields; ++f) {
        const int64_t w = row_bytes[f];
        std::memcpy(dsts[f] + i * w, srcs[f] + r * w, w);
      }
    }
  });
}

}  // extern "C"
