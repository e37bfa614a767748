// Native host-side data ops for elephas_tpu_torch (a copy of elephas_tpu's).
//
// The reference delegates its host data plane to Spark's JVM (SURVEY.md
// §2.4: the only native code it uses lives in dependencies). The TPU
// rebuild's host data plane is this small library: the per-epoch shuffle
// gather — the one host-side operation on the training hot path — done
// as a multi-threaded row gather over pinned numpy buffers, fusing the
// features and labels passes that numpy fancy-indexing would do
// separately (and single-threaded).
//
// Built lazily by elephas_tpu_torch/native/__init__.py:  g++ -O3 -shared -fPIC,
// into elephas_tpu_torch/_build/.
// ABI kept to plain C so ctypes can load it without pybind11.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dst[i, :] = src[perm[i], :] for two parallel arrays (features, labels).
// Any dtype: rows are copied as raw bytes (row_bytes = itemsize * row_elems).
void gather_rows2(const uint8_t* x_src, uint8_t* x_dst, int64_t x_row_bytes,
                  const uint8_t* y_src, uint8_t* y_dst, int64_t y_row_bytes,
                  const int64_t* perm, int64_t n_rows, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t j = perm[i];
      std::memcpy(x_dst + i * x_row_bytes, x_src + j * x_row_bytes,
                  static_cast<size_t>(x_row_bytes));
      if (y_src != nullptr) {
        std::memcpy(y_dst + i * y_row_bytes, y_src + j * y_row_bytes,
                    static_cast<size_t>(y_row_bytes));
      }
    }
  };
  if (n_threads == 1 || n_rows < 4096) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// One-hot encode integer class labels into a preallocated f32 matrix.
void encode_onehot(const int64_t* labels, float* out, int64_t n,
                   int64_t nb_classes) {
  std::memset(out, 0, static_cast<size_t>(n * nb_classes) * sizeof(float));
  for (int64_t i = 0; i < n; ++i) {
    const int64_t c = labels[i];
    if (c >= 0 && c < nb_classes) out[i * nb_classes + c] = 1.0f;
  }
}

}  // extern "C"
