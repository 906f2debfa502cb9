// Multithreaded host-RAM graph gather for the billion-scale Base variant.
//
// Equivalent of the reference's per-iteration OpenMP fetch loop
// (BANG_Base/bang_search.cu:771-813): worker threads stride over the query
// batch, and for each query's current parent read its packed graph record
// (vector | degree | sorted neighbor ids) out of the host-resident index,
// writing the neighbor ids (padded with the parent id) and the
// float-converted parent vector into pinned staging buffers for H2D upload.
//
// Built as a plain shared library; Python binds via ctypes (no pybind11).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename T>
void convert_vec(const uint8_t* src, float* dst, uint32_t d) {
  const T* v = reinterpret_cast<const T*>(src);
  for (uint32_t i = 0; i < d; ++i) dst[i] = static_cast<float>(v[i]);
}

}  // namespace

extern "C" {

// dtype_code: 0=int8, 1=uint8, 2=float32 (matches metadata file), or
// 3=raw (copy the vec_bytes vector bytes unconverted — the device casts to
// f32 instead, so the H2D payload stays 1 byte/dim for u8/i8 data).
// out_nbrs: [q, r] int32; out_vecs: [q, d] float32, or [q, vec_bytes] bytes
// in raw mode (may be null to skip).
void bang_gather_parents(const uint8_t* index_buf, uint64_t entry_len,
                         uint32_t vec_bytes, uint32_t d, uint32_t r,
                         int dtype_code, const int32_t* parents, int64_t q,
                         int32_t* out_nbrs, float* out_vecs, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t kBlock = 64;

  auto worker = [&]() {
    while (true) {
      int64_t start = next.fetch_add(kBlock);
      if (start >= q) break;
      int64_t end = start + kBlock < q ? start + kBlock : q;
      for (int64_t i = start; i < end; ++i) {
        const int32_t parent = parents[i];
        const uint8_t* rec = index_buf + static_cast<uint64_t>(parent) * entry_len;
        uint32_t degree;
        std::memcpy(&degree, rec + vec_bytes, sizeof(uint32_t));
        if (degree > r) degree = r;  // corrupt-record guard
        int32_t* nbrs = out_nbrs + i * r;
        std::memcpy(nbrs, rec + vec_bytes + 4, degree * sizeof(int32_t));
        for (uint32_t j = degree; j < r; ++j) nbrs[j] = parent;
        if (out_vecs != nullptr) {
          if (dtype_code == 3) {
            std::memcpy(reinterpret_cast<uint8_t*>(out_vecs) + i * vec_bytes,
                        rec, vec_bytes);
          } else {
            float* dst = out_vecs + i * d;
            switch (dtype_code) {
              case 0: convert_vec<int8_t>(rec, dst, d); break;
              case 1: convert_vec<uint8_t>(rec, dst, d); break;
              default: std::memcpy(dst, rec, d * sizeof(float)); break;
            }
          }
        }
      }
    }
  };

  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
