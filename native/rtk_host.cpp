// Native host runtime for rtk-tpu: threaded mesh decode.
//
// The reference decodes mesh input on the host inside its cooperative task
// system (_rtk_decode_indices/_rtk_decode_vertices, rtk.c:1028-1114, run in
// 128-triangle chunks from build tasks).  rtk-tpu keeps the same division
// of labour — the host canonicalises arbitrary input layouts, the device
// builds the BVH — but the host side is this C++ library with a built-in
// thread pool instead of per-chunk C callbacks: one call decodes a whole
// mesh (strided/typed buffers -> packed f32 positions / u32 indices),
// parallelised across cores.
//
// Exposed via ctypes (rtk_tpu/utils/native_host.py); no Python objects
// cross the boundary, only raw buffers.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Range {
  int64_t begin, end;
};

// Simple static partitioner: run fn over [0, n) in roughly equal chunks on
// `threads` std::threads (the caller picks a sensible count).
template <typename F>
void parallel_for(int64_t n, int threads, F &&fn) {
  if (threads <= 1 || n < (1 << 15)) {
    fn(Range{0, n});
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    pool.emplace_back([=, &fn] { fn(Range{b, e}); });
  }
  for (auto &th : pool) th.join();
}

}  // namespace

extern "C" {

// Decode element type tags (mirror rtk_type, rtk.h:45-52).
enum {
  RTKH_F32 = 0,
  RTKH_F64 = 1,
  RTKH_U16 = 2,
  RTKH_U32 = 3,
};

// Decode `count` 3-component positions from a strided buffer into packed
// f32 (count, 3).  stride is in bytes between consecutive vertices.
void rtkh_decode_positions(const void *src, int64_t count, int64_t stride,
                           int type, float *dst, int threads) {
  parallel_for(count, threads, [&](Range r) {
    const char *base = static_cast<const char *>(src);
    if (type == RTKH_F32) {
      for (int64_t i = r.begin; i < r.end; ++i) {
        const float *p = reinterpret_cast<const float *>(base + i * stride);
        dst[i * 3 + 0] = p[0];
        dst[i * 3 + 1] = p[1];
        dst[i * 3 + 2] = p[2];
      }
    } else {  // RTKH_F64 (the reference reads f64 through float* — a bug,
              // SURVEY §2.9.6; this is the intended conversion)
      for (int64_t i = r.begin; i < r.end; ++i) {
        const double *p =
            reinterpret_cast<const double *>(base + i * stride);
        dst[i * 3 + 0] = static_cast<float>(p[0]);
        dst[i * 3 + 1] = static_cast<float>(p[1]);
        dst[i * 3 + 2] = static_cast<float>(p[2]);
      }
    }
  });
}

// Decode `count` indices from a strided u16/u32 buffer into packed u32.
void rtkh_decode_indices(const void *src, int64_t count, int64_t stride,
                         int type, uint32_t *dst, int threads) {
  parallel_for(count, threads, [&](Range r) {
    const char *base = static_cast<const char *>(src);
    if (type == RTKH_U16) {
      for (int64_t i = r.begin; i < r.end; ++i)
        dst[i] = *reinterpret_cast<const uint16_t *>(base + i * stride);
    } else {
      for (int64_t i = r.begin; i < r.end; ++i)
        dst[i] = *reinterpret_cast<const uint32_t *>(base + i * stride);
    }
  });
}

// Gather triangle soup: positions[indices[i]] -> packed (T*3, 3) f32.
// The canonicalisation every build starts from (rtk streams this through
// 128-triangle chunks, rtk.c:1116-1182).
void rtkh_gather_soup(const float *positions, const uint32_t *indices,
                      int64_t n_indices, float *dst, int threads) {
  parallel_for(n_indices, threads, [&](Range r) {
    for (int64_t i = r.begin; i < r.end; ++i) {
      const float *p = positions + int64_t(indices[i]) * 3;
      dst[i * 3 + 0] = p[0];
      dst[i * 3 + 1] = p[1];
      dst[i * 3 + 2] = p[2];
    }
  });
}

int rtkh_hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 1;
}

}  // extern "C"
