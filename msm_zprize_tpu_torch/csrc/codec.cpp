// Host-side bytes codec: packed little-endian bytes <-> w-bit limb vectors,
// and the rejection filter of uniform sampling.
//
// The native tier of `fields/bytes_codec.py` (C++, multi-threaded over the
// element axis), loaded through ctypes by `utils/native_codec.py`, which
// builds it with g++ into `build/` at first use. A copy of the JAX
// package's `native/codec.cpp`: the port builds nothing from there.
//
// Layouts match the numpy codec exactly:
//   bytes:  (B, nbytes) uint8, little-endian per element
//   limbs:  (n, B) int32, radix 2^w (w <= 30), canonical digits

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Minimum elements per thread: below this, spawn overhead dominates.
constexpr int64_t kMinPerThread = 1 << 14;

template <typename F>
void parallel_for(int64_t count, F&& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t max_threads = std::max<int64_t>(1, count / kMinPerThread);
  int64_t n_threads = std::min<int64_t>(hw ? hw : 1, max_threads);
  if (n_threads <= 1) {
    body(0, count);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (count + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = std::min(count, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &body] { body(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// bytes (B, nbytes) u8 LE -> limbs (n, B) i32 at radix 2^w.
void msm_bytes_to_limbs(const uint8_t* data, int64_t B, int64_t nbytes,
                        int32_t* out, int64_t n, int64_t w) {
  const uint32_t mask = (w >= 31) ? 0x7fffffffu : ((1u << w) - 1u);
  parallel_for(B, [=](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; b++) {
      const uint8_t* src = data + b * nbytes;
      uint64_t acc = 0;
      int acc_bits = 0;
      int64_t j = 0;
      for (int64_t i = 0; i < n; i++) {
        while (acc_bits < w && j < nbytes) {
          acc |= (uint64_t)src[j++] << acc_bits;
          acc_bits += 8;
        }
        out[i * B + b] = (int32_t)(acc & mask);
        acc >>= w;
        acc_bits -= (int)w;
        if (acc_bits < 0) acc_bits = 0;
      }
    }
  });
}

// limbs (n, B) i32 at radix 2^w -> bytes (B, nbytes) u8 LE.
void msm_limbs_to_bytes(const int32_t* limbs, int64_t n, int64_t B, int64_t w,
                        uint8_t* out, int64_t nbytes) {
  parallel_for(B, [=](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; b++) {
      uint8_t* dst = out + b * nbytes;
      std::memset(dst, 0, (size_t)nbytes);
      uint64_t acc = 0;
      int acc_bits = 0;
      int64_t j = 0;
      for (int64_t i = 0; i < n; i++) {
        acc |= (uint64_t)(uint32_t)limbs[i * B + b] << acc_bits;
        acc_bits += (int)w;
        while (acc_bits >= 8 && j < nbytes) {
          dst[j++] = (uint8_t)(acc & 0xff);
          acc >>= 8;
          acc_bits -= 8;
        }
      }
      while (acc_bits > 0 && j < nbytes) {
        dst[j++] = (uint8_t)(acc & 0xff);
        acc >>= 8;
        acc_bits -= 8;
      }
    }
  });
}

// Rejection filter: mark elements whose value (n limbs, radix 2^w) is below
// the bound. Used by uniform scalar/field sampling
// (`src/bigint/field-random.ts:30-101` analog).
void msm_below_bound(const int32_t* limbs, int64_t n, int64_t B,
                     const int32_t* bound, uint8_t* ok) {
  parallel_for(B, [=](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; b++) {
      int res = 0;  // 0 = equal so far, 1 = below, -1 = above
      for (int64_t i = n - 1; i >= 0 && res == 0; i--) {
        int32_t v = limbs[i * B + b];
        if (v < bound[i]) res = 1;
        else if (v > bound[i]) res = -1;
      }
      ok[b] = res == 1;
    }
  });
}

}  // extern "C"
