// Device field core for the port's kernels: arithmetic mod p on one field
// element per thread, Montgomery form with R = 2^384.
//
// Replaces the in-kernel field algebra of the TPU kernels (K0,
// msm_zprize_tpu/fields/pallas_field.py: FV values with trace-time interval
// bounds, carry-free add/sub/small-mul, relax rounds, stacked CIOS
// mont_mul/mont_square). A thread here owns a whole element in registers,
// so deferred carries buy nothing: every operation carries fully and the
// bound argument below replaces the trace-time interval tracker.
//
// Storage (what tensors hold, the JAX package's layout): (32, W) int32,
// limb-major, 12-bit limbs; element `lane` has limb i at ptr[i*ld + lane].
// Inputs may be in the TPU kernels' storage contract (limbs in [-1, 2^12],
// value < 4p); load_fe runs a signed carry pass. Outputs are canonical limbs
// (in [0, 2^12)) with value < 2p, stricter than that contract, so every
// consumer of the JAX layout still holds.
//
// Registers: 12 x 32-bit words, little-endian. 12 * 32 = 384 = 32 * 12, so
// R = 2^384 is the same R as the w = 12, n = 32 limb code and the Montgomery
// product is the same integer. This equality holds for BLS12-377 only
// (BLS12-381 has n = 33, R = 2^396); the Python wrappers refuse other fields.
//
// Bounds, argued once (R = 2^384 > 16p for BLS12-377, p < 2^377):
//  * f_add, f_sub, f_neg take values < 2p and return values < 2p (one
//    conditional subtract / add of 2p; a + b < 4p < 2^384 never overflows).
//  * mont_mul on a, b < 4p returns (a*b + q*p) / R with q < R, which is
//    < 16p^2/R + p < 2p. Its CIOS accumulator stays below a + p < 5p before
//    each shift, so 13 words suffice and the 13th is 0 at the end.
//  * So a formula that starts from values < 2p keeps every intermediate
//    < 2p, and its outputs meet its own input contract: a chained formula
//    (k doublings in one launch) re-enters with the same bound each step.
#pragma once

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace msm {

constexpr int NW = 12;          // 32-bit words per element
constexpr int NL = 32;          // 12-bit storage limbs per element
constexpr int LIMB_BITS = 12;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;

// Field and curve constants, filled from the Python objects (never literals).
struct FieldConsts {
  uint32_t p[NW];
  uint32_t two_p[NW];
  uint32_t one[NW];       // R mod p: Montgomery one
  uint32_t b3_mont[NW];   // 3b * R mod p (K3's 3b * Z1 * Z2 with Z in {0, 1})
  uint32_t pinv;          // -p^-1 mod 2^32
  uint32_t b3_small;      // 3b as a plain integer, applied by f_small
};
constexpr int FIELD_CONST_WORDS = 4 * NW + 2;
static_assert(sizeof(FieldConsts) == FIELD_CONST_WORDS * sizeof(uint32_t),
              "FieldConsts must match the host word layout");

struct Fe {
  uint32_t v[NW];
};

inline FieldConsts field_consts_from_host(const uint32_t* words) {
  FieldConsts fc;
  std::memcpy(&fc, words, sizeof fc);
  return fc;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_from(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = w[i];
  return r;
}

// Per-lane select: a where cond, else b.
__device__ __forceinline__ Fe fe_select(bool cond, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = cond ? a.v[i] : b.v[i];
  return r;
}

// ---- storage <-> registers -------------------------------------------------

// Signed carry pass over the 12-bit limbs (each in [-1, 2^12]), packed into
// words. The value is in [0, 2^384), so the carry out of the top limb is 0.
__device__ __forceinline__ Fe load_fe(const int32_t* __restrict__ src,
                                      int64_t ld, int64_t lane) {
  Fe r = fe_zero();
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t t = __ldg(src + i * ld + lane) + carry;
    const uint32_t d = static_cast<uint32_t>(t) & LIMB_MASK;
    carry = t >> LIMB_BITS;  // arithmetic shift: borrows propagate as -1
    const int bit = LIMB_BITS * i, w = bit >> 5, off = bit & 31;
    r.v[w] |= d << off;
    if (off + LIMB_BITS > 32) r.v[w + 1] |= d >> (32 - off);
  }
  return r;
}

__device__ __forceinline__ void store_fe(const Fe& a, int32_t* __restrict__ dst,
                                         int64_t ld, int64_t lane) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int bit = LIMB_BITS * i, w = bit >> 5, off = bit & 31;
    uint32_t d = a.v[w] >> off;
    if (off + LIMB_BITS > 32) d |= a.v[w + 1] << (32 - off);
    dst[i * ld + lane] = static_cast<int32_t>(d & LIMB_MASK);
  }
}

// ---- add / sub ------------------------------------------------------------

// r = a + b; returns the carry out of the top word.
__device__ __forceinline__ uint32_t add_words(Fe& r, const Fe& a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += static_cast<uint64_t>(a.v[i]) + b[i];
    r.v[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
}

// r = a - b mod 2^384; returns 1 on borrow (a < b).
__device__ __forceinline__ uint32_t sub_words(Fe& r, const Fe& a, const uint32_t* b) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += static_cast<int64_t>(a.v[i]) - static_cast<int64_t>(b[i]);
    r.v[i] = static_cast<uint32_t>(c);
    c >>= 32;  // 0 or -1
  }
  return c != 0;
}

// a - m if a >= m, else a.
__device__ __forceinline__ Fe cond_sub(const Fe& a, const uint32_t* m) {
  Fe t;
  const uint32_t borrow = sub_words(t, a, m);
  return fe_select(borrow != 0, a, t);
}

__device__ __forceinline__ Fe f_add(const Fe& a, const Fe& b, const FieldConsts& fc) {
  Fe s;
  add_words(s, a, b.v);
  return cond_sub(s, fc.two_p);
}

__device__ __forceinline__ Fe f_sub(const Fe& a, const Fe& b, const FieldConsts& fc) {
  Fe d, u;
  const uint32_t borrow = sub_words(d, a, b.v);
  add_words(u, d, fc.two_p);  // wraps mod 2^384 back into [0, 2p)
  return fe_select(borrow != 0, u, d);
}

__device__ __forceinline__ Fe f_neg(const Fe& a, const FieldConsts& fc) {
  return f_sub(fe_zero(), a, fc);
}

__device__ __forceinline__ Fe f_cneg(const Fe& a, bool flag, const FieldConsts& fc) {
  return fe_select(flag, f_neg(a, fc), a);
}

// k * a for a small plain integer k (double-and-add, MSB first).
__device__ __forceinline__ Fe f_small(const Fe& a, uint32_t k, const FieldConsts& fc) {
  Fe r = fe_zero();
  for (int b = 31 - __clz(k | 1); b >= 0; --b) {
    r = f_add(r, r, fc);
    if ((k >> b) & 1u) r = f_add(r, a, fc);
  }
  return r;
}

// ---- Montgomery product (CIOS over 32-bit words) ----------------------------

__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b, const FieldConsts& fc) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int i = 0; i <= NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += static_cast<uint64_t>(a.v[j]) * b.v[i] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    t[NW] += static_cast<uint32_t>(c);
    const uint32_t m = t[0] * fc.pinv;
    c = (static_cast<uint64_t>(m) * fc.p[0] + t[0]) >> 32;  // low word cancels
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += static_cast<uint64_t>(m) * fc.p[j] + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = static_cast<uint32_t>(c);
    t[NW] = static_cast<uint32_t>(c >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = t[i];
  return r;
}

__device__ __forceinline__ Fe mont_square(const Fe& a, const FieldConsts& fc) {
  return mont_mul(a, a, fc);
}

// ---- launch helpers ----------------------------------------------------------

constexpr int BLOCK_THREADS = 128;

inline unsigned grid_for(int64_t W) {
  return static_cast<unsigned>((W + BLOCK_THREADS - 1) / BLOCK_THREADS);
}

}  // namespace msm
