// Device field core for the port's kernels: arithmetic mod p on one field
// element per thread, Montgomery form with the JAX package's R = 2^(12 NL).
//
// Replaces the in-kernel field algebra of the TPU kernels (K0,
// msm_zprize_tpu/fields/pallas_field.py: FV values with trace-time interval
// bounds, carry-free add/sub/small-mul, relax rounds, stacked CIOS
// mont_mul/mont_square). A thread here owns a whole element in registers,
// so deferred carries buy nothing: every operation carries fully and the
// bound argument below replaces the trace-time interval tracker.
//
// Storage (what tensors hold, the JAX package's layout): (NL, W) int32,
// limb-major, 12-bit limbs; element `lane` has limb i at ptr[i*ld + lane].
// Inputs may be in the TPU kernels' storage contract (limbs in [-1, 2^12],
// value < 4p); load_fe runs a signed carry pass. Outputs are canonical limbs
// (in [0, 2^12)) with value < 2p, stricter than that contract, so every
// consumer of the JAX layout still holds.
//
// Field shapes. Everything is a template on Shape<NL, NW, TAIL>: NL storage
// limbs, NW 32-bit register words (enough for values < 4p), and R = 2^(12 NL)
// = 2^(32 NW + TAIL). The Montgomery product must use exactly this R: values
// cross freely between kernels and plain torch ops (ones_mont, constants,
// pack, the K1 twin), so any other R would be wrong wherever they meet.
//   Fp32 = Shape<32, 12, 0>: R = 2^384 (BLS12-377's base field, p < 2^377);
//   Fp22 = Shape<22, 8, 8>:  R = 2^264 = 2^256 * 2^8 (fields with 4p < 2^256,
//                            ed-on-bls12-377's base field: p < 2^253).
// mont_mul runs NW full 32-bit CIOS rounds and, when TAIL > 0, one TAIL-bit
// reduction round. The Python side (_build.field_words) refuses other fields.
//
// Bounds, argued once (R > 16p in both shapes; 4p < 2^(32 NW)):
//  * f_add, f_sub, f_neg take values < 2p and return values < 2p (one
//    conditional subtract / add of 2p; a + b < 4p < 2^(32 NW) never
//    overflows).
//  * mont_mul on a, b < 4p returns (a*b + Q*p) / R for the unique Q < R that
//    makes the division exact (CIOS picks Q digit by digit: NW 32-bit digits,
//    then one TAIL-bit digit), so it is the same integer as the limb code's
//    product and is < 16p^2/R + p < 2p. After full round i the accumulator is
//    (a*b_{<=i} + Q_{<=i}*p) / 2^(32(i+1)) < a + p < 5p, so NW + 1 words
//    suffice. The tail round adds m*p with m < 2^TAIL (< 5p + 2^TAIL p, in
//    NW + 1 words) and shifts right by TAIL bits; the result is < 2p, so the
//    bits shifted in above word NW-1 are 0.
//  * So a formula that starts from values < 2p keeps every intermediate
//    < 2p, and its outputs meet its own input contract: a chained formula
//    (k doublings in one launch) re-enters with the same bound each step.
#pragma once

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace msm {

constexpr int LIMB_BITS = 12;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;

template <int NL_, int NW_, int TAIL_>
struct Shape {
  static constexpr int NL = NL_;      // 12-bit storage limbs per element
  static constexpr int NW = NW_;      // 32-bit register words per element
  static constexpr int TAIL = TAIL_;  // bits of the last reduction round
  static_assert(LIMB_BITS * NL == 32 * NW + TAIL, "R = 2^(12 NL) must equal 2^(32 NW + TAIL)");
  static_assert(TAIL >= 0 && TAIL < 32, "the tail round reduces less than one word");
};
using Fp32 = Shape<32, 12, 0>;
using Fp22 = Shape<22, 8, 8>;

// Field and curve constants, filled from the Python objects (never literals).
template <class S>
struct FieldConsts {
  uint32_t p[S::NW];
  uint32_t two_p[S::NW];
  uint32_t one[S::NW];       // R mod p: Montgomery one
  uint32_t curve[2][S::NW];  // curve constants in Montgomery form: Weierstrass
                             // {3b R, 0} (K3's 3b * Z1 * Z2 with Z in {0, 1});
                             // Edwards {k R with k = 2d, 2R} (hwcd-3's C, D)
  uint32_t pinv;             // -p^-1 mod 2^32
  uint32_t small;            // a curve constant as a plain integer (3b)
};
template <class S>
constexpr int field_const_words() { return 5 * S::NW + 2; }
static_assert(sizeof(FieldConsts<Fp32>) == field_const_words<Fp32>() * sizeof(uint32_t),
              "FieldConsts must match the host word layout");
static_assert(sizeof(FieldConsts<Fp22>) == field_const_words<Fp22>() * sizeof(uint32_t),
              "FieldConsts must match the host word layout");

template <class S>
struct Fe {
  uint32_t v[S::NW];
};

template <class S>
inline FieldConsts<S> field_consts_from_host(const uint32_t* words) {
  FieldConsts<S> fc;
  std::memcpy(&fc, words, sizeof fc);
  return fc;
}

template <class S>
__device__ __forceinline__ Fe<S> fe_zero() {
  Fe<S> r;
#pragma unroll
  for (int i = 0; i < S::NW; ++i) r.v[i] = 0;
  return r;
}

template <class S>
__device__ __forceinline__ Fe<S> fe_from(const uint32_t* w) {
  Fe<S> r;
#pragma unroll
  for (int i = 0; i < S::NW; ++i) r.v[i] = w[i];
  return r;
}

// Per-lane select: a where cond, else b.
template <class S>
__device__ __forceinline__ Fe<S> fe_select(bool cond, const Fe<S>& a, const Fe<S>& b) {
  Fe<S> r;
#pragma unroll
  for (int i = 0; i < S::NW; ++i) r.v[i] = cond ? a.v[i] : b.v[i];
  return r;
}

// ---- storage <-> registers -------------------------------------------------

// Signed carry pass over the 12-bit limbs (each in [-1, 2^12]), packed into
// words. The value is in [0, 4p) and 4p < 2^(32 NW), so the carry out of the
// top limb is 0 and limb bits at or above bit 32 NW are 0.
template <class S>
__device__ __forceinline__ Fe<S> load_fe(const int32_t* __restrict__ src,
                                         int64_t ld, int64_t lane) {
  Fe<S> r = fe_zero<S>();
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < S::NL; ++i) {
    const int32_t t = __ldg(src + i * ld + lane) + carry;
    const uint32_t d = static_cast<uint32_t>(t) & LIMB_MASK;
    carry = t >> LIMB_BITS;  // arithmetic shift: borrows propagate as -1
    const int bit = LIMB_BITS * i, w = bit >> 5, off = bit & 31;
    if (w < S::NW) r.v[w] |= d << off;
    if (off + LIMB_BITS > 32 && w + 1 < S::NW) r.v[w + 1] |= d >> (32 - off);
  }
  return r;
}

template <class S>
__device__ __forceinline__ void store_fe(const Fe<S>& a, int32_t* __restrict__ dst,
                                         int64_t ld, int64_t lane) {
#pragma unroll
  for (int i = 0; i < S::NL; ++i) {
    const int bit = LIMB_BITS * i, w = bit >> 5, off = bit & 31;
    uint32_t d = w < S::NW ? a.v[w] >> off : 0;
    if (off + LIMB_BITS > 32 && w + 1 < S::NW) d |= a.v[w + 1] << (32 - off);
    dst[i * ld + lane] = static_cast<int32_t>(d & LIMB_MASK);
  }
}

// ---- add / sub ------------------------------------------------------------

// r = a + b; returns the carry out of the top word.
template <class S>
__device__ __forceinline__ uint32_t add_words(Fe<S>& r, const Fe<S>& a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < S::NW; ++i) {
    c += static_cast<uint64_t>(a.v[i]) + b[i];
    r.v[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
}

// r = a - b mod 2^(32 NW); returns 1 on borrow (a < b).
template <class S>
__device__ __forceinline__ uint32_t sub_words(Fe<S>& r, const Fe<S>& a, const uint32_t* b) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < S::NW; ++i) {
    c += static_cast<int64_t>(a.v[i]) - static_cast<int64_t>(b[i]);
    r.v[i] = static_cast<uint32_t>(c);
    c >>= 32;  // 0 or -1
  }
  return c != 0;
}

// a - m if a >= m, else a.
template <class S>
__device__ __forceinline__ Fe<S> cond_sub(const Fe<S>& a, const uint32_t* m) {
  Fe<S> t;
  const uint32_t borrow = sub_words(t, a, m);
  return fe_select(borrow != 0, a, t);
}

template <class S>
__device__ __forceinline__ Fe<S> f_add(const Fe<S>& a, const Fe<S>& b, const FieldConsts<S>& fc) {
  Fe<S> s;
  add_words(s, a, b.v);
  return cond_sub(s, fc.two_p);
}

template <class S>
__device__ __forceinline__ Fe<S> f_sub(const Fe<S>& a, const Fe<S>& b, const FieldConsts<S>& fc) {
  Fe<S> d, u;
  const uint32_t borrow = sub_words(d, a, b.v);
  add_words(u, d, fc.two_p);  // wraps mod 2^(32 NW) back into [0, 2p)
  return fe_select(borrow != 0, u, d);
}

template <class S>
__device__ __forceinline__ Fe<S> f_neg(const Fe<S>& a, const FieldConsts<S>& fc) {
  return f_sub(fe_zero<S>(), a, fc);
}

template <class S>
__device__ __forceinline__ Fe<S> f_cneg(const Fe<S>& a, bool flag, const FieldConsts<S>& fc) {
  return fe_select(flag, f_neg(a, fc), a);
}

// k * a for a small plain integer k (double-and-add, MSB first).
template <class S>
__device__ __forceinline__ Fe<S> f_small(const Fe<S>& a, uint32_t k, const FieldConsts<S>& fc) {
  Fe<S> r = fe_zero<S>();
  for (int b = 31 - __clz(k | 1); b >= 0; --b) {
    r = f_add(r, r, fc);
    if ((k >> b) & 1u) r = f_add(r, a, fc);
  }
  return r;
}

// ---- Montgomery product (CIOS over 32-bit words, then the tail round) --------

template <class S>
__device__ __forceinline__ Fe<S> mont_mul(const Fe<S>& a, const Fe<S>& b, const FieldConsts<S>& fc) {
  constexpr int NW = S::NW;
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
  Fe<S> r;
  if constexpr (S::TAIL > 0) {
    // (t + m*p) / 2^TAIL with m = t * (-p^-1) mod 2^TAIL: the low TAIL bits
    // cancel; (-p^-1 mod 2^32) mod 2^TAIL is -p^-1 mod 2^TAIL
    const uint32_t m = (t[0] * fc.pinv) & ((1u << S::TAIL) - 1);
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += static_cast<uint64_t>(m) * fc.p[j] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    t[NW] += static_cast<uint32_t>(c);
#pragma unroll
    for (int j = 0; j < NW; ++j) r.v[j] = (t[j] >> S::TAIL) | (t[j + 1] << (32 - S::TAIL));
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) r.v[i] = t[i];
  }
  return r;
}

template <class S>
__device__ __forceinline__ Fe<S> mont_square(const Fe<S>& a, const FieldConsts<S>& fc) {
  return mont_mul(a, a, fc);
}

// ---- launch helpers ----------------------------------------------------------

constexpr int BLOCK_THREADS = 128;

inline unsigned grid_for(int64_t W) {
  return static_cast<unsigned>((W + BLOCK_THREADS - 1) / BLOCK_THREADS);
}

// Device pointers and row strides of a launch's operands, in entry order.
constexpr int MAX_OPS = 13;

struct Operands {
  uint64_t p[MAX_OPS];
  int64_t ld[MAX_OPS];
};

inline Operands operands_from_host(const uint64_t* ptrs, const int64_t* lds, int n) {
  Operands ops{};
  for (int i = 0; i < n; ++i) {
    ops.p[i] = ptrs[i];
    ops.ld[i] = lds[i];
  }
  return ops;
}

template <class S>
__device__ __forceinline__ Fe<S> load_reduced(const Operands& ops, int i, int64_t lane,
                                              const FieldConsts<S>& fc) {
  return cond_sub(load_fe<S>(reinterpret_cast<const int32_t*>(ops.p[i]), ops.ld[i], lane),
                  fc.two_p);
}

__device__ __forceinline__ bool load_flag(const Operands& ops, int i, int64_t lane) {
  return __ldg(reinterpret_cast<const int32_t*>(ops.p[i]) + lane) != 0;
}

template <class S>
__device__ __forceinline__ void store_out(const Operands& ops, int i, int64_t lane,
                                          const Fe<S>& a) {
  store_fe(a, reinterpret_cast<int32_t*>(ops.p[i]), ops.ld[i], lane);
}

// Operand i's ROWS stored rows (limbs, or a row codec's rows) of one lane,
// copied to output o bit for bit (a pass-through lane keeps the caller's
// representative, not a reduced one).
template <int ROWS>
__device__ __forceinline__ void copy_rows(const Operands& ops, int i, int o, int64_t lane) {
  const int32_t* src = reinterpret_cast<const int32_t*>(ops.p[i]);
  int32_t* dst = reinterpret_cast<int32_t*>(ops.p[o]);
#pragma unroll
  for (int l = 0; l < ROWS; ++l) dst[l * ops.ld[o] + lane] = __ldg(src + l * ops.ld[i] + lane);
}

}  // namespace msm
