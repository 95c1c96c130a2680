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
// Field shapes. Everything is a template on Shape<ID, NL, NW, TAIL, CARRY>:
// NL storage limbs, NW 32-bit register words (enough for values < 2p), and
// R = 2^(12 NL) = 2^(32 RW + TAIL): RW full 32-bit CIOS rounds and one
// TAIL-bit round. The Montgomery product must use exactly this R: values
// cross freely between kernels and plain torch ops (ones_mont, constants,
// pack, the K1 twin), so any other R would be wrong wherever they meet.
// The four shapes of the main library have NW = RW:
//   Fp32  = Shape<1, 32, 12, 0>:  R = 2^384 (BLS12-377's base field, p < 2^377);
//   Fp22  = Shape<2, 22, 8, 8>:   R = 2^264 = 2^256 * 2^8 (fields with
//                                 4p < 2^256: ed-on-bls12-377's, p < 2^253);
//   Fp33  = Shape<3, 33, 12, 12>: R = 2^396 = 2^384 * 2^12 (BLS12-381's base
//                                 field, p < 2^381, so 4p < 2^383);
//   Fp22c = Shape<4, 22, 8, 8, true>: R = 2^264 for fields with
//                                 2p < 2^256 <= 4p (Pallas's base field,
//                                 p = 2^254 + ~2^125): the CARRY shape.
// Every other field that the limb code takes (n = ceil((bits(p) + 5) / 12)
// limbs, n = 1..63, so R > 32p) gets a shape made on demand, DynShape, built
// into a library of its own (_build.field_shape, _build.library): ID =
// DYN_ID_BASE + 2048 ROWS + 32 NL + NW (ROWS: the rows of p's PackedCodec,
// codec.cuh), TAIL = 12 NL mod 32, RW = 12 NL div 32 (0 for
// n <= 2), and NW the fewest words with 8p < 2^(32 NW), at least RW. Since
// R > 32p, 8p < 2^(32 RW + TAIL - 2), so NW is RW or RW + 1: a value may
// need one word more than the full rounds reduce (secp256k1: n = 22, R =
// 2^264, 2p > 2^256, NW = 9; goldilocks: n = 6, R = 2^72, NW = 3). mont_mul
// multiplies by every one of b's NW words and reduces after the first RW
// (below).
// mont_mul runs NW multiply rounds, a 32-bit reduction after each of the
// first RW, and, when TAIL > 0, one TAIL-bit reduction round. Fp22 and Fp22c
// have the same NL, so the limb count cannot
// name a shape: every C entry takes the shape's ID, which the Python side
// derives once from (n, p) (_build.field_shape), and refuses constants that
// do not fit the shape it names (fits<S>: p's top word says whether 4p, or
// only 2p, stays below 2^(32 NW); 8p on a DynShape). Other fields are refused
// on both sides.
//
// Bounds, argued once (R > 16p in every shape; 2p < 2^(32 NW)):
//  * Every load returns a value < 2p (load_reduced; for CARRY shapes load_fe
//    itself), except that K1 and K8 take load_fe's value < 4p on the shapes
//    with 4p < 2^(32 NW).
//  * f_add, f_sub, f_neg take values < 2p and return values < 2p (one
//    conditional subtract / add of 2p). Where 4p < 2^(32 NW), a + b < 4p
//    never overflows the words. In a CARRY shape a + b can reach 2^(32 NW)
//    (a Pallas sum of two values above 2^255), so f_add keeps the carry out
//    of the top word and subtracts 2p whenever it is set: then a + b >= 2^256
//    > 2p, and a + b - 2p < 2p < 2^256 is what the words hold mod 2^256.
//    f_sub never needs it: a - b + 2p lies in [0, 2p) and the words wrap
//    mod 2^(32 NW) to exactly that value.
//  * mont_mul on a, b < 4p (in a CARRY shape on a, b < 2p, as every value
//    there is) returns (a*b + Q*p) / R for the unique Q < R that
//    makes the division exact (CIOS picks Q digit by digit: RW 32-bit
//    digits, then one TAIL-bit digit), so it is the same integer as the limb
//    code's product and is < 16p^2/R + p < 2p. After full round i the
//    accumulator is (a*b_{<=i} + Q_{<=i}*p) / 2^(32(i+1)) < a + p < 5p, so
//    NW + 1 words suffice for the mid-round a b_i + t < a 2^32 + p where
//    a 2^32 + p < 2^(32 NW + 32): fits<S> keeps p's top word below
//    0x3FFFFFFF (a < 4p) or, in a CARRY shape, 0x7FFFFFFF (a < 2p), and a
//    DynShape has 8p < 2^(32 NW). Where NW = RW + 1, the last multiply
//    round adds a*b_RW unreduced: it is the term of b's top word after the
//    RW divisions by 2^32, and a*b_RW + 5p < 4p 2^32 + 5p still fits NW + 1
//    words. The tail round adds m*p with m < 2^TAIL (< 2^32 p more, in NW
//    + 1 words) and shifts right by TAIL bits; the result is < 2p, so the
//    bits shifted in above word NW-1 are 0. With n <= 2 (RW = 0) the product
//    is the one multiply round and the tail round alone.
//  * So a formula that starts from values < 2p keeps every intermediate
//    < 2p, and its outputs meet its own input contract: a chained formula
//    (k doublings in one launch) re-enters with the same bound each step.
#pragma once

#include <cstdint>
#include <cstring>
#include <tuple>

#include <cuda_runtime.h>

namespace msm {

constexpr int LIMB_BITS = 12;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;

// IDs from here up name a shape made on demand (DynShape).
constexpr int DYN_ID_BASE = 1024;

template <int ID_, int NL_, int NW_, int TAIL_, bool CARRY_ = false>
struct Shape {
  static constexpr int ID = ID_;        // the C entries' name for the shape
  static constexpr int NL = NL_;        // 12-bit storage limbs per element
  static constexpr int NW = NW_;        // 32-bit register words per element
  static constexpr int TAIL = TAIL_;    // bits of the last reduction round
  static constexpr bool CARRY = CARRY_;  // 4p >= 2^(32 NW): keep the top carry
  static constexpr int RW = (LIMB_BITS * NL - TAIL) / 32;  // full reduction rounds
  static constexpr bool DYN = ID >= DYN_ID_BASE;  // made on demand: 8p < 2^(32 NW)
  static_assert(LIMB_BITS * NL == 32 * RW + TAIL, "R = 2^(12 NL) must equal 2^(32 RW + TAIL)");
  static_assert(TAIL >= 0 && TAIL < 32, "the tail round reduces less than one word");
  static_assert(NW == RW || (DYN && NW == RW + 1 && !CARRY), "NW is RW, or RW + 1 on a DynShape");
  static_assert(NW == RW || TAIL > 0, "b's top word is reduced by the tail round");
};
using Fp32 = Shape<1, 32, 12, 0>;
using Fp22 = Shape<2, 22, 8, 8>;
using Fp33 = Shape<3, 33, 12, 12>;
using Fp22c = Shape<4, 22, 8, 8, true>;
#ifdef MSM_DYN_SHAPE
// A library built for one shape made on demand (_build.py passes
// -DMSM_DYN_SHAPE and its -DMSM_DYN_ID, _NL, _NW, _TAIL, _ROWS): its entries
// take that shape alone.
using DynShape = Shape<MSM_DYN_ID, MSM_DYN_NL, MSM_DYN_NW, MSM_DYN_TAIL>;
static_assert(DynShape::DYN, "a shape made on demand takes an ID from DYN_ID_BASE up");
using ShapeTable = std::tuple<DynShape>;
#else
using ShapeTable = std::tuple<Fp32, Fp22, Fp33, Fp22c>;
#endif

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
template <class... S>
constexpr bool consts_match(std::tuple<S...>*) {
  return ((sizeof(FieldConsts<S>) == field_const_words<S>() * sizeof(uint32_t)) && ...);
}
static_assert(consts_match(static_cast<ShapeTable*>(nullptr)),
              "FieldConsts must match the host word layout");

// Whether the host's field constants (p's words first) fit S: p's top word
// says whether 4p < 2^(32 NW) (top < 2^30), as every shape but a CARRY one
// needs, or 2p < 2^(32 NW) <= 4p (2^30 <= top < 2^31), as a CARRY shape
// does, each with the margin that keeps mont_mul's accumulator a 2^32 + p
// in NW + 1 words (top < 0x3FFFFFFF; top < 0x7FFFFFFF: ed25519's field, p =
// 2^255 - 19, top 0x7FFFFFFF, overflowed it as a CARRY shape); a DynShape
// needs 8p < 2^(32 NW) (top < 2^29).
template <class S>
inline bool fits(const uint32_t* consts) {
  const uint32_t top = consts[S::NW - 1];
  if constexpr (S::DYN) return (top >> 29) == 0;
  if constexpr (S::CARRY) return top >= 0x40000000u && top < 0x7FFFFFFFu;
  return top < 0x3FFFFFFFu;
}

template <class Fn, class... S>
int with_shape_in(int shape, Fn& fn, std::tuple<S...>*) {
  int out = -1;
  (void)((S::ID == shape && ((out = fn(S{})), true)) || ...);
  return out;
}

// fn(S{}) for the shape S whose ID is `shape` (fn returns a non-negative
// int), -1 when no shape has that ID.
template <class Fn>
int with_shape(int shape, Fn fn) {
  return with_shape_in(shape, fn, static_cast<ShapeTable*>(nullptr));
}

// with_shape for an entry that takes field constants: -1 also when they do
// not fit the shape named (a Pallas field under Fp22's ID, or the reverse).
template <class Fn>
int with_field(int shape, const uint32_t* consts, Fn fn) {
  return with_shape(shape, [&](auto s) { return fits<decltype(s)>(consts) ? fn(s) : -1; });
}

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

// (hi 2^(32 NW) + a) - m if that is >= m, else a, for a carry bit hi above
// the top word: a set hi means the value is >= 2^(32 NW) > m, and the
// difference (< 2^(32 NW) where it is used) is what the words hold.
template <class S>
__device__ __forceinline__ Fe<S> cond_sub_hi(const Fe<S>& a, uint32_t hi, const uint32_t* m) {
  Fe<S> t;
  const uint32_t borrow = sub_words(t, a, m);
  return fe_select(borrow != 0 && hi == 0, a, t);
}

template <class S>
__device__ __forceinline__ Fe<S> f_add(const Fe<S>& a, const Fe<S>& b, const FieldConsts<S>& fc) {
  Fe<S> s;
  const uint32_t hi = add_words(s, a, b.v);
  if constexpr (S::CARRY) return cond_sub_hi(s, hi, fc.two_p);
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

// ---- storage <-> registers -------------------------------------------------

// Signed carry pass over the 12-bit limbs (each in [-1, 2^12]), packed into
// words. The value is in [0, 4p) and 4p < 2^(12 NL), so the carry out of the
// top limb is 0. Where 4p < 2^(32 NW) limb bits at or above bit 32 NW are 0
// and the value is returned as it is (< 4p). In a CARRY shape they hold
// bit 32 NW of a value in [2^(32 NW), 4p): it is kept as a carry bit and the
// value reduced below 2p (the result fits NW words).
template <class S>
__device__ __forceinline__ Fe<S> load_fe(const int32_t* __restrict__ src, int64_t ld,
                                         int64_t lane, const FieldConsts<S>& fc) {
  Fe<S> r = fe_zero<S>();
  uint32_t hi = 0;  // bits at and above 2^(32 NW)
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < S::NL; ++i) {
    const int32_t t = __ldg(src + i * ld + lane) + carry;
    const uint32_t d = static_cast<uint32_t>(t) & LIMB_MASK;
    carry = t >> LIMB_BITS;  // arithmetic shift: borrows propagate as -1
    const int bit = LIMB_BITS * i, w = bit >> 5, off = bit & 31;
    if (w < S::NW) r.v[w] |= d << off;
    else if (S::CARRY && w == S::NW) hi |= d << off;
    if (off + LIMB_BITS > 32) {
      if (w + 1 < S::NW) r.v[w + 1] |= d >> (32 - off);
      else if (S::CARRY && w + 1 == S::NW) hi |= d >> (32 - off);
    }
  }
  if constexpr (S::CARRY) return cond_sub_hi(r, hi, fc.two_p);
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

// ---- Montgomery product (CIOS over 32-bit words, then the tail round) --------
// NW multiply rounds, a 32-bit reduction after each of the first RW (all of
// them but on a DynShape with NW = RW + 1), then the TAIL-bit round.

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
    if (i >= S::RW) continue;  // b's top word on a DynShape with NW = RW + 1: no reduction
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
  const Fe<S> a = load_fe<S>(reinterpret_cast<const int32_t*>(ops.p[i]), ops.ld[i], lane, fc);
  if constexpr (S::CARRY) return a;  // load_fe reduced it below 2p
  return cond_sub(a, fc.two_p);
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
