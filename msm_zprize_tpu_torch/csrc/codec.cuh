// Row codecs: field values stored as int32 rows instead of S::NL 12-bit
// limbs, decoded into the field core's register words at a kernel's loads
// and encoded again at its stores.
//
// Replaces the codec boundary of the TPU kernels: Fma51Codec/PackedCodec
// decode/encode (msm_zprize_tpu/fields/fma51_pallas.py:54-245) as used by
// montmul51_pallas (K13) and CurveKernels(codec=)._rd/_wr
// (curves/pallas_curve.py:166-192, K14). The TPU decodes rows into 12-bit
// digits because its exact multiplier is 24 bits; here the core computes
// on 32-bit words, so a row lands in at most two words with two shifts,
// unrolled at compile time (row offsets and widths are constants).
//
// Layout (the Python side's fields/codec.py): a value is C::ROWS int32
// rows, row r holding bits [C::off(r), C::off(r) + C::width(r)), each row
// masked to its width and non-negative; row r of element `lane` is at
// ptr[r*ld + lane].
//   Packed31<ROWS>: dense 31-bit rows (PackedCodec): 13 rows for the
//                   base fields of BLS12-377 and BLS12-381 (403 bits of
//                   capacity against the core's 384-bit registers), 9 for
//                   those of ed-on-bls12-377 and Pallas (279 against 256);
//   Fma51Rows:      five 51-bit limbs as (26, 25)-bit halves, the top pair
//                   (26, 26): 10 rows, 256 bits (Fma51Codec; p < 2^255 -
//                   2^206, so only the 8-word shapes Fp22 and Fp22c here).
// Stored values are < 2p < 2^(32 NW), so row bits at or above 32 NW are 0
// on valid lanes and are dropped on decode; lanes whose rows hold garbage
// (the engines' clamped-gather lanes) decode to some value below 2^(32 NW)
// that the formulas select away, and the decode reads exactly C::ROWS rows.
#pragma once

#include "field.cuh"

namespace msm {

// The codec ids of K13's C entry point (fields/codec.py::CODEC_IDS).
constexpr int CODEC_PACKED31 = 1;
constexpr int CODEC_FMA51 = 2;

template <int ROWS_>
struct Packed31 {
  static constexpr int ROWS = ROWS_;
  __host__ __device__ static constexpr int off(int r) { return 31 * r; }
  __host__ __device__ static constexpr int width(int) { return 31; }
};

struct Fma51Rows {
  static constexpr int ROWS = 10;
  __host__ __device__ static constexpr int off(int r) { return 51 * (r >> 1) + 26 * (r & 1); }
  __host__ __device__ static constexpr int width(int r) {
    return (r & 1) == 0 || r == ROWS - 1 ? 26 : 25;
  }
};

template <class S, class C>
__device__ __forceinline__ Fe<S> load_rows(const int32_t* __restrict__ src, int64_t ld,
                                           int64_t lane) {
  Fe<S> r = fe_zero<S>();
#pragma unroll
  for (int i = 0; i < C::ROWS; ++i) {
    const int off = C::off(i), wd = C::width(i), w = off >> 5, s = off & 31;
    const uint32_t d = static_cast<uint32_t>(__ldg(src + i * ld + lane)) & ((1u << wd) - 1);
    if (w < S::NW) r.v[w] |= d << s;
    if (s + wd > 32 && w + 1 < S::NW) r.v[w + 1] |= d >> (32 - s);
  }
  return r;
}

template <class S, class C>
__device__ __forceinline__ void store_rows(const Fe<S>& a, int32_t* __restrict__ dst, int64_t ld,
                                           int64_t lane) {
#pragma unroll
  for (int i = 0; i < C::ROWS; ++i) {
    const int off = C::off(i), wd = C::width(i), w = off >> 5, s = off & 31;
    uint32_t d = w < S::NW ? a.v[w] >> s : 0;
    if (s + wd > 32 && w + 1 < S::NW) d |= a.v[w + 1] << (32 - s);
    dst[i * ld + lane] = static_cast<int32_t>(d & ((1u << wd) - 1));
  }
}

// ---- storage policies of the curve kernels ---------------------------------
// load: operand i of a lane as a value < 2p; store: an output; copy: operand
// i's stored rows to output o bit for bit (pass-through lanes).

template <class S_>
struct LimbStore {
  using S = S_;
  static __device__ __forceinline__ Fe<S> load(const Operands& ops, int i, int64_t lane,
                                               const FieldConsts<S>& fc) {
    return load_reduced(ops, i, lane, fc);
  }
  static __device__ __forceinline__ void store(const Operands& ops, int i, int64_t lane,
                                               const Fe<S>& a) {
    store_out(ops, i, lane, a);
  }
  static __device__ __forceinline__ void copy(const Operands& ops, int i, int o, int64_t lane) {
    copy_rows<S::NL>(ops, i, o, lane);
  }
};

template <class S_, class C>
struct RowStore {
  using S = S_;
  static __device__ __forceinline__ Fe<S> load(const Operands& ops, int i, int64_t lane,
                                               const FieldConsts<S>& fc) {
    return cond_sub(load_rows<S, C>(reinterpret_cast<const int32_t*>(ops.p[i]), ops.ld[i], lane),
                    fc.two_p);
  }
  static __device__ __forceinline__ void store(const Operands& ops, int i, int64_t lane,
                                               const Fe<S>& a) {
    store_rows<S, C>(a, reinterpret_cast<int32_t*>(ops.p[i]), ops.ld[i], lane);
  }
  static __device__ __forceinline__ void copy(const Operands& ops, int i, int o, int64_t lane) {
    copy_rows<C::ROWS>(ops, i, o, lane);
  }
};

// ---- the one table of the row storages the kernels are built for ------------
// Each entry: a field shape, a codec id and the row layout of that codec on
// that field. K13 (montmul.cu) is built for every entry, K14 (the curve
// units, curve.cuh) for every entry of a Weierstrass field (Fp32, Fp33,
// Fp22c); msm_codec_rows reads the rows from here.

template <class S_, int ID, class C_>
struct CodecEntry {
  using S = S_;
  using C = C_;
  static constexpr int id = ID;
};

using CodecTable = std::tuple<CodecEntry<Fp32, CODEC_PACKED31, Packed31<13>>,
                              CodecEntry<Fp22, CODEC_PACKED31, Packed31<9>>,
                              CodecEntry<Fp22, CODEC_FMA51, Fma51Rows>,
                              CodecEntry<Fp33, CODEC_PACKED31, Packed31<13>>,
                              CodecEntry<Fp22c, CODEC_PACKED31, Packed31<9>>,
                              CodecEntry<Fp22c, CODEC_FMA51, Fma51Rows>>;

template <class Fn, class... E>
int with_codec_in(int shape, int codec, Fn& fn, std::tuple<E...>*) {
  int out = -1;
  (void)((E::S::ID == shape && E::id == codec && ((out = fn(E{})), true)) || ...);
  return out;
}

// fn(E{}) for the table's entry E of the field shape `shape` (an ID of
// field.cuh) and the codec id `codec` (fn returns a non-negative int), -1
// when the table has none.
template <class Fn>
int with_codec(int shape, int codec, Fn fn) {
  return with_codec_in(shape, codec, fn, static_cast<CodecTable*>(nullptr));
}

}  // namespace msm
