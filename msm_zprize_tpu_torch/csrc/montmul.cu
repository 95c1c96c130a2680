// K1: batched Montgomery product x * y * R^-1 mod p on (n, W) limb tensors.
// K8: batched x^e for a static exponent e, one launch for the whole chain.
//
// K1 replaces msm_zprize_tpu/fields/pallas_mul.py::montmul_pallas (body
// _montmul_kernel via _mm_rows): the TPU kernel splits the product into
// three constant-coefficient convolutions over (n, 128)-lane blocks padded
// to 4096 lanes. Here one thread owns one lane and runs CIOS over 32-bit
// words (field.cuh); the ragged edge is masked, so nothing is padded.
// The output is (x*y + q*p) / R with the unique q < R that makes the
// division exact, the same integer as the TPU kernel's and the JAX conv
// path's: canonical limbs, value < 2p for inputs < 4p.
//
// K8 replaces pallas_mul.py::exp_const_pallas (body _exp_kernel): MSB-first
// square-and-multiply from the Montgomery one, the exponent's bits as
// constant words. The bits are the same for every lane, so the multiply is
// a uniform branch, not the TPU kernel's compute-both-and-select.
//
// What bounds them on an H100. K1 at the main paths' shapes (beta * x over
// 65,536 lanes; batch_inverse's rows) moves 3 x n x 4 bytes per lane for
// one product, so it is memory- and launch-bound; limb-major loads keep
// each warp's accesses coalesced (limb i of 32 neighbouring lanes is one
// 128-byte line). K8 runs on ONE lane in the Edwards MSM (the Fermat
// inverse of batch_inverse's grand total: e = p - 2, ~380 dependent
// products), so it is one thread's latency and nothing else; it is one
// launch instead of the ~760 a product per launch would take.
//
// K13: the same Montgomery product on row-codec storage (codec.cuh):
// decode two (rows, W) operands into register words, mont_mul with the
// limb code's own R = 2^(12 n), encode the result (< 2p). Replaces
// msm_zprize_tpu/fields/fma51_pallas.py::montmul51_pallas (body
// _montmul51_kernel: decode rows to 12-bit digits, the interval-tracked
// CIOS, encode with a conditional-subtract chain). The output is already
// canonical and < 2p, so the encode is a pure repack. Instantiated for
// every entry of codec.cuh's table: PackedCodec on Fp32 and Fp33 (13 rows;
// beta * x of the packed MSMs of BLS12-377 and BLS12-381), PackedCodec (9
// rows) and Fma51Codec (10 rows) on Fp22 and Fp22c (Pallas: beta * x of
// its fma51 MSM on Fma51Codec). Bound as K1: bytes and launches at 65,536
// lanes, with 13 (10) rows a value instead of 32 (22).
//
// K1 and K8 are instantiated for every field shape of field.cuh; the entry
// points take the shape's ID (and K13 the codec id) and refuse any other,
// and field constants that do not fit the shape named.
#include "codec.cuh"

namespace msm {

template <class S>
__global__ void __launch_bounds__(BLOCK_THREADS)
montmul_kernel(const int32_t* __restrict__ x, int64_t ldx,
               const int32_t* __restrict__ y, int64_t ldy,
               int32_t* __restrict__ out, int64_t ldo, int64_t W,
               const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe<S> a = load_fe<S>(x, ldx, lane, fc);
  const Fe<S> b = load_fe<S>(y, ldy, lane, fc);
  store_fe(mont_mul(a, b, fc), out, ldo, lane);
}

template <class S, class C>
__global__ void __launch_bounds__(BLOCK_THREADS)
montmul_rows_kernel(const int32_t* __restrict__ x, int64_t ldx,
                    const int32_t* __restrict__ y, int64_t ldy,
                    int32_t* __restrict__ out, int64_t ldo, int64_t W,
                    const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe<S> a = load_rows<S, C>(x, ldx, lane);
  const Fe<S> b = load_rows<S, C>(y, ldy, lane);
  store_rows<S, C>(mont_mul(a, b, fc), out, ldo, lane);
}

// The exponent: bit i of e is bit (i % 32) of w[i / 32], for i < nbits.
constexpr int EXP_WORDS = 12;
struct ExpBits {
  uint32_t w[EXP_WORDS];
  int32_t nbits;
};

template <class S>
__global__ void __launch_bounds__(BLOCK_THREADS)
exp_kernel(const int32_t* __restrict__ x, int64_t ldx,
           int32_t* __restrict__ out, int64_t ldo, int64_t W,
           const __grid_constant__ ExpBits e, const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe<S> a = load_fe<S>(x, ldx, lane, fc);
  Fe<S> acc = fe_from<S>(fc.one);
  for (int i = e.nbits - 1; i >= 0; --i) {
    acc = mont_square(acc, fc);
    if ((e.w[i >> 5] >> (i & 31)) & 1u) acc = mont_mul(acc, a, fc);
  }
  store_fe(acc, out, ldo, lane);
}

template <class S>
int launch_montmul(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                   const uint32_t* consts, cudaStream_t stream) {
  montmul_kernel<S><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0],
      reinterpret_cast<const int32_t*>(ptrs[1]), lds[1],
      reinterpret_cast<int32_t*>(ptrs[2]), lds[2], W, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

template <class S, class C>
int launch_montmul_rows(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                        const uint32_t* consts, cudaStream_t stream) {
  montmul_rows_kernel<S, C><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0],
      reinterpret_cast<const int32_t*>(ptrs[1]), lds[1],
      reinterpret_cast<int32_t*>(ptrs[2]), lds[2], W, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int launch_exp(const uint64_t* ptrs, const int64_t* lds, int64_t W, const ExpBits& e,
               const uint32_t* consts, cudaStream_t stream) {
  exp_kernel<S><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0],
      reinterpret_cast<int32_t*>(ptrs[1]), lds[1], W, e, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace msm

static int refused(int code) { return code < 0 ? static_cast<int>(cudaErrorInvalidValue) : code; }

// ptrs: {x, y, out} device pointers; lds: {ldx, ldy, ldo} row strides;
// shape: a field shape's ID (field.cuh).
extern "C" int msm_montmul(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                           const uint32_t* consts, void* stream) {
  using namespace msm;
  const auto s = static_cast<cudaStream_t>(stream);
  return refused(with_field(shape, consts, [&](auto f) {
    return launch_montmul<decltype(f)>(ptrs, lds, W, consts, s);
  }));
}

// K13. ptrs: {x, y, out}; lds: row strides; codec: a codec id of the table
// in codec.cuh (msm_codec_rows says how many rows each pair takes).
extern "C" int msm_montmul_rows(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                                int codec, const uint32_t* consts, void* stream) {
  using namespace msm;
  const auto s = static_cast<cudaStream_t>(stream);
  return refused(with_codec(shape, codec, [&](auto e) {
    using E = decltype(e);
    if (!fits<typename E::S>(consts)) return -1;
    return launch_montmul_rows<typename E::S, typename E::C>(ptrs, lds, W, consts, s);
  }));
}

// ptrs: {x, out}; lds: {ldx, ldo}; ebits: EXP_WORDS words of e, LSB first,
// then its bit length.
extern "C" int msm_exp_const(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                             const uint32_t* ebits, const uint32_t* consts, void* stream) {
  using namespace msm;
  ExpBits e;
  std::memcpy(&e, ebits, sizeof e);
  if (e.nbits < 0 || e.nbits > 32 * EXP_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return refused(with_field(shape, consts, [&](auto f) {
    return launch_exp<decltype(f)>(ptrs, lds, W, e, consts, s);
  }));
}

// Host-side layout checks: words of FieldConsts the Python side must pack for
// a field shape (-1: no shape has that ID), and of the exponent.
extern "C" int msm_field_const_words(int shape) {
  return msm::with_shape(shape, [](auto f) { return msm::field_const_words<decltype(f)>(); });
}

// Rows a value of a field shape takes in the codec `codec`, from the table
// in codec.cuh, -1 for none: the Python side checks its codec's row count
// against it and names the table's entries when it refuses one.
extern "C" int msm_codec_rows(int shape, int codec) {
  return msm::with_codec(shape, codec, [](auto e) { return decltype(e)::C::ROWS; });
}

extern "C" int msm_exp_words() { return sizeof(msm::ExpBits) / sizeof(uint32_t); }
