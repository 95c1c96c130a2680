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
// Both are instantiated for every field shape of field.cuh; the entry
// points take the field's limb count n and refuse any other.
#include "field.cuh"

namespace msm {

template <class S>
__global__ void __launch_bounds__(BLOCK_THREADS)
montmul_kernel(const int32_t* __restrict__ x, int64_t ldx,
               const int32_t* __restrict__ y, int64_t ldy,
               int32_t* __restrict__ out, int64_t ldo, int64_t W,
               const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe<S> a = load_fe<S>(x, ldx, lane);
  const Fe<S> b = load_fe<S>(y, ldy, lane);
  store_fe(mont_mul(a, b, fc), out, ldo, lane);
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
  const Fe<S> a = load_fe<S>(x, ldx, lane);
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

template <class S>
int launch_exp(const uint64_t* ptrs, const int64_t* lds, int64_t W, const ExpBits& e,
               const uint32_t* consts, cudaStream_t stream) {
  exp_kernel<S><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0],
      reinterpret_cast<int32_t*>(ptrs[1]), lds[1], W, e, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace msm

// ptrs: {x, y, out} device pointers; lds: {ldx, ldy, ldo} row strides.
extern "C" int msm_montmul(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                           const uint32_t* consts, void* stream) {
  using namespace msm;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case Fp32::NL: return launch_montmul<Fp32>(ptrs, lds, W, consts, s);
    case Fp22::NL: return launch_montmul<Fp22>(ptrs, lds, W, consts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ptrs: {x, out}; lds: {ldx, ldo}; ebits: EXP_WORDS words of e, LSB first,
// then its bit length.
extern "C" int msm_exp_const(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                             const uint32_t* ebits, const uint32_t* consts, void* stream) {
  using namespace msm;
  ExpBits e;
  std::memcpy(&e, ebits, sizeof e);
  if (e.nbits < 0 || e.nbits > 32 * EXP_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case Fp32::NL: return launch_exp<Fp32>(ptrs, lds, W, e, consts, s);
    case Fp22::NL: return launch_exp<Fp22>(ptrs, lds, W, e, consts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Host-side layout checks: words of FieldConsts the Python side must pack for
// a field of n limbs (-1: no kernel for that n), and of the exponent.
extern "C" int msm_field_const_words(int n) {
  using namespace msm;
  switch (n) {
    case Fp32::NL: return field_const_words<Fp32>();
    case Fp22::NL: return field_const_words<Fp22>();
    default: return -1;
  }
}

extern "C" int msm_exp_words() { return sizeof(msm::ExpBits) / sizeof(uint32_t); }
