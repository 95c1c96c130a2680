// K1: batched Montgomery product x * y * R^-1 mod p on (32, W) limb tensors.
//
// Replaces msm_zprize_tpu/fields/pallas_mul.py::montmul_pallas (body
// _montmul_kernel via _mm_rows): the TPU kernel splits the product into
// three constant-coefficient convolutions over (32, 128)-lane blocks padded
// to 4096 lanes. Here one thread owns one lane and runs CIOS over twelve
// 32-bit words (field.cuh); the ragged edge is masked, so nothing is padded.
// The output is (x*y + q*p) / R with the unique q < R that makes the
// division exact, the same integer as the TPU kernel's and the JAX conv
// path's: canonical limbs, value < 2p for inputs < 4p.
//
// What bounds it on an H100: at the slice's shape (beta * x over 65,536
// lanes) the kernel moves 3 x 32 x 4 bytes per lane and does ~300 32-bit
// multiply-adds, so it is memory- and launch-bound; limb-major loads keep
// each warp's accesses coalesced (limb i of 32 neighbouring lanes is one
// 128-byte line).
#include "field.cuh"

namespace msm {

__global__ void __launch_bounds__(BLOCK_THREADS)
montmul_kernel(const int32_t* __restrict__ x, int64_t ldx,
               const int32_t* __restrict__ y, int64_t ldy,
               int32_t* __restrict__ out, int64_t ldo, int64_t W,
               const __grid_constant__ FieldConsts fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe a = load_fe(x, ldx, lane);
  const Fe b = load_fe(y, ldy, lane);
  store_fe(mont_mul(a, b, fc), out, ldo, lane);
}

}  // namespace msm

// ptrs: {x, y, out} device pointers; lds: {ldx, ldy, ldo} row strides.
extern "C" int msm_montmul(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                           const uint32_t* consts, void* stream) {
  using namespace msm;
  const FieldConsts fc = field_consts_from_host(consts);
  montmul_kernel<<<grid_for(W), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0],
      reinterpret_cast<const int32_t*>(ptrs[1]), lds[1],
      reinterpret_cast<int32_t*>(ptrs[2]), lds[2], W, fc);
  return static_cast<int>(cudaGetLastError());
}

// Host-side layout check: words of FieldConsts the Python side must pack.
extern "C" int msm_field_const_words() { return msm::FIELD_CONST_WORDS; }
