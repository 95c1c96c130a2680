// K10, K11, K12: twisted-Edwards (a = -1) extended-coordinate formulas, one
// lane per thread, on (22, W) limb tensors in Montgomery form.
//
// Replace the formula bodies of msm_zprize_tpu/curves/pallas_curve.py's
// EdwardsKernels (one pallas_call each through _curve_call):
//   K10 ed_pair_add  <- EdwardsKernels.ed_pair_add, body _ed_pair_add_body
//                       (hwcd3_unitz: two signed/valid affine slots -> the
//                       extended sum, 10 muls; invalid lanes are forced to
//                       the identity (0, 1, 1, 0) before any arithmetic and
//                       the digit sign negates x, hence T)
//   K11 ed_add       <- EdwardsKernels.ed_add, body _ed_add_body(masked)
//                       (hwcd3: 2008-hwcd-3 strongly unified add, k = 2d,
//                       9 muls; with a mask, lanes where mask == 0 pass the
//                       first operand through)
//   K12 ed_double_k  <- EdwardsKernels.ed_double_k, body _ed_double_k_body
//                       (k chained hwcd-3 doublings in one launch)
// The curve constants come in FieldConsts::curve: {k R, 2R}. k * T1 * T2 is
// one Montgomery product by k R, as in the TPU body (mont_mul_const): with
// d = 3021, k = 6042 would be a 13-bit double-and-add of 20 field additions
// through f_small, dearer than one 8-word product. The unit-Z D = 2 Z1 Z2 of
// K10 is the constant 2R.
//
// Bounds: every load reduces to < 2p, and field.cuh keeps every
// intermediate < 2p, so outputs are canonical limbs < 2p. That is each
// formula's own input contract, so K12's chain re-enters with the same
// bound at every step by construction; the TPU body replays a store/load
// between doublings for the same reason (pallas_curve.py:486-488) but has
// no check that the relaxed value meets the storage bound.
//
// What bounds them on an H100: 32-bit integer multiply-add throughput and
// register pressure (8 words per value here against 12 for BLS12-377), and
// at K10's width (942,080 lanes at 2^16) the 8 + 4 + 4 operand rows it
// moves. The design is the plain one of curve.cu: one thread per lane,
// 128-thread blocks.
#include "field.cuh"

namespace msm {
namespace ed {

// ed-on-bls12-377's base field (n = 22, R = 2^264) is the one Edwards field
using S = Fp22;
using Fe = msm::Fe<S>;
using FieldConsts = msm::FieldConsts<S>;

// 2008-hwcd-3, a = -1, k = 2d: A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2),
// C = k T1 T2, D = 2 Z1 Z2; E = B-A, F = D-C, G = D+C, H = B+A;
// (X3, Y3, Z3, T3) = (E F, G H, F G, E H).
__device__ __forceinline__ void hwcd3_tail(const Fe& A, const Fe& B, const Fe& C, const Fe& D,
                                           Fe& X3, Fe& Y3, Fe& Z3, Fe& T3,
                                           const FieldConsts& fc) {
  const Fe E = f_sub(B, A, fc), F = f_sub(D, C, fc);
  const Fe G = f_add(D, C, fc), H = f_add(B, A, fc);
  X3 = mont_mul(E, F, fc);
  Y3 = mont_mul(G, H, fc);
  Z3 = mont_mul(F, G, fc);
  T3 = mont_mul(E, H, fc);
}

__device__ __forceinline__ void hwcd3(const Fe& X1, const Fe& Y1, const Fe& Z1, const Fe& T1,
                                      const Fe& X2, const Fe& Y2, const Fe& Z2, const Fe& T2,
                                      Fe& X3, Fe& Y3, Fe& Z3, Fe& T3, const FieldConsts& fc) {
  const Fe A = mont_mul(f_sub(Y1, X1, fc), f_sub(Y2, X2, fc), fc);
  const Fe B = mont_mul(f_add(Y1, X1, fc), f_add(Y2, X2, fc), fc);
  const Fe C = mont_mul(mont_mul(T1, T2, fc), fe_from<S>(fc.curve[0]), fc);
  const Fe ZZ = mont_mul(Z1, Z2, fc);
  hwcd3_tail(A, B, C, f_add(ZZ, ZZ, fc), X3, Y3, Z3, T3, fc);
}

// ---- K10: fused level-1 pair add of two signed affine slots -----------------
// ops: x1 y1 s1 v1 x2 y2 s2 v2 X3 Y3 Z3 T3
__global__ void __launch_bounds__(BLOCK_THREADS)
ed_pair_add_kernel(const __grid_constant__ Operands ops, int64_t W,
                   const __grid_constant__ FieldConsts fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const bool v1 = load_flag(ops, 3, lane), v2 = load_flag(ops, 7, lane);
  const bool s1 = load_flag(ops, 2, lane), s2 = load_flag(ops, 6, lane);
  const Fe zero = fe_zero<S>(), one = fe_from<S>(fc.one);
  // identity (0, 1) on invalid lanes, before any arithmetic; the sign
  // negates x
  const Fe X1 = fe_select(v1, f_cneg(load_reduced(ops, 0, lane, fc), s1, fc), zero);
  const Fe Y1 = fe_select(v1, load_reduced(ops, 1, lane, fc), one);
  const Fe X2 = fe_select(v2, f_cneg(load_reduced(ops, 4, lane, fc), s2, fc), zero);
  const Fe Y2 = fe_select(v2, load_reduced(ops, 5, lane, fc), one);

  // hwcd-3 with Z1 = Z2 = 1 and T_i = X_i Y_i rebuilt here (the slot gather
  // moves two coordinates, not four); D = 2 Z1 Z2 is the constant 2R
  const Fe T1 = mont_mul(X1, Y1, fc), T2 = mont_mul(X2, Y2, fc);
  const Fe A = mont_mul(f_sub(Y1, X1, fc), f_sub(Y2, X2, fc), fc);
  const Fe B = mont_mul(f_add(Y1, X1, fc), f_add(Y2, X2, fc), fc);
  const Fe C = mont_mul(mont_mul(T1, T2, fc), fe_from<S>(fc.curve[0]), fc);
  Fe X3, Y3, Z3, T3;
  hwcd3_tail(A, B, C, fe_from<S>(fc.curve[1]), X3, Y3, Z3, T3, fc);
  store_out(ops, 8, lane, X3);
  store_out(ops, 9, lane, Y3);
  store_out(ops, 10, lane, Z3);
  store_out(ops, 11, lane, T3);
}

// ---- K11: unified extended add, optionally masked ---------------------------
// ops: X1 Y1 Z1 T1 X2 Y2 Z2 T2 [mask] X3 Y3 Z3 T3
template <bool MASKED>
__global__ void __launch_bounds__(BLOCK_THREADS)
ed_add_kernel(const __grid_constant__ Operands ops, int64_t W,
              const __grid_constant__ FieldConsts fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe X1 = load_reduced(ops, 0, lane, fc), Y1 = load_reduced(ops, 1, lane, fc);
  const Fe Z1 = load_reduced(ops, 2, lane, fc), T1 = load_reduced(ops, 3, lane, fc);
  Fe X3, Y3, Z3, T3;
  hwcd3(X1, Y1, Z1, T1, load_reduced(ops, 4, lane, fc), load_reduced(ops, 5, lane, fc),
        load_reduced(ops, 6, lane, fc), load_reduced(ops, 7, lane, fc), X3, Y3, Z3, T3, fc);
  constexpr int out = MASKED ? 9 : 8;
  if (MASKED && !load_flag(ops, 8, lane)) {
    X3 = X1;
    Y3 = Y1;
    Z3 = Z1;
    T3 = T1;
  }
  store_out(ops, out, lane, X3);
  store_out(ops, out + 1, lane, Y3);
  store_out(ops, out + 2, lane, Z3);
  store_out(ops, out + 3, lane, T3);
}

// ---- K12: k chained unified doublings ---------------------------------------
// ops: X1 Y1 Z1 T1 X3 Y3 Z3 T3
__global__ void __launch_bounds__(BLOCK_THREADS)
ed_double_k_kernel(const __grid_constant__ Operands ops, int64_t W, int k,
                   const __grid_constant__ FieldConsts fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  Fe X = load_reduced(ops, 0, lane, fc), Y = load_reduced(ops, 1, lane, fc);
  Fe Z = load_reduced(ops, 2, lane, fc), T = load_reduced(ops, 3, lane, fc);
  for (int i = 0; i < k; ++i) hwcd3(X, Y, Z, T, X, Y, Z, T, X, Y, Z, T, fc);
  store_out(ops, 4, lane, X);
  store_out(ops, 5, lane, Y);
  store_out(ops, 6, lane, Z);
  store_out(ops, 7, lane, T);
}

}  // namespace ed
}  // namespace msm

// Each entry point takes a field shape's ID (field.cuh) and refuses any but
// Fp22's, and field constants that do not fit it (a Pallas field: n = 22 too).
extern "C" int msm_ed_pair_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                               const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::ed;
  if (shape != S::ID || !fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  ed_pair_add_kernel<<<grid_for(W), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      operands_from_host(ptrs, lds, 12), W, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

// masked != 0: ptrs/lds hold the mask (a per-lane flag) after the 8 inputs.
extern "C" int msm_ed_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                          int masked, const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::ed;
  if (shape != S::ID || !fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto fc = field_consts_from_host<S>(consts);
  if (masked) {
    ed_add_kernel<true><<<grid_for(W), BLOCK_THREADS, 0, s>>>(
        operands_from_host(ptrs, lds, 13), W, fc);
  } else {
    ed_add_kernel<false><<<grid_for(W), BLOCK_THREADS, 0, s>>>(
        operands_from_host(ptrs, lds, 12), W, fc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msm_ed_double_k(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                               int k, const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::ed;
  if (shape != S::ID || !fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  ed_double_k_kernel<<<grid_for(W), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      operands_from_host(ptrs, lds, 8), W, k, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}
