// K3, K4, K5: complete short-Weierstrass (a = 0) point formulas, one lane
// per thread, on (32, W) limb tensors in Montgomery form.
//
// Replace the formula bodies of msm_zprize_tpu/curves/pallas_curve.py's one
// curve pallas_call (_curve_call):
//   K3 aff_pair_add   <- CurveKernels.aff_pair_add, body _aff_pair_add_body
//                        (rcb7_unitz: two signed/valid affine slots -> the
//                        projective sum, 9 muls; invalid lanes are forced to
//                        the identity (0 : 1 : 0) before any arithmetic, so
//                        clamped-gather lanes never reach the group law)
//   K4 proj_add       <- CurveKernels.proj_add, body _proj_add_body(False)
//                        (rcb7: Renes-Costello-Batina Alg. 7, 12 muls)
//   K5 proj_double_k  <- CurveKernels.proj_double_k, body _proj_double_k_body
//                        (k chained rcb9, RCB Alg. 9, 8 muls each)
// with 3b applied as a small-integer multiply (3b = 3 on BLS12-377).
//
// Bounds: every load reduces to < 2p, and field.cuh keeps every
// intermediate < 2p, so outputs are canonical limbs < 2p. That is also each
// doubling's input contract, so K5's chain re-enters with the same bound at
// every step by construction (the re-entry check the TPU kernel lacked,
// pallas_curve.py:318, is the argument in field.cuh).
//
// What bounds it on an H100: 32-bit integer multiply-add throughput (a
// CIOS product is ~300 IMADs; K4 does 12 per lane) and register pressure:
// about ten live 384-bit values plus the CIOS accumulator exceed what a
// thread can keep at full occupancy. The design is the plain one: one
// thread per lane, 128-thread blocks, and the compiler spills what does not
// fit (the -Xptxas -v lines in the build log record how much).
#include "field.cuh"

namespace msm {
namespace wei {

// BLS12-377's base field only: the Weierstrass curves of the other field
// shapes are not ported (ROADMAP queue 1)
using S = Fp32;
using Fe = msm::Fe<S>;
using FieldConsts = msm::FieldConsts<S>;

__device__ __forceinline__ Fe mul_b3(const Fe& a, const FieldConsts& fc) {
  return f_small(a, fc.small, fc);
}

// RCB Alg. 7, complete addition, a = 0.
__device__ __forceinline__ void rcb7(const Fe& X1, const Fe& Y1, const Fe& Z1,
                                     const Fe& X2, const Fe& Y2, const Fe& Z2,
                                     Fe& X3, Fe& Y3, Fe& Z3, const FieldConsts& fc) {
  Fe t0 = mont_mul(X1, X2, fc);
  Fe t1 = mont_mul(Y1, Y2, fc);
  Fe t2 = mont_mul(Z1, Z2, fc);
  Fe t3 = mont_mul(f_add(X1, Y1, fc), f_add(X2, Y2, fc), fc);
  t3 = f_sub(t3, f_add(t0, t1, fc), fc);
  Fe t4 = mont_mul(f_add(Y1, Z1, fc), f_add(Y2, Z2, fc), fc);
  t4 = f_sub(t4, f_add(t1, t2, fc), fc);
  Fe y3 = mont_mul(f_add(X1, Z1, fc), f_add(X2, Z2, fc), fc);
  y3 = f_sub(y3, f_add(t0, t2, fc), fc);
  t0 = f_add(f_add(t0, t0, fc), t0, fc);
  t2 = mul_b3(t2, fc);
  Fe z3 = f_add(t1, t2, fc);
  t1 = f_sub(t1, t2, fc);
  y3 = mul_b3(y3, fc);
  X3 = f_sub(mont_mul(t3, t1, fc), mont_mul(t4, y3, fc), fc);
  Y3 = f_add(mont_mul(t1, z3, fc), mont_mul(y3, t0, fc), fc);
  Z3 = f_add(mont_mul(z3, t4, fc), mont_mul(t0, t3, fc), fc);
}

// RCB Alg. 9, complete doubling, a = 0 (valid on the odd-order subgroup).
__device__ __forceinline__ void rcb9(Fe& X, Fe& Y, Fe& Z, const FieldConsts& fc) {
  Fe t0 = mont_square(Y, fc);
  Fe z3 = f_add(t0, t0, fc);
  z3 = f_add(z3, z3, fc);
  z3 = f_add(z3, z3, fc);  // 8 * Y^2
  Fe t1 = mont_mul(Y, Z, fc);
  Fe t2 = mul_b3(mont_square(Z, fc), fc);
  Fe x3 = mont_mul(t2, z3, fc);
  Fe y3 = f_add(t0, t2, fc);
  z3 = mont_mul(t1, z3, fc);
  t2 = f_add(f_add(t2, t2, fc), t2, fc);
  t0 = f_sub(t0, t2, fc);
  y3 = f_add(x3, mont_mul(t0, y3, fc), fc);
  t1 = mont_mul(X, Y, fc);
  x3 = mont_mul(t0, t1, fc);
  X = f_add(x3, x3, fc);
  Y = y3;
  Z = z3;
}

// ---- K3: fused level-1 pair add of two signed affine slots ------------------
// ops: x1 y1 s1 v1 x2 y2 s2 v2 X3 Y3 Z3
__global__ void __launch_bounds__(BLOCK_THREADS)
aff_pair_add_kernel(const __grid_constant__ Operands ops, int64_t W,
                    const __grid_constant__ FieldConsts fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const bool v1 = load_flag(ops, 3, lane), v2 = load_flag(ops, 7, lane);
  const bool s1 = load_flag(ops, 2, lane), s2 = load_flag(ops, 6, lane);
  const Fe zero = fe_zero<S>(), one = fe_from<S>(fc.one);
  // identity (0 : 1 : 0) on invalid lanes, before any arithmetic
  const Fe X1 = fe_select(v1, load_reduced(ops, 0, lane, fc), zero);
  const Fe Y1 = fe_select(v1, f_cneg(load_reduced(ops, 1, lane, fc), s1, fc), one);
  const Fe X2 = fe_select(v2, load_reduced(ops, 4, lane, fc), zero);
  const Fe Y2 = fe_select(v2, f_cneg(load_reduced(ops, 5, lane, fc), s2, fc), one);

  // RCB Alg. 7 with Z_i = v_i in {0, 1}: the three Z products become selects
  Fe t0 = mont_mul(X1, X2, fc);
  Fe t1 = mont_mul(Y1, Y2, fc);
  Fe t3 = mont_mul(f_add(X1, Y1, fc), f_add(X2, Y2, fc), fc);
  t3 = f_sub(t3, f_add(t0, t1, fc), fc);
  const Fe t4 = f_add(fe_select(v2, Y1, zero), fe_select(v1, Y2, zero), fc);
  Fe y3 = f_add(fe_select(v2, X1, zero), fe_select(v1, X2, zero), fc);
  t0 = f_add(f_add(t0, t0, fc), t0, fc);
  const Fe t2 = fe_select(v1 && v2, fe_from<S>(fc.curve[0]), zero);  // 3b * Z1 * Z2
  const Fe z3 = f_add(t1, t2, fc);
  t1 = f_sub(t1, t2, fc);
  y3 = mul_b3(y3, fc);
  store_out(ops, 8, lane, f_sub(mont_mul(t3, t1, fc), mont_mul(t4, y3, fc), fc));
  store_out(ops, 9, lane, f_add(mont_mul(t1, z3, fc), mont_mul(y3, t0, fc), fc));
  store_out(ops, 10, lane, f_add(mont_mul(z3, t4, fc), mont_mul(t0, t3, fc), fc));
}

// ---- K4: complete projective add --------------------------------------------
// ops: X1 Y1 Z1 X2 Y2 Z2 X3 Y3 Z3
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_add_kernel(const __grid_constant__ Operands ops, int64_t W,
                const __grid_constant__ FieldConsts fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  Fe X3, Y3, Z3;
  rcb7(load_reduced(ops, 0, lane, fc), load_reduced(ops, 1, lane, fc),
       load_reduced(ops, 2, lane, fc), load_reduced(ops, 3, lane, fc),
       load_reduced(ops, 4, lane, fc), load_reduced(ops, 5, lane, fc), X3, Y3, Z3, fc);
  store_out(ops, 6, lane, X3);
  store_out(ops, 7, lane, Y3);
  store_out(ops, 8, lane, Z3);
}

// ---- K5: k chained complete doublings ---------------------------------------
// ops: X1 Y1 Z1 X3 Y3 Z3
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_double_k_kernel(const __grid_constant__ Operands ops, int64_t W, int k,
                     const __grid_constant__ FieldConsts fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  Fe X = load_reduced(ops, 0, lane, fc);
  Fe Y = load_reduced(ops, 1, lane, fc);
  Fe Z = load_reduced(ops, 2, lane, fc);
  for (int i = 0; i < k; ++i) rcb9(X, Y, Z, fc);
  store_out(ops, 3, lane, X);
  store_out(ops, 4, lane, Y);
  store_out(ops, 5, lane, Z);
}

}  // namespace wei
}  // namespace msm

// Each entry point takes the field's limb count n and refuses any but 32.
extern "C" int msm_aff_pair_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                                const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::wei;
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  aff_pair_add_kernel<<<grid_for(W), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      operands_from_host(ptrs, lds, 11), W, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msm_proj_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                            const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::wei;
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  proj_add_kernel<<<grid_for(W), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      operands_from_host(ptrs, lds, 9), W, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msm_proj_double_k(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                                 int k, const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::wei;
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  proj_double_k_kernel<<<grid_for(W), BLOCK_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      operands_from_host(ptrs, lds, 6), W, k, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}
