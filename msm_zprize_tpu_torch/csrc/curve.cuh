// K3, K4, K4m, K5, K6, K7: complete short-Weierstrass (a = 0) point
// formulas, one lane per thread, on Montgomery-form coordinates, and their
// launcher. Each kernel is a template on its storage policy St (codec.cuh),
// which names the field shape St::S: LimbStore<S> reads and writes (NL, W)
// 12-bit limb tensors (K3-K7), RowStore<S, C> (C::ROWS, W) row-codec
// tensors (K14, the same formulas on PackedCodec or Fma51Codec storage).
// The storages built, one curve unit (an nvcc process) each:
//   curve.cu              LimbStore<Fp32>           BLS12-377
//   curve_codec.cu        RowStore<Fp32, P31<13>>   BLS12-377 packed
//   curve_381.cu          LimbStore<Fp33>           BLS12-381
//   curve_381_codec.cu    RowStore<Fp33, P31<13>>   BLS12-381 packed
//   curve_pallas.cu       LimbStore<Fp22c>          Pallas
//   curve_pallas_codec.cu RowStore<Fp22c, P31<9>>, RowStore<Fp22c, Fma51Rows>
//                                                   Pallas packed and fma51
// and curve.cu's msm_curve entry dispatches on (shape ID, codec id) to them.
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
//   K4m proj_add      <- CurveKernels.proj_add(mask=), _proj_add_body(True)
//                        (rcb7; where mask == 0 the lane passes P1 through)
//   K5 proj_double_k  <- CurveKernels.proj_double_k, body _proj_double_k_body
//                        (k chained rcb9, RCB Alg. 9, 8 muls each)
//   K6 proj_double    <- CurveKernels.proj_double, body _proj_double_body
//                        (one rcb9)
//   K7 proj_add_mixed <- CurveKernels.proj_add_mixed, _proj_add_mixed_body
//                        (rcb8: RCB Alg. 8, projective + affine, 11 muls;
//                        where the affine operand is infinity, P1 passes)
// with 3b applied as a small-integer multiply (3b = 3 on BLS12-377, 12 on
// BLS12-381, 15 on Pallas).
//
// Bounds: every load reduces to < 2p, and field.cuh keeps every
// intermediate < 2p, so outputs are canonical limbs < 2p. That is also each
// doubling's input contract, so K5's chain re-enters with the same bound at
// every step by construction (the re-entry check the TPU kernel lacked,
// pallas_curve.py:318, is the argument in field.cuh). The 3b products
// (rcb7's mul_b3(t2) and mul_b3(Y3), rcb8's mul_b3(Z1) and mul_b3(Y3)) are
// f_small: a double-and-add chain of f_add, each of which takes values < 2p
// and returns values < 2p (on Pallas's CARRY shape through the carry out of
// the top word), so their inputs and outputs stay < 2p for any 3b. The TPU
// bodies needed an interval proof (_b3_small_safe) because their additions
// were carry-free; here every addition reduces.
//
// Pass-through lanes (K4m with mask == 0, K7 with inf2 set) copy P1's
// stored rows (limbs, or codec rows) unchanged, bit for bit, and skip the
// formula: the engines select on those lanes again, and a redundant
// representative would still be equal mod p but not the rows the caller
// gave.
//
// What bounds it on an H100: register pressure first. About ten live
// 384-bit values plus the CIOS accumulator take 166-246 registers a
// thread, so an SM holds 2-3 blocks of 128 threads, too few warps to cover
// the memory latency of the loads: measured at the MSM's widths, the wide
// kernels run at 0.3-0.46 TB/s and their time follows their bytes (13-row
// storage halves K3's and K4's time), far above the bound set by the
// ~300-IMAD CIOS products (K3: 9 per lane). The 8-word shape of Pallas
// needs fewer registers and so fits more warps. The design is the plain
// one: one thread per lane, 128-thread blocks (the -Xptxas -v lines in the
// build log record registers and spills).
#pragma once

#include "codec.cuh"

namespace msm {
namespace wei {

template <class S>
__device__ __forceinline__ Fe<S> mul_b3(const Fe<S>& a, const FieldConsts<S>& fc) {
  return f_small(a, fc.small, fc);
}

// RCB Alg. 7, complete addition, a = 0.
template <class S>
__device__ __forceinline__ void rcb7(const Fe<S>& X1, const Fe<S>& Y1, const Fe<S>& Z1,
                                     const Fe<S>& X2, const Fe<S>& Y2, const Fe<S>& Z2,
                                     Fe<S>& X3, Fe<S>& Y3, Fe<S>& Z3, const FieldConsts<S>& fc) {
  using Fe = msm::Fe<S>;
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
template <class S>
__device__ __forceinline__ void rcb9(Fe<S>& X, Fe<S>& Y, Fe<S>& Z, const FieldConsts<S>& fc) {
  using Fe = msm::Fe<S>;
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

// RCB Alg. 8, complete mixed addition (Z2 = 1), a = 0.
template <class S>
__device__ __forceinline__ void rcb8(const Fe<S>& X1, const Fe<S>& Y1, const Fe<S>& Z1,
                                     const Fe<S>& X2, const Fe<S>& Y2,
                                     Fe<S>& X3, Fe<S>& Y3, Fe<S>& Z3, const FieldConsts<S>& fc) {
  using Fe = msm::Fe<S>;
  Fe t0 = mont_mul(X1, X2, fc);
  Fe t1 = mont_mul(Y1, Y2, fc);
  Fe t3 = mont_mul(f_add(X2, Y2, fc), f_add(X1, Y1, fc), fc);
  t3 = f_sub(t3, f_add(t0, t1, fc), fc);
  const Fe t4 = f_add(mont_mul(Y2, Z1, fc), Y1, fc);
  Fe y3 = f_add(mont_mul(X2, Z1, fc), X1, fc);
  t0 = f_add(f_add(t0, t0, fc), t0, fc);
  const Fe t2 = mul_b3(Z1, fc);
  const Fe z3 = f_add(t1, t2, fc);
  t1 = f_sub(t1, t2, fc);
  y3 = mul_b3(y3, fc);
  X3 = f_sub(mont_mul(t3, t1, fc), mont_mul(t4, y3, fc), fc);
  Y3 = f_add(mont_mul(t1, z3, fc), mont_mul(y3, t0, fc), fc);
  Z3 = f_add(mont_mul(z3, t4, fc), mont_mul(t0, t3, fc), fc);
}

// ---- K3: fused level-1 pair add of two signed affine slots ------------------
// ops: x1 y1 s1 v1 x2 y2 s2 v2 X3 Y3 Z3
template <class St>
__global__ void __launch_bounds__(BLOCK_THREADS)
aff_pair_add_kernel(const __grid_constant__ Operands ops, int64_t W,
                    const __grid_constant__ FieldConsts<typename St::S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  using S = typename St::S;
  using Fe = msm::Fe<S>;
  const bool v1 = load_flag(ops, 3, lane), v2 = load_flag(ops, 7, lane);
  const bool s1 = load_flag(ops, 2, lane), s2 = load_flag(ops, 6, lane);
  const Fe zero = fe_zero<S>(), one = fe_from<S>(fc.one);
  // identity (0 : 1 : 0) on invalid lanes, before any arithmetic
  const Fe X1 = fe_select(v1, St::load(ops, 0, lane, fc), zero);
  const Fe Y1 = fe_select(v1, f_cneg(St::load(ops, 1, lane, fc), s1, fc), one);
  const Fe X2 = fe_select(v2, St::load(ops, 4, lane, fc), zero);
  const Fe Y2 = fe_select(v2, f_cneg(St::load(ops, 5, lane, fc), s2, fc), one);

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
  St::store(ops, 8, lane, f_sub(mont_mul(t3, t1, fc), mont_mul(t4, y3, fc), fc));
  St::store(ops, 9, lane, f_add(mont_mul(t1, z3, fc), mont_mul(y3, t0, fc), fc));
  St::store(ops, 10, lane, f_add(mont_mul(z3, t4, fc), mont_mul(t0, t3, fc), fc));
}

// ---- K4 / K4m: complete projective add, optionally masked ---------------------
// ops: X1 Y1 Z1 X2 Y2 Z2 [mask] X3 Y3 Z3
template <class St, bool MASKED>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_add_kernel(const __grid_constant__ Operands ops, int64_t W,
                const __grid_constant__ FieldConsts<typename St::S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  using S = typename St::S;
  using Fe = msm::Fe<S>;
  constexpr int out = MASKED ? 7 : 6;
  if (MASKED && !load_flag(ops, 6, lane)) {
    for (int i = 0; i < 3; ++i) St::copy(ops, i, out + i, lane);
    return;
  }
  Fe X3, Y3, Z3;
  rcb7(St::load(ops, 0, lane, fc), St::load(ops, 1, lane, fc),
       St::load(ops, 2, lane, fc), St::load(ops, 3, lane, fc),
       St::load(ops, 4, lane, fc), St::load(ops, 5, lane, fc), X3, Y3, Z3, fc);
  St::store(ops, out, lane, X3);
  St::store(ops, out + 1, lane, Y3);
  St::store(ops, out + 2, lane, Z3);
}

// ---- K5: k chained complete doublings ---------------------------------------
// ops: X1 Y1 Z1 X3 Y3 Z3
template <class St>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_double_k_kernel(const __grid_constant__ Operands ops, int64_t W, int k,
                     const __grid_constant__ FieldConsts<typename St::S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  using S = typename St::S;
  using Fe = msm::Fe<S>;
  Fe X = St::load(ops, 0, lane, fc);
  Fe Y = St::load(ops, 1, lane, fc);
  Fe Z = St::load(ops, 2, lane, fc);
  for (int i = 0; i < k; ++i) rcb9(X, Y, Z, fc);
  St::store(ops, 3, lane, X);
  St::store(ops, 4, lane, Y);
  St::store(ops, 5, lane, Z);
}

// ---- K6: one complete doubling -----------------------------------------------
// ops: X1 Y1 Z1 X3 Y3 Z3
template <class St>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_double_kernel(const __grid_constant__ Operands ops, int64_t W,
                   const __grid_constant__ FieldConsts<typename St::S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  using S = typename St::S;
  using Fe = msm::Fe<S>;
  Fe X = St::load(ops, 0, lane, fc);
  Fe Y = St::load(ops, 1, lane, fc);
  Fe Z = St::load(ops, 2, lane, fc);
  rcb9(X, Y, Z, fc);
  St::store(ops, 3, lane, X);
  St::store(ops, 4, lane, Y);
  St::store(ops, 5, lane, Z);
}

// ---- K7: projective + affine (mixed) add ----------------------------------------
// ops: X1 Y1 Z1 x2 y2 inf2 X3 Y3 Z3
template <class St>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_add_mixed_kernel(const __grid_constant__ Operands ops, int64_t W,
                      const __grid_constant__ FieldConsts<typename St::S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  using S = typename St::S;
  using Fe = msm::Fe<S>;
  if (load_flag(ops, 5, lane)) {  // Q is infinity: P1 + Q = P1
    for (int i = 0; i < 3; ++i) St::copy(ops, i, 6 + i, lane);
    return;
  }
  Fe X3, Y3, Z3;
  rcb8(St::load(ops, 0, lane, fc), St::load(ops, 1, lane, fc),
       St::load(ops, 2, lane, fc), St::load(ops, 3, lane, fc),
       St::load(ops, 4, lane, fc), X3, Y3, Z3, fc);
  St::store(ops, 6, lane, X3);
  St::store(ops, 7, lane, Y3);
  St::store(ops, 8, lane, Z3);
}


// ---- one launcher for every kernel of a storage ---------------------------------

// The kernel ids of msm_curve (curves/cuda_curve.py::KERNEL_IDS).
constexpr int CURVE_K3 = 3, CURVE_K4 = 4, CURVE_K5 = 5, CURVE_K6 = 6, CURVE_K7 = 7;

// Launch curve kernel `kernel` on storage St; ptrs/lds hold its operands in
// the order of its `ops:` line above (K4m: the mask after the 6 inputs); arg
// is K4's masked flag (K4m when set) or K5's k. Refuses field constants that
// do not fit St's shape.
template <class St>
int launch_curve(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
                 const uint32_t* consts, cudaStream_t s) {
  using S = typename St::S;
  if (!fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  const auto fc = field_consts_from_host<S>(consts);
  const unsigned grid = grid_for(W);
  switch (kernel) {
    case CURVE_K3:
      aff_pair_add_kernel<St><<<grid, BLOCK_THREADS, 0, s>>>(operands_from_host(ptrs, lds, 11), W,
                                                              fc);
      break;
    case CURVE_K4:
      if (arg) {
        proj_add_kernel<St, true><<<grid, BLOCK_THREADS, 0, s>>>(
            operands_from_host(ptrs, lds, 10), W, fc);
      } else {
        proj_add_kernel<St, false><<<grid, BLOCK_THREADS, 0, s>>>(
            operands_from_host(ptrs, lds, 9), W, fc);
      }
      break;
    case CURVE_K5:
      proj_double_k_kernel<St><<<grid, BLOCK_THREADS, 0, s>>>(operands_from_host(ptrs, lds, 6), W,
                                                               arg, fc);
      break;
    case CURVE_K6:
      proj_double_kernel<St><<<grid, BLOCK_THREADS, 0, s>>>(operands_from_host(ptrs, lds, 6), W,
                                                             fc);
      break;
    case CURVE_K7:
      proj_add_mixed_kernel<St><<<grid, BLOCK_THREADS, 0, s>>>(operands_from_host(ptrs, lds, 9), W,
                                                                fc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Each curve unit defines one of these: launch_curve on its storage
// (curve.cu's msm_curve names the shape and codec each takes).
using CurveUnit = int(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
                      const uint32_t* consts, cudaStream_t s);
CurveUnit limbs_fp32, packed_fp32, limbs_fp33, packed_fp33, limbs_fp22c, packed_fp22c,
    fma51_fp22c;

}  // namespace wei
}  // namespace msm
