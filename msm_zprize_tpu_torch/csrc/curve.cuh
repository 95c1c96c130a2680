// K3, K4, K4m, K5, K6, K7: complete short-Weierstrass (a = 0) point
// formulas on Montgomery-form coordinates, G threads a lane (the group
// design; K3, K4 and K7 also one thread a lane where a width table picks
// it; K6 is K5's instance at k = 1), and their launcher. Each kernel is a template on its storage policy St (codec.cuh),
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
// A library of a shape made on demand (-DMSM_DYN_SHAPE) builds the same
// three files for DynShape instead: LimbStore<DynShape> (curve.cu),
// RowStore<DynShape, P31<MSM_DYN_ROWS>> (curve_codec.cu) and, where the
// table of codec.cuh has it, RowStore<DynShape, Fma51Rows>
// (curve_pallas_codec.cu).
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
//                        (one rcb9: K5's group kernel at k = 1)
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
// stored rows (limbs, or codec rows) unchanged, bit for bit, in place of
// the formula's result (the one-thread K7 skips the formula there; a K4m or
// K7 group computes it with its warp and stores the copy): the engines select
// on those lanes again, and a redundant representative would still be
// equal mod p but not the rows the caller gave. The group kernels take the
// same bounds: every product and add on any thread of a group takes and
// returns values < 2p.
//
// What bounds them on an H100. One thread a point (K3, K4 and K7 at
// G = 1): about ten live 384-bit values and the CIOS accumulator take
// 152-246 registers a thread, so an SM holds 2-3 blocks of 128 threads, and
// the formula's 8-12 products are inlined one after another, 10-16k SASS
// instructions (160-250 KB) that one lane walks serially: measured, the
// wide kernels run at 0.3-0.5 TB/s, ~7x their operation bound, and a
// one-lane chain takes ~2.8x its products' latency a product (the code
// does not stay in the instruction cache).
//
// K3, K4, K4m, K5 and K7 run as the group design (below, group.cuh), and
// K6 on K5's kernel: G threads a point, splitting each level of the
// formula's independent products (rcb7: two levels of six; K3's rcb7 with unit Z: a level of
// three, then rcb7's second level; rcb8: a level of five, then rcb7's
// second level; rcb9: two levels of four a doubling) among the group,
// exchanging values through shared memory. It replaces, for K3,
// pallas_curve.py:345-372 (_aff_pair_add_body, rcb7_unitz at :589-641), for
// K4/K4m :272-289 (_proj_add_body, rcb7 at :515), for K5 :302-324
// (_proj_double_k_body, k x rcb9 at :566), for K6 :291-300 and :394
// (_proj_double_body, one rcb9) and, for K7, :330-343 and
// :397-403 (_proj_add_mixed_body, rcb8 at :542-564). A one-lane chain then
// waits on 2 dependent products a level instead of 8 or 12, each level
// calls mont_mul from one loop (1.6-5.5k SASS instructions a kernel),
// 40-128 registers fit 4-5 blocks an SM on 12 words, and the loads and
// stores are the block's, lanes contiguous. What bounds the wide levels now
// is instruction issue: ~1,100 SASS instructions a 12-word product against
// the 588 multiply-adds the operation bound counts (2.7x the bound at G =
// 2; the glue between levels runs on every thread of a group). The table
// curve_group (below) picks G by width, shape and storage.
#pragma once

#include <type_traits>
#include <utility>

#include "codec.cuh"
#include "group.cuh"

namespace msm {
namespace wei {

// 3b a, by f_small's additions when 3b is a small plain integer (fc.small);
// on a shape made on demand fc.small may be 0, and then 3b is no small
// integer and a takes one product by its Montgomery form 3b R (fc.curve[0]),
// as CurveKernels does with b3_small=None (pallas_curve.py:211-215).
template <class S>
__device__ __forceinline__ Fe<S> mul_b3(const Fe<S>& a, const FieldConsts<S>& fc) {
  if constexpr (S::DYN) {
    if (fc.small == 0) return mont_mul(a, fe_from<S>(fc.curve[0]), fc);
  }
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
// One thread a point (G = 1), built only where curve_group picks it.
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

// ---- K4: complete projective add, one thread a point (G = 1) ------------------
// Built only where curve_group picks it: the unmasked add on 8-word shapes.
// ops: X1 Y1 Z1 X2 Y2 Z2 X3 Y3 Z3
template <class St>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_add_kernel(const __grid_constant__ Operands ops, int64_t W,
                const __grid_constant__ FieldConsts<typename St::S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  using S = typename St::S;
  using Fe = msm::Fe<S>;
  Fe X3, Y3, Z3;
  rcb7(St::load(ops, 0, lane, fc), St::load(ops, 1, lane, fc),
       St::load(ops, 2, lane, fc), St::load(ops, 3, lane, fc),
       St::load(ops, 4, lane, fc), St::load(ops, 5, lane, fc), X3, Y3, Z3, fc);
  St::store(ops, 6, lane, X3);
  St::store(ops, 7, lane, Y3);
  St::store(ops, 8, lane, Z3);
}

// ---- K3, K4, K4m, K5 with G threads per point (the group design) --------------
// group.cuh sets out the design and holds its helpers; St::load and
// St::store stage a block's coordinates.

// mul_b3 from the top bit of 3b (>= 1, as b != 0): a, then one doubling and
// at most one add for each bit below it (f_small's chain without its two
// leading steps on 0, which returned 0 and then a: the same values, bit for
// bit, two adds shorter on K5's critical path).
template <class S>
__device__ __forceinline__ Fe<S> mul_b3_lead(const Fe<S>& a, const FieldConsts<S>& fc) {
  if constexpr (S::DYN) {
    if (fc.small == 0) return mont_mul(a, fe_from<S>(fc.curve[0]), fc);  // as mul_b3
  }
  const uint32_t k = fc.small;
  Fe<S> r = a;
  for (int b = 30 - __clz(k); b >= 0; --b) {
    r = f_add(r, r, fc);
    if ((k >> b) & 1u) r = f_add(r, a, fc);
  }
  return r;
}

// RCB Alg. 7 as two levels of six products. Slots: 0-5 the inputs X1 Y1 Z1
// X2 Y2 Z2; level 1 writes m0-m5 to 6-11:
//   m0 = X1 X2, m1 = Y1 Y2, m2 = Z1 Z2, m3 = (X1 + Y1)(X2 + Y2),
//   m4 = (Y1 + Z1)(Y2 + Z2), m5 = (X1 + Z1)(X2 + Z2);
// the glue writes g0-g5 over the inputs (every thread of the group computes
// them, rank j mod G writes g_j):
//   g0 = t3 = m3 - (m0 + m1), g1 = t4 = m4 - (m1 + m2),
//   g2 = 3b (m5 - (m0 + m2)), g3 = 3 m0, g4 = z3 = m1 + 3b m2, g5 = m1 - 3b m2;
// then group_rcb7_finish (rcb7 above, step for step).
template <class S, int G>
__device__ __forceinline__ void group_rcb7_level1(uint32_t* sh, bool active, int pt, int rank,
                                                  const FieldConsts<S>& fc) {
  constexpr int ST = Group<G>::STRIDE;
  group_products<S, G, true>(sh, active, pt, rank, 6, nibbles(0, 1, 2, 0, 1, 0),
                             nibbles(NONE, NONE, NONE, 1, 2, 2), 0, nibbles(3, 4, 5, 3, 4, 3),
                             nibbles(NONE, NONE, NONE, 4, 5, 5), 0, 6, fc);
  if (active) {
    const auto put = [&](int j, const Fe<S>& g) {
      if (j % G == rank) sh_put<S, ST>(sh, j, pt, g);
    };
    const Fe<S> m0 = sh_get<S, ST>(sh, 6, pt), m1 = sh_get<S, ST>(sh, 7, pt);
    const Fe<S> m2 = sh_get<S, ST>(sh, 8, pt);
    put(0, f_sub(sh_get<S, ST>(sh, 9, pt), f_add(m0, m1, fc), fc));
    put(1, f_sub(sh_get<S, ST>(sh, 10, pt), f_add(m1, m2, fc), fc));
    put(2, mul_b3_lead(f_sub(sh_get<S, ST>(sh, 11, pt), f_add(m0, m2, fc), fc), fc));
    put(3, f_add(f_add(m0, m0, fc), m0, fc));
    const Fe<S> b3m2 = mul_b3_lead(m2, fc);
    put(4, f_add(m1, b3m2, fc));
    put(5, f_sub(m1, b3m2, fc));
  }
  __syncwarp();
}

// rcb7's second level and the stores, shared by K3 and K4/K4m: from g0-g5 in
// slots 0-5, level 2 writes n0-n5 to 6-11:
//   n0 = g0 g5, n1 = g1 g2, n2 = g5 g4, n3 = g2 g3, n4 = g4 g1, n5 = g3 g0;
// then the block stores X3 = n0 - n1, Y3 = n2 + n3, Z3 = n4 + n5 to
// operands out, out + 1, out + 2 of its n points from base, lanes
// contiguous; where MASKED and keep[q] is false, P1's stored rows (operands
// 0-2) instead, bit for bit.
template <class St, int G, bool MASKED>
__device__ __forceinline__ void group_rcb7_finish(uint32_t* sh, bool active, int pt, int rank,
                                                  const Operands& ops, int out, int64_t base,
                                                  int n, const bool* keep,
                                                  const FieldConsts<typename St::S>& fc) {
  using S = typename St::S;
  constexpr int P = Group<G>::POINTS, ST = Group<G>::STRIDE;
  constexpr uint32_t none = nibbles(NONE, NONE, NONE, NONE, NONE, NONE);
  group_products<S, G, false>(sh, active, pt, rank, 6, nibbles(0, 1, 5, 2, 4, 3), none, 0,
                              nibbles(5, 2, 4, 3, 1, 0), none, 0, 6, fc);
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * P; i += BLOCK_THREADS) {
    const int c = i / P, q = i % P;
    if (q >= n) continue;
    if (MASKED && !keep[q]) {  // P1's stored rows, bit for bit
      St::copy(ops, c, out + c, base + q);
      continue;
    }
    const Fe<S> u = sh_get<S, ST>(sh, 6 + 2 * c, q), v = sh_get<S, ST>(sh, 7 + 2 * c, q);
    St::store(ops, out + c, base + q, fe_select(c == 0, f_sub(u, v, fc), f_add(u, v, fc)));
  }
}

// ops: X1 Y1 Z1 X2 Y2 Z2 [mask] X3 Y3 Z3
template <class St, int G, bool MASKED>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_add_group_kernel(const __grid_constant__ Operands ops, int64_t W,
                      const __grid_constant__ FieldConsts<typename St::S> fc) {
  using S = typename St::S;
  using Gr = Group<G>;
  constexpr int P = Gr::POINTS, ST = Gr::STRIDE;
  __shared__ uint32_t sh[12 * S::NW * ST];
  __shared__ bool keep[P];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * P;
  const int n = static_cast<int>(W - base < P ? W - base : P);  // this block's points
  for (int i = threadIdx.x; i < 6 * P; i += BLOCK_THREADS) {
    const int c = i / P, pt = i % P;
    if (pt < n) sh_put<S, ST>(sh, c, pt, St::load(ops, c, base + pt, fc));
  }
  if (MASKED) {
    for (int pt = threadIdx.x; pt < n; pt += BLOCK_THREADS) keep[pt] = load_flag(ops, 6, base + pt);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = lane / G, rank = lane % G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  const bool active = grp < Gr::PER_WARP && pt < n;
  group_rcb7_level1<S, G>(sh, active, pt, rank, fc);
  group_rcb7_finish<St, G, MASKED>(sh, active, pt, rank, ops, MASKED ? 7 : 6, base, n, keep, fc);
}

// K3 (rcb7 with Z_i = v_i, as aff_pair_add_kernel above) as a level of three
// products, its glue, and group_rcb7_finish. The block stages Y1, X1 to
// slots 1, 2 and X2, Y2 to 9, 10, each with its sign and valid flag
// applied, and the flags in v1, v2; level 1 writes to 6-8
//   m0 = X1 X2, m1 = Y1 Y2, m2 = (X1 + Y1)(X2 + Y2);
// the glue writes g0-g5 to 0-5 (the thread of rank j mod G computes g_j; a
// slot of 0-5 that it overwrites is read by that thread alone, the shared
// values lie in 6-10):
//   g0 = t3 = m2 - (m0 + m1), g1 = t4 = sel(v2, Y1) + sel(v1, Y2),
//   g2 = 3b (sel(v2, X1) + sel(v1, X2)), g3 = 3 m0, g4 = z3 = m1 + t2,
//   g5 = m1 - t2, where t2 = 3b if v1 v2 else 0.
// ops: x1 y1 s1 v1 x2 y2 s2 v2 X3 Y3 Z3
template <class St, int G>
__global__ void __launch_bounds__(BLOCK_THREADS)
aff_pair_add_group_kernel(const __grid_constant__ Operands ops, int64_t W,
                          const __grid_constant__ FieldConsts<typename St::S> fc) {
  using S = typename St::S;
  using Gr = Group<G>;
  constexpr int P = Gr::POINTS, ST = Gr::STRIDE;
  __shared__ uint32_t sh[12 * S::NW * ST];
  __shared__ bool v1s[P], v2s[P];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * P;
  const int n = static_cast<int>(W - base < P ? W - base : P);  // this block's points
  const Fe<S> zero = fe_zero<S>(), one = fe_from<S>(fc.one);
  for (int i = threadIdx.x; i < 4 * P; i += BLOCK_THREADS) {
    const int c = i / P, pt = i % P;  // c: x1 y1 x2 y2
    if (pt >= n) continue;
    const int side = 4 * (c >> 1);
    const bool is_y = c & 1;
    const bool v = load_flag(ops, side + 3, base + pt), s = load_flag(ops, side + 2, base + pt);
    const Fe<S> a = St::load(ops, side + is_y, base + pt, fc);
    // the identity (0 : 1 : 0) on invalid lanes, before any arithmetic
    sh_put<S, ST>(sh, c == 0 ? 2 : c == 1 ? 1 : 7 + c, pt,
                  is_y ? fe_select(v, f_cneg(a, s, fc), one) : fe_select(v, a, zero));
  }
  for (int pt = threadIdx.x; pt < n; pt += BLOCK_THREADS) {
    v1s[pt] = load_flag(ops, 3, base + pt);
    v2s[pt] = load_flag(ops, 7, base + pt);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = lane / G, rank = lane % G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  const bool active = grp < Gr::PER_WARP && pt < n;
  group_products<S, G, true>(sh, active, pt, rank, 3, nibbles(2, 1, 2), nibbles(NONE, NONE, 1), 0,
                             nibbles(9, 10, 9), nibbles(NONE, NONE, 10), 0, 6, fc);
  if (active) {
    const bool v1 = v1s[pt], v2 = v2s[pt];
    const auto get = [&](int slot) { return sh_get<S, ST>(sh, slot, pt); };
    const Fe<S> t2 = fe_select(v1 && v2, fe_from<S>(fc.curve[0]), zero);  // 3b Z1 Z2
#pragma unroll 1
    for (int j = rank; j < 6; j += G) {
      Fe<S> g;
      switch (j) {
        case 0: g = f_sub(get(8), f_add(get(6), get(7), fc), fc); break;
        case 1: g = f_add(fe_select(v2, get(1), zero), fe_select(v1, get(10), zero), fc); break;
        case 2:
          g = mul_b3_lead(f_add(fe_select(v2, get(2), zero), fe_select(v1, get(9), zero), fc), fc);
          break;
        case 3: g = f_add(f_add(get(6), get(6), fc), get(6), fc); break;
        case 4: g = f_add(get(7), t2, fc); break;
        default: g = f_sub(get(7), t2, fc); break;
      }
      sh_put<S, ST>(sh, j, pt, g);
    }
  }
  __syncwarp();
  group_rcb7_finish<St, G, false>(sh, active, pt, rank, ops, 8, base, n, nullptr, fc);
}

// RCB Alg. 9 (complete doubling, a = 0, valid on the odd-order subgroup),
// k times, as two levels of four products each; K6 is this kernel at k = 1
// (launch_curve). Slots: 0-2 X Y Z; level 1 writes m0-m3 to 3-6:
//   m0 = Y^2, m1 = Y Z, m2 = Z^2, m3 = X Y;
// the glue writes to 7-10: t2 = 3b m2, z3 = 8 m0, y3 = m0 + t2, t0 = m0 - 3 t2;
// level 2 writes n0-n3 to 11-14:
//   n0 = t2 z3, n1 = m1 z3, n2 = t0 y3, n3 = t0 m3;
// and the next X Y Z go to 0-2: X = 2 n3, Y = n0 + n2, Z = n1.
// ops: X1 Y1 Z1 X3 Y3 Z3
template <class St, int G>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_double_k_group_kernel(const __grid_constant__ Operands ops, int64_t W, int k,
                           const __grid_constant__ FieldConsts<typename St::S> fc) {
  using S = typename St::S;
  using Gr = Group<G>;
  constexpr int P = Gr::POINTS, ST = Gr::STRIDE;
  __shared__ uint32_t sh[15 * S::NW * ST];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * P;
  const int n = static_cast<int>(W - base < P ? W - base : P);
  for (int i = threadIdx.x; i < 3 * P; i += BLOCK_THREADS) {
    const int c = i / P, pt = i % P;
    if (pt < n) sh_put<S, ST>(sh, c, pt, St::load(ops, c, base + pt, fc));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = lane / G, rank = lane % G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  const bool active = grp < Gr::PER_WARP && pt < n;
  constexpr uint32_t none = nibbles(NONE, NONE, NONE, NONE);
#pragma unroll 1
  for (int step = 0; step < 2 * k; ++step) {
    const bool lv2 = step & 1;
    group_products<S, G, false>(sh, active, pt, rank, 4,
                                lv2 ? nibbles(7, 4, 10, 10) : nibbles(1, 1, 2, 0), none, 0,
                                lv2 ? nibbles(8, 8, 9, 6) : nibbles(1, 2, 2, 1), none, 0,
                                lv2 ? 11 : 3, fc);
    if (active) {
      const auto put = [&](int slot, int j, const Fe<S>& g) {
        if (j % G == rank) sh_put<S, ST>(sh, slot + j, pt, g);
      };
      if (!lv2) {
        const Fe<S> m0 = sh_get<S, ST>(sh, 3, pt);
        const Fe<S> t2 = mul_b3_lead(sh_get<S, ST>(sh, 5, pt), fc);
        put(7, 0, t2);
        Fe<S> z3 = f_add(m0, m0, fc);
        z3 = f_add(z3, z3, fc);
        put(7, 1, f_add(z3, z3, fc));
        put(7, 2, f_add(m0, t2, fc));
        put(7, 3, f_sub(m0, f_add(f_add(t2, t2, fc), t2, fc), fc));
      } else {
        const Fe<S> n3 = sh_get<S, ST>(sh, 14, pt);
        put(0, 0, f_add(n3, n3, fc));
        put(0, 1, f_add(sh_get<S, ST>(sh, 11, pt), sh_get<S, ST>(sh, 13, pt), fc));
        put(0, 2, sh_get<S, ST>(sh, 12, pt));
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * P; i += BLOCK_THREADS) {
    const int c = i / P, q = i % P;
    if (q < n) St::store(ops, 3 + c, base + q, sh_get<S, ST>(sh, c, q));
  }
}

// ---- K7: projective + affine (mixed) add ----------------------------------------
// K7 (rcb8 above) as a level of five products, its glue, and
// group_rcb7_finish (rcb8's second level is rcb7's, step for step). The
// block stages x2, Y1, X1, y2 to slots 0-3 and Z1 to 11, and keep = !inf2;
// level 1 writes to 6-10
//   m0 = X1 x2, m1 = Y1 y2, m2 = (X1 + Y1)(x2 + y2), m3 = y2 Z1, m4 = x2 Z1;
// the glue writes g0-g5 to 0-5 (the thread of rank j mod G computes g_j;
// Y1 in slot 1 and X1 in slot 2 are read only by the thread that overwrites
// them, x2 and y2 by no glue, Z1 and the m's lie in 6-11):
//   g0 = t3 = m2 - (m0 + m1), g1 = t4 = m3 + Y1, g2 = 3b (m4 + X1),
//   g3 = 3 m0, g4 = z3 = m1 + 3b Z1, g5 = m1 - 3b Z1;
// where inf2 is set the finish stores P1's rows bit for bit.
// ops: X1 Y1 Z1 x2 y2 inf2 X3 Y3 Z3
template <class St, int G>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_add_mixed_group_kernel(const __grid_constant__ Operands ops, int64_t W,
                            const __grid_constant__ FieldConsts<typename St::S> fc) {
  using S = typename St::S;
  using Gr = Group<G>;
  constexpr int P = Gr::POINTS, ST = Gr::STRIDE;
  __shared__ uint32_t sh[12 * S::NW * ST];
  __shared__ bool keep[P];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * P;
  const int n = static_cast<int>(W - base < P ? W - base : P);  // this block's points
  for (int i = threadIdx.x; i < 5 * P; i += BLOCK_THREADS) {
    const int c = i / P, pt = i % P;  // c: X1 Y1 Z1 x2 y2
    if (pt < n) {
      sh_put<S, ST>(sh, c == 0 ? 2 : c == 1 ? 1 : c == 2 ? 11 : c == 3 ? 0 : 3, pt,
                    St::load(ops, c, base + pt, fc));
    }
  }
  for (int pt = threadIdx.x; pt < n; pt += BLOCK_THREADS) keep[pt] = !load_flag(ops, 5, base + pt);
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = lane / G, rank = lane % G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  const bool active = grp < Gr::PER_WARP && pt < n;
  group_products<S, G, true>(sh, active, pt, rank, 5, nibbles(2, 1, 2, 3, 0),
                             nibbles(NONE, NONE, 1, NONE, NONE), 0, nibbles(0, 3, 0, 11, 11),
                             nibbles(NONE, NONE, 3, NONE, NONE), 0, 6, fc);
  if (active) {
    const auto get = [&](int slot) { return sh_get<S, ST>(sh, slot, pt); };
#pragma unroll 1
    for (int j = rank; j < 6; j += G) {
      Fe<S> g;
      switch (j) {
        case 0: g = f_sub(get(8), f_add(get(6), get(7), fc), fc); break;
        case 1: g = f_add(get(9), get(1), fc); break;
        case 2: g = mul_b3_lead(f_add(get(10), get(2), fc), fc); break;
        case 3: g = f_add(f_add(get(6), get(6), fc), get(6), fc); break;
        case 4: g = f_add(get(7), mul_b3_lead(get(11), fc), fc); break;
        default: g = f_sub(get(7), mul_b3_lead(get(11), fc), fc); break;
      }
      sh_put<S, ST>(sh, j, pt, g);
    }
  }
  __syncwarp();
  group_rcb7_finish<St, G, true>(sh, active, pt, rank, ops, 6, base, n, keep, fc);
}

// One thread a point (G = 1), built only where curve_group picks it.
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

// G of K3, K4/K4m and K7 on a shape made on demand: 2 (12 words' pick at the
// widest widths) where a block's 12 slots at G = 2 (64 points) fit the 48 KB
// of static shared memory a block may take, that is up to 15 words (BN462's
// base field, n = 39); above, up to 24 words (n = 63), G = 3 (40 points,
// 47,232 bytes at 24 words). K5's 15 slots at G = 4 fit up to 24 words
// (47,520 bytes), as do K11's 14 and K12's 10 (edwards.cu).
template <class S>
constexpr int dyn_group() {
  return 12 * S::NW * Group<2>::STRIDE * 4 <= 48 * 1024 ? 2 : 3;
}

// G, the threads a point, that K3, K4/K4m (masked), K5 and K7 launch with
// at width W on field shape S, on limbs or (rows) a row codec's storage (G =
// 1: the one-thread aff_pair_add_kernel, proj_add_kernel or
// proj_add_mixed_kernel). A fixed table:
// chip_smoke.py times every built instance at the main path's widths, and
// PERF.md holds the numbers that chose it.
// K3 (timed as it runs in the MSM, after the slot gather: its operands in
// the L2, its code not; the one-thread kernel, ~6-12k SASS instructions,
// then takes up to 2.4x its time with warm code at <= ~50k lanes): up to
// ~6k lanes G = 6 (the most groups); on Pallas's 8 words G = 3 to the
// residual's 32,768 lanes on limbs (~24k on rows, where the one-thread
// kernel ties it at 32,768), then the one-thread kernel (it fits 3-5
// blocks an SM); on 12 words G = 3 to ~12k, G = 2 to ~40k, then G = 3 (3
// products a level, no thread idle), except BLS12-377's 13 rows above
// ~650k lanes, where the one-thread kernel is ~4-5 % ahead in the MSM
// (profile_msm, G = 1 and G = 3 in turns, two calls; on BLS12-381's 13
// rows G = 3 is 3-5 % ahead). Widths where two instances lie within ~3 %
// (the spread between calls) take the neighbouring rule's pick.
// K4: up to ~12k lanes G = 6 is fastest everywhere (2 product levels a
// lane, the most groups); above, G = 2 (3 products a thread a level: the
// least glue repeated across a group), except the wide K4 on Pallas's 8
// words, where the one-thread kernel wins above ~32k lanes (profile_msm's
// A/B of this bound). G = 3 and 4 won no K4 width; G = 1 lost every K4m
// width, every K4 width on 12 words and every K5 width; G = 2 lost every K5
// width to G = 4.
// K7 (the affine reduction's 704 lanes, random_points_fast's 65,536, 4,096
// on rows): G = 6 at 704 and 4,096 lanes on every storage (1.4-4.2x the
// one-thread kernel); at 65,536 G = 2 on 12 words (6-12 % ahead of G = 6,
// 1.9x of the one-thread kernel), the one-thread kernel on Pallas's 8
// words (G = 2 22 % behind); the step at 12,288 is K4's, as no K7 path runs
// between. G = 3 won no K7 width.
// A shape made on demand (field.cuh's DynShape) has no measurements: every
// kernel takes one instance there, K5's G = 4 and dyn_group's G (above) for
// K3, K4/K4m and K7.
template <class S>
int curve_group(int kernel, int64_t W, bool masked, bool rows) {
  if constexpr (S::DYN) return kernel == CURVE_K5 || kernel == CURVE_K6 ? 4 : dyn_group<S>();
  if (kernel == CURVE_K3) {
    if (W <= 6144) return 6;
    if (S::NW == 8) return W <= (rows ? 24576 : 32768) ? 3 : 1;
    if (W <= 12288) return 3;
    if (W <= 40960) return 2;
    return rows && S::ID == Fp32::ID && W > 655360 ? 1 : 3;
  }
  if (kernel == CURVE_K5 || kernel == CURVE_K6) return 4;  // K6: K5's instance, k = 1
  if (kernel == CURVE_K7) return W <= 12288 ? 6 : S::NW == 8 ? 1 : 2;
  if (kernel != CURVE_K4) return 1;
  if (W <= 12288) return 6;
  return S::NW == 8 && !masked && W > 32768 ? 1 : 2;
}

// The instances built on shape S (on limbs, or rows), by G: exactly those
// curve_group picks (the one-thread K3, K4 and K7
// on 8-word shapes, and K3 on BLS12-377's rows; dyn_group's G alone, and
// K5's 4, on a shape made on demand).
template <class S>
using DynGroups = std::integer_sequence<int, dyn_group<S>()>;
template <class S, bool ROWS>
using K3Groups = std::conditional_t<
    S::DYN, DynGroups<S>,
    std::conditional_t<
        S::NW == 8, std::integer_sequence<int, 1, 3, 6>,
        std::conditional_t<ROWS && S::ID == Fp32::ID, std::integer_sequence<int, 1, 2, 3, 6>,
                           std::integer_sequence<int, 2, 3, 6>>>>;
template <class S>
using K4Groups = std::conditional_t<
    S::DYN, DynGroups<S>,
    std::conditional_t<S::NW == 8, std::integer_sequence<int, 1, 2, 6>,
                       std::integer_sequence<int, 2, 6>>>;
template <class S>
using K4mGroups = std::conditional_t<S::DYN, DynGroups<S>, std::integer_sequence<int, 2, 6>>;
using K5Groups = std::integer_sequence<int, 4>;
template <class S>
using K7Groups = std::conditional_t<
    S::DYN, DynGroups<S>,
    std::conditional_t<S::NW == 8, std::integer_sequence<int, 1, 6>,
                       std::integer_sequence<int, 2, 6>>>;

// The built instances of kernel (K3, K4 with `masked`, K5, K7) on shape S
// (on limbs, or rows) into out[0, cap); returns how many there are (0 for a
// kernel with one design).
template <class S>
int built_groups(int kernel, bool masked, bool rows, int* out, int cap) {
  if (kernel == CURVE_K3) {
    return rows ? list_groups(K3Groups<S, true>{}, out, cap)
                : list_groups(K3Groups<S, false>{}, out, cap);
  }
  if (kernel == CURVE_K5) return list_groups(K5Groups{}, out, cap);
  if (kernel == CURVE_K7) return list_groups(K7Groups<S>{}, out, cap);
  if (kernel != CURVE_K4) return 0;
  return masked ? list_groups(K4mGroups<S>{}, out, cap) : list_groups(K4Groups<S>{}, out, cap);
}

template <class St, int G>
void launch_k3(const uint64_t* ptrs, const int64_t* lds, int64_t W,
               const FieldConsts<typename St::S>& fc, cudaStream_t s) {
  const Operands ops = operands_from_host(ptrs, lds, 11);
  if constexpr (G == 1) {
    aff_pair_add_kernel<St><<<grid_for(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
  } else {
    aff_pair_add_group_kernel<St, G><<<Group<G>::grid(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
  }
}

template <class St, int G, bool MASKED>
void launch_k4(const uint64_t* ptrs, const int64_t* lds, int64_t W,
               const FieldConsts<typename St::S>& fc, cudaStream_t s) {
  const Operands ops = operands_from_host(ptrs, lds, MASKED ? 10 : 9);
  if constexpr (G == 1) {
    static_assert(!MASKED, "K4m has no one-thread instance");
    proj_add_kernel<St><<<grid_for(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
  } else {
    proj_add_group_kernel<St, G, MASKED><<<Group<G>::grid(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
  }
}

template <class St, int G>
void launch_k7(const uint64_t* ptrs, const int64_t* lds, int64_t W,
               const FieldConsts<typename St::S>& fc, cudaStream_t s) {
  const Operands ops = operands_from_host(ptrs, lds, 9);
  if constexpr (G == 1) {
    proj_add_mixed_kernel<St><<<grid_for(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
  } else {
    proj_add_mixed_group_kernel<St, G><<<Group<G>::grid(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
  }
}

template <class St, int G>
void launch_k5(int k, const uint64_t* ptrs, const int64_t* lds, int64_t W,
               const FieldConsts<typename St::S>& fc, cudaStream_t s) {
  proj_double_k_group_kernel<St, G><<<Group<G>::grid(W), BLOCK_THREADS, 0, s>>>(
      operands_from_host(ptrs, lds, 6), W, k, fc);
}

// Launch curve kernel `kernel` on storage St; ptrs/lds hold its operands in
// the order of its `ops:` line above (K4m: the mask after the 6 inputs); arg
// is K4's masked flag (K4m when set) or K5's k. K3, K4/K4m, K5 and K7 run
// the instance of curve_group's table, or, where group > 0, the instance with G
// = group (the smoke's and the card test's comparison of every instance).
// Refuses field constants that do not fit St's shape, and an instance that
// is not built.
template <class St>
int launch_curve(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
                 int group, const uint32_t* consts, cudaStream_t s) {
  using S = typename St::S;
  if (!fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  const auto fc = field_consts_from_host<S>(consts);
  const int g = group > 0 ? group : curve_group<S>(kernel, W, arg != 0, St::ROWS);
  switch (kernel) {
    case CURVE_K3:
      if (!with_group(K3Groups<S, St::ROWS>{}, g, [&](auto G) {
            launch_k3<St, decltype(G)::value>(ptrs, lds, W, fc, s);
          })) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    case CURVE_K4: {
      const auto k4 = [&](auto G, auto masked) {
        launch_k4<St, decltype(G)::value, decltype(masked)::value>(ptrs, lds, W, fc, s);
      };
      if (!(arg != 0 ? with_group(K4mGroups<S>{}, g, [&](auto G) { k4(G, std::true_type{}); })
                     : with_group(K4Groups<S>{}, g, [&](auto G) { k4(G, std::false_type{}); }))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    }
    case CURVE_K5:
    case CURVE_K6:  // one doubling: K5's group instance at k = 1
      if (!with_group(K5Groups{}, g, [&](auto G) {
            launch_k5<St, decltype(G)::value>(kernel == CURVE_K6 ? 1 : arg, ptrs, lds, W, fc, s);
          })) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    case CURVE_K7:
      if (!with_group(K7Groups<S>{}, g, [&](auto G) {
            launch_k7<St, decltype(G)::value>(ptrs, lds, W, fc, s);
          })) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Each curve unit defines one of these: launch_curve on its storage
// (curve.cu's msm_curve names the shape and codec each takes).
using CurveUnit = int(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
                      int group, const uint32_t* consts, cudaStream_t s);
CurveUnit limbs_fp32, packed_fp32, limbs_fp33, packed_fp33, limbs_fp22c, packed_fp22c,
    fma51_fp22c, packed_dyn, fma51_dyn;

}  // namespace wei
}  // namespace msm
