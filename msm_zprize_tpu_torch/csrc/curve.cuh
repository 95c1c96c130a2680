// K3, K4, K4m, K5, K6, K7: complete short-Weierstrass (a = 0) point
// formulas on Montgomery-form coordinates, one thread a lane (K4 and K4m
// also, and K5 only, with G threads a lane: the group design), and their
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
// stored rows (limbs, or codec rows) unchanged, bit for bit, in place of
// the formula's result (K7 skips the formula there; a K4m group computes it
// with its warp and stores the copy): the engines select
// on those lanes again, and a redundant representative would still be
// equal mod p but not the rows the caller gave. The group kernels take the
// same bounds: every product and add on any thread of a group takes and
// returns values < 2p.
//
// What bounds them on an H100. One thread a point (K3, K6, K7, and K4 at
// G = 1): about ten live 384-bit values and the CIOS accumulator take
// 152-246 registers a thread, so an SM holds 2-3 blocks of 128 threads, and
// the formula's 8-12 products are inlined one after another, 10-16k SASS
// instructions (160-250 KB) that one lane walks serially: measured, the
// wide kernels run at 0.3-0.5 TB/s, ~7x their operation bound, and a
// one-lane chain takes ~2.8x its products' latency a product (the code
// does not stay in the instruction cache).
//
// K4, K4m and K5 also run as the group design (below): G threads a point,
// splitting each level of the formula's independent products (rcb7: two
// levels of six; rcb9: two levels of four a doubling) among the group,
// exchanging values through shared memory. It replaces, for K4/K4m,
// pallas_curve.py:272-289 (_proj_add_body, rcb7 at :515) and, for K5,
// :302-324 (_proj_double_k_body, k x rcb9 at :566). A one-lane chain then
// waits on 2 dependent products a level instead of 8 or 12, each level
// calls mont_mul from one loop (1.6-5.3k SASS instructions a kernel),
// 40-128 registers fit 4-5 blocks an SM on 12 words, and the loads and
// stores are the block's, lanes contiguous. What bounds the wide levels now
// is instruction issue: ~1,100 SASS instructions a 12-word product against
// the 588 multiply-adds the operation bound counts (2.7x the bound at G =
// 2; the glue between levels runs on every thread of a group). The table
// curve_group (below) picks G by width and shape.
#pragma once

#include <type_traits>
#include <utility>

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

// ---- K4, K4m, K5 with G threads per point (the group design) -------------------

// A block of BLOCK_THREADS threads handles Group<G>::POINTS points: each warp
// holds 32 / G groups of G consecutive threads (a group never straddles a
// warp; with G = 6 two threads a warp idle). The block stages its points'
// input coordinates in shared memory (St::load: rows become register words
// once, lanes contiguous across the block's threads), each group then runs
// its formula's levels of independent products, G threads at a time, one
// product per thread per round (a loop around one mont_mul call), exchanging
// values through shared memory between levels (__syncwarp), and the block
// stores the outputs as it loaded the inputs (St::store, lanes contiguous).

// mul_b3 from the top bit of 3b (>= 1, as b != 0): a, then one doubling and
// at most one add for each bit below it (f_small's chain without its two
// leading steps on 0, which returned 0 and then a: the same values, bit for
// bit, two adds shorter on K5's critical path).
template <class S>
__device__ __forceinline__ Fe<S> mul_b3_lead(const Fe<S>& a, const FieldConsts<S>& fc) {
  const uint32_t k = fc.small;
  Fe<S> r = a;
  for (int b = 30 - __clz(k); b >= 0; --b) {
    r = f_add(r, r, fc);
    if ((k >> b) & 1u) r = f_add(r, a, fc);
  }
  return r;
}

template <int G>
struct Group {
  static_assert(G >= 2 && G <= 8, "a group holds 2-8 threads");
  static constexpr int PER_WARP = 32 / G;                           // groups a warp
  static constexpr int POINTS = PER_WARP * (BLOCK_THREADS / 32);   // points a block
  static constexpr int STRIDE = POINTS + 1;  // words between a slot's words (banks)
  static unsigned grid(int64_t W) { return static_cast<unsigned>((W + POINTS - 1) / POINTS); }
};

// Field value `slot` of point pt in a block's shared slots: word w at
// sh[(slot * NW + w) * STRIDE + pt].
template <class S, int STRIDE>
__device__ __forceinline__ Fe<S> sh_get(const uint32_t* sh, int slot, int pt) {
  Fe<S> r;
#pragma unroll
  for (int w = 0; w < S::NW; ++w) r.v[w] = sh[(slot * S::NW + w) * STRIDE + pt];
  return r;
}

template <class S, int STRIDE>
__device__ __forceinline__ void sh_put(uint32_t* sh, int slot, int pt, const Fe<S>& a) {
#pragma unroll
  for (int w = 0; w < S::NW; ++w) sh[(slot * S::NW + w) * STRIDE + pt] = a.v[w];
}

// A product table: 4 bits per product j, slot numbers; NONE marks "no second
// summand" in a sum table.
constexpr int NONE = 15;
__host__ __device__ constexpr uint32_t nibbles(int a0, int a1, int a2, int a3, int a4 = 0,
                                               int a5 = 0) {
  return a0 | a1 << 4 | a2 << 8 | a3 << 12 | a4 << 16 | static_cast<uint32_t>(a5) << 20;
}
__device__ __forceinline__ int nib(uint32_t t, int j) { return (t >> (4 * j)) & 15; }

// slot t_j + slot u_j (u_j == NONE: slot t_j alone), without a branch;
// slot t_j alone where no product of the level sums (SUMS false).
template <class S, int STRIDE, bool SUMS>
__device__ __forceinline__ Fe<S> sh_operand(const uint32_t* sh, uint32_t t, uint32_t u, int j,
                                            int pt, const FieldConsts<S>& fc) {
  if constexpr (!SUMS) return sh_get<S, STRIDE>(sh, nib(t, j), pt);
  const int k = nib(u, j);
  const Fe<S> b = sh_get<S, STRIDE>(sh, k == NONE ? 0 : k, pt);
  return f_add(sh_get<S, STRIDE>(sh, nib(t, j), pt), fe_select(k == NONE, fe_zero<S>(), b), fc);
}

// One level of NP independent products of a group: product j = (a_j + a'_j)
// * (b_j + b'_j) into slot out + j, for j = rank, rank + G, ... (one mont_mul
// call site, so the loop body stays one product's code); then the warp syncs.
template <class S, int G, int NP, bool SUMS>
__device__ __forceinline__ void group_products(uint32_t* sh, bool active, int pt, int rank,
                                               uint32_t a, uint32_t a2, uint32_t b, uint32_t b2,
                                               int out, const FieldConsts<S>& fc) {
  constexpr int STRIDE = Group<G>::STRIDE;
  if (active) {
#pragma unroll 1
    for (int j = rank; j < NP; j += G) {
      const Fe<S> x = sh_operand<S, STRIDE, SUMS>(sh, a, a2, j, pt, fc);
      const Fe<S> y = sh_operand<S, STRIDE, SUMS>(sh, b, b2, j, pt, fc);
      sh_put<S, STRIDE>(sh, out + j, pt, mont_mul(x, y, fc));
    }
  }
  __syncwarp();
}

// RCB Alg. 7 as two levels of six products. Slots: 0-5 the inputs X1 Y1 Z1
// X2 Y2 Z2; level 1 writes m0-m5 to 6-11:
//   m0 = X1 X2, m1 = Y1 Y2, m2 = Z1 Z2, m3 = (X1 + Y1)(X2 + Y2),
//   m4 = (Y1 + Z1)(Y2 + Z2), m5 = (X1 + Z1)(X2 + Z2);
// the glue writes g0-g5 over the inputs (every thread of the group computes
// them, rank j mod G writes g_j):
//   g0 = t3 = m3 - (m0 + m1), g1 = t4 = m4 - (m1 + m2),
//   g2 = 3b (m5 - (m0 + m2)), g3 = 3 m0, g4 = z3 = m1 + 3b m2, g5 = m1 - 3b m2;
// level 2 writes n0-n5 over m0-m5:
//   n0 = g0 g5, n1 = g1 g2, n2 = g5 g4, n3 = g2 g3, n4 = g4 g1, n5 = g3 g0,
// and X3 = n0 - n1, Y3 = n2 + n3, Z3 = n4 + n5 (rcb7 above, step for step).
template <class S, int G>
__device__ __forceinline__ void group_rcb7(uint32_t* sh, bool active, int pt, int rank,
                                           const FieldConsts<S>& fc) {
  constexpr int ST = Group<G>::STRIDE;
  group_products<S, G, 6, true>(sh, active, pt, rank, nibbles(0, 1, 2, 0, 1, 0),
                          nibbles(NONE, NONE, NONE, 1, 2, 2), nibbles(3, 4, 5, 3, 4, 3),
                          nibbles(NONE, NONE, NONE, 4, 5, 5), 6, fc);
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
  group_products<S, G, 6, false>(sh, active, pt, rank, nibbles(0, 1, 5, 2, 4, 3),
                          nibbles(NONE, NONE, NONE, NONE, NONE, NONE), nibbles(5, 2, 4, 3, 1, 0),
                          nibbles(NONE, NONE, NONE, NONE, NONE, NONE), 6, fc);
}

// ops: X1 Y1 Z1 X2 Y2 Z2 [mask] X3 Y3 Z3
template <class St, int G, bool MASKED>
__global__ void __launch_bounds__(BLOCK_THREADS)
proj_add_group_kernel(const __grid_constant__ Operands ops, int64_t W,
                      const __grid_constant__ FieldConsts<typename St::S> fc) {
  using S = typename St::S;
  using Gr = Group<G>;
  constexpr int out = MASKED ? 7 : 6, P = Gr::POINTS, ST = Gr::STRIDE;
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
  const int lane = threadIdx.x & 31, grp = lane / G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  group_rcb7<S, G>(sh, grp < Gr::PER_WARP && pt < n, pt, lane % G, fc);
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

// RCB Alg. 9, k times, as two levels of four products each. Slots: 0-2 X Y
// Z; level 1 writes m0-m3 to 3-6:
//   m0 = Y^2, m1 = Y Z, m2 = Z^2, m3 = X Y;
// the glue writes to 7-10: t2 = 3b m2, z3 = 8 m0, y3 = m0 + t2, t0 = m0 - 3 t2;
// level 2 writes n0-n3 to 11-14:
//   n0 = t2 z3, n1 = m1 z3, n2 = t0 y3, n3 = t0 m3;
// and the next X Y Z go to 0-2: X = 2 n3, Y = n0 + n2, Z = n1 (rcb9 above).
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
    group_products<S, G, 4, false>(sh, active, pt, rank, lv2 ? nibbles(7, 4, 10, 10) : nibbles(1, 1, 2, 0),
                            none, lv2 ? nibbles(8, 8, 9, 6) : nibbles(1, 2, 2, 1), none,
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

// G, the threads a point, that K4/K4m (masked) and K5 launch with at width W
// on field shape S (G = 1: proj_add_kernel, one thread a point). A fixed
// table: chip_smoke.py times every built instance at the main path's widths,
// and PERF.md holds the numbers that chose it. Up to ~12k lanes G = 6 is
// fastest everywhere (2 product levels a lane, the most groups); above,
// G = 2 (3 products a thread a level: the least glue repeated across a
// group), except the wide K4 on Pallas's 8 words, where the one-thread
// kernel fits 3-5 blocks an SM and wins above ~32k lanes (profile_msm's
// A/B of this bound). G = 3 and 4 won no K4 width; G = 1 lost every K4m
// width, every K4 width on 12 words and every K5 width; G = 2 lost every K5
// width to G = 4.
template <class S>
int curve_group(int kernel, int64_t W, bool masked) {
  if (kernel == CURVE_K5) return 4;
  if (kernel != CURVE_K4) return 1;
  if (W <= 12288) return 6;
  return S::NW == 8 && !masked && W > 32768 ? 1 : 2;
}

// The instances built on shape S, by G: exactly those curve_group picks (the
// one-thread K4 on 8-word shapes only).
template <class S>
using K4Groups = std::conditional_t<S::NW == 8, std::integer_sequence<int, 1, 2, 6>,
                                    std::integer_sequence<int, 2, 6>>;
using K4mGroups = std::integer_sequence<int, 2, 6>;
using K5Groups = std::integer_sequence<int, 4>;

// fn(std::integral_constant<int, G>{}) for the G of the list equal to g;
// false when the list has none.
template <int... Gs, class Fn>
bool with_group(std::integer_sequence<int, Gs...>, int g, Fn fn) {
  return ((Gs == g && (fn(std::integral_constant<int, Gs>{}), true)) || ...);
}

// The list's Gs into out[0, cap); returns how many it has.
template <int... Gs>
int list_groups(std::integer_sequence<int, Gs...>, int* out, int cap) {
  constexpr int gs[] = {Gs...};
  for (int i = 0; i < cap && i < static_cast<int>(sizeof...(Gs)); ++i) out[i] = gs[i];
  return static_cast<int>(sizeof...(Gs));
}

// The built instances of kernel (K4 with `masked`, K5) on shape S into
// out[0, cap); returns how many there are (0 for a kernel with one design).
template <class S>
int built_groups(int kernel, bool masked, int* out, int cap) {
  if (kernel == CURVE_K5) return list_groups(K5Groups{}, out, cap);
  if (kernel != CURVE_K4) return 0;
  return masked ? list_groups(K4mGroups{}, out, cap) : list_groups(K4Groups<S>{}, out, cap);
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
void launch_k5(int k, const uint64_t* ptrs, const int64_t* lds, int64_t W,
               const FieldConsts<typename St::S>& fc, cudaStream_t s) {
  proj_double_k_group_kernel<St, G><<<Group<G>::grid(W), BLOCK_THREADS, 0, s>>>(
      operands_from_host(ptrs, lds, 6), W, k, fc);
}

// Launch curve kernel `kernel` on storage St; ptrs/lds hold its operands in
// the order of its `ops:` line above (K4m: the mask after the 6 inputs); arg
// is K4's masked flag (K4m when set) or K5's k. K4/K4m and K5 run the
// instance of curve_group's table, or, where group > 0, the instance with G
// = group (the smoke's and the card test's comparison of every instance).
// Refuses field constants that do not fit St's shape, and an instance that
// is not built.
template <class St>
int launch_curve(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
                 int group, const uint32_t* consts, cudaStream_t s) {
  using S = typename St::S;
  if (!fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  const auto fc = field_consts_from_host<S>(consts);
  const unsigned grid = grid_for(W);
  const int g = group > 0 ? group : curve_group<S>(kernel, W, arg != 0);
  switch (kernel) {
    case CURVE_K3:
      aff_pair_add_kernel<St><<<grid, BLOCK_THREADS, 0, s>>>(operands_from_host(ptrs, lds, 11), W,
                                                              fc);
      break;
    case CURVE_K4: {
      const auto k4 = [&](auto G, auto masked) {
        launch_k4<St, decltype(G)::value, decltype(masked)::value>(ptrs, lds, W, fc, s);
      };
      if (!(arg != 0 ? with_group(K4mGroups{}, g, [&](auto G) { k4(G, std::true_type{}); })
                     : with_group(K4Groups<S>{}, g, [&](auto G) { k4(G, std::false_type{}); }))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    }
    case CURVE_K5:
      if (!with_group(K5Groups{}, g, [&](auto G) {
            launch_k5<St, decltype(G)::value>(arg, ptrs, lds, W, fc, s);
          })) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
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
                      int group, const uint32_t* consts, cudaStream_t s);
CurveUnit limbs_fp32, packed_fp32, limbs_fp33, packed_fp33, limbs_fp22c, packed_fp22c,
    fma51_fp22c;

}  // namespace wei
}  // namespace msm
