// K10, K11, K12: twisted-Edwards (a = -1) extended-coordinate formulas on
// (22, W) limb tensors in Montgomery form (any n on a shape made on
// demand), G threads a point (the group design, group.cuh); K10 also one
// thread a lane where its width table picks it.
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
// What bounds them on an H100. K10 runs wide and once a round: 942,080
// lanes and the compact residual's 32,768 at 2^16 (983,040 and 32,768 on
// ed25519's 9 words). Its bound is bytes (8 limb rows in, 8 out, 4 flags:
// 0.2025 ms at 942,080 lanes) with the ten products' multiply-adds just
// below it; what it hits is instruction issue of those products. One
// thread a lane walked the ten products one after another (108 registers
// and 6.3k SASS instructions on 8 words; 148 on 9 words; at n = 63 255
// registers, a 280 B stack and 576 B spilled): 56 % of its bound on
// ed-on-bls12-377, 45 % on ed25519, 15 % at n = 39 and 63. The group design
// (ed_pair_add_group_kernel) splits the products among G threads of a warp
// in rounds that wait on the formula's four dependent products (x y, T1
// T2, C, X3) and no more: G = 2 keeps every thread busy in five rounds, G =
// 4 takes four, 10 products in 16 thread-slots (47 and 42 registers, 3.9k
// and 3.3k SASS instructions on 8 words; n = 63 128 registers, no stack
// frame, no spill). Wide, time follows the warp-rounds a point takes (5 /
// 16 at G = 2, as the one-thread kernel's 10 / 32; 4 / 8 at G = 4, 1.5x
// slower), so k10_group (below) keeps the one-thread kernel at Fp22's
// widest launch and on shapes made on demand of up to 8 words (short
// products), G = 2 below it on Fp22 and on the shapes made on demand where
// it fits, G = 4 where shared memory rules (above 18 words). Keeping blocks
// resident and bringing each next tile's limbs into shared memory by
// cp.async under the products ran slower at every width that matters
// (PERF.md): the staging buffer halves the blocks an SM holds. K11 runs from 765,463 lanes down to 1 (the tree,
// the sub-rounds' 23,552 lanes 19 times, reduce_buckets_log down to 23, 22
// Horner adds on one lane). One thread a lane (126 registers, 6.5k SASS
// instructions) walked hwcd-3's 9 products one after another, ~9 us a
// launch at every width up to ~12k lanes; the group design waits on 3
// dependent levels instead (A B TT D, then C, then X Y Z T: K12's levels on
// two points), 2.4k instructions and 39 registers at G = 4, ~5.3 us at
// narrow widths; wide, both sit at ~1.5x their byte bound (K11_GROUP
// below). K12 runs narrow (23 and 1 lanes on the padded path) and long (k
// = 5 and 11 doublings), so latency bounds it: one thread a lane waited on
// hwcd-3's 9 products a doubling one after another (that design went:
// slower at every width). Its group design waits on 3 dependent levels a
// doubling (K11's levels on one point). Removing the middle level
// (carrying k T, a 13-bit add chain of ~20 field additions, in the glue)
// would trade one product for a longer chain, as above.
#include "group.cuh"

namespace msm {
namespace ed {

// ed-on-bls12-377's base field (n = 22, R = 2^264) is the one Edwards field
// of the main library; a library built for a shape made on demand (n = 1..63:
// ed25519's field, n = 22 in 9 words, among them) takes that shape. K11's 14
// slots and K12's 10 at G = 4 fit the 48 KB of static shared memory up to 24
// words.
#ifdef MSM_DYN_SHAPE
using S = DynShape;
#else
using S = Fp22;
#endif
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

// ---- K10: fused level-1 pair add of two signed affine slots -----------------
// One thread a lane: the plain design, G = 1 (a template, so that only a
// library whose table picks it builds it).
// ops: x1 y1 s1 v1 x2 y2 s2 v2 X3 Y3 Z3 T3
template <int G>
__global__ void __launch_bounds__(BLOCK_THREADS)
ed_pair_add_kernel(const __grid_constant__ Operands ops, int64_t W,
                   const __grid_constant__ FieldConsts fc) {
  static_assert(G == 1, "the one-thread kernel");
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

// K10 as rounds of products of a group (group.cuh), G = 2 or 4 threads a
// point. The block stages k R and D = 2R to slots 0, 1 and x1, y1, x2, y2 to
// 2-5, each with its sign and valid flag applied (the identity (0, 1) on
// an invalid slot, the sign negating x: K3's staging, aff_pair_add_group_kernel).
// hwcd3_unitz's ten products, T1 = x1 y1, T2 = x2 y2, A = (y1 - x1)(y2 - x2),
// B = (y1 + x1)(y2 + x2), TT = T1 T2, C = TT (k R), X3 = (B - A)(D - C),
// Y3 = (D + C)(B + A), Z3 = (D - C)(D + C), T3 = (B - A)(B + A), wait on
// four dependent products (x y, T1 T2, C, X3: C = k x1 y1 x2 y2 has five
// factors, so three levels, and X3, Y3, Z3 take C), and T3 needs only A and
// B. The rounds, one product a thread at most (each operand's sum or
// difference formed by the thread that takes the product; every value
// < 2p; a round reads no slot that it writes, and the warp syncs between
// rounds):
//   G = 4: {T1 T2 A B} -> 6-9, {TT T3} -> 2-3, {C} -> 4, {X3 Y3 Z3} -> 5-7:
//          four rounds, the critical path, 10 of 16 thread-products busy;
//   G = 2: {T1 T2} -> 6-7, {TT A} -> 8-9, {C B} -> 6-7, {X3 Y3} -> 2-3,
//          {Z3 T3} -> 4-5: five rounds, every thread busy in each (ten
//          products on two threads take five; B waits for the round C
//          takes, as the chain x y, T1 T2, C allows).
// The outputs are hwcd3's values, equal mod p to the one-thread kernel's
// and the twin's (which takes C as (T1 k R) T2).
// ops: x1 y1 s1 v1 x2 y2 s2 v2 X3 Y3 Z3 T3
constexpr int K10_SLOTS = 10;

template <int G>
__global__ void __launch_bounds__(BLOCK_THREADS)
ed_pair_add_group_kernel(const __grid_constant__ Operands ops, int64_t W,
                         const __grid_constant__ FieldConsts fc) {
  static_assert(G == 2 || G == 4, "K10's rounds are laid out for G = 2 and G = 4");
  using Gr = Group<G>;
  constexpr int P = Gr::POINTS, ST = Gr::STRIDE;
  __shared__ uint32_t sh[K10_SLOTS * S::NW * ST];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * P;
  const int n = static_cast<int>(W - base < P ? W - base : P);  // this block's points
  const Fe zero = fe_zero<S>(), one = fe_from<S>(fc.one);
  for (int i = threadIdx.x; i < 4 * P; i += BLOCK_THREADS) {
    const int c = i / P, pt = i % P;  // c: x1 y1 x2 y2
    if (pt >= n) continue;
    const int side = 4 * (c >> 1);
    const bool is_y = c & 1;
    const bool v = load_flag(ops, side + 3, base + pt), s = load_flag(ops, side + 2, base + pt);
    const Fe a = load_reduced(ops, side + is_y, base + pt, fc);
    // the identity (0, 1) on an invalid slot, before any arithmetic
    sh_put<S, ST>(sh, 2 + c, pt, is_y ? fe_select(v, a, one) : fe_select(v, f_cneg(a, s, fc), zero));
  }
  for (int pt = threadIdx.x; pt < n; pt += BLOCK_THREADS) {
    sh_put<S, ST>(sh, 0, pt, fe_from<S>(fc.curve[0]));
    sh_put<S, ST>(sh, 1, pt, fe_from<S>(fc.curve[1]));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = lane / G, rank = lane % G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  const bool active = grp < Gr::PER_WARP && pt < n;
  // each round's table: operands (a +- a2)(b +- b2), a difference where bit
  // j of sa (sb) is set, product j into slot out + j
  constexpr int N_ = NONE;
  if constexpr (G == 4) {
    group_products<S, G, true>(sh, active, pt, rank, 4, nibbles(2, 4, 3, 3),
                               nibbles(N_, N_, 2, 2), 0b0100, nibbles(3, 5, 5, 5),
                               nibbles(N_, N_, 4, 4), 0b0100, 6, fc);
    group_products<S, G, true>(sh, active, pt, rank, 2, nibbles(6, 9), nibbles(N_, 8), 0b10,
                               nibbles(7, 9), nibbles(N_, 8), 0, 2, fc);
    group_products<S, G, false>(sh, active, pt, rank, 1, nibbles(2), nibbles(N_), 0, nibbles(0),
                                nibbles(N_), 0, 4, fc);
    group_products<S, G, true>(sh, active, pt, rank, 3, nibbles(9, 1, 1), nibbles(8, 4, 4), 0b101,
                               nibbles(1, 9, 1), nibbles(4, 8, 4), 0b001, 5, fc);
  } else {
    group_products<S, G, false>(sh, active, pt, rank, 2, nibbles(2, 4), nibbles(N_, N_), 0,
                                nibbles(3, 5), nibbles(N_, N_), 0, 6, fc);
    group_products<S, G, true>(sh, active, pt, rank, 2, nibbles(6, 3), nibbles(N_, 2), 0b10,
                               nibbles(7, 5), nibbles(N_, 4), 0b10, 8, fc);
    group_products<S, G, true>(sh, active, pt, rank, 2, nibbles(8, 3), nibbles(N_, 2), 0,
                               nibbles(0, 5), nibbles(N_, 4), 0, 6, fc);
    group_products<S, G, true>(sh, active, pt, rank, 2, nibbles(7, 1), nibbles(9, 6), 0b01,
                               nibbles(1, 7), nibbles(6, 9), 0b01, 2, fc);
    group_products<S, G, true>(sh, active, pt, rank, 2, nibbles(1, 7), nibbles(6, 9), 0b11,
                               nibbles(1, 7), nibbles(6, 9), 0, 4, fc);
  }
  __syncthreads();
  // X3 Y3 Z3 T3's slots
  constexpr uint32_t out = G == 4 ? nibbles(5, 6, 7, 3) : nibbles(2, 3, 4, 5);
  for (int i = threadIdx.x; i < 4 * P; i += BLOCK_THREADS) {
    const int c = i / P, q = i % P;
    if (q < n) store_out(ops, 8 + c, base + q, sh_get<S, ST>(sh, nib(out, c), q));
  }
}

// K10's G, the threads a point, at width W (1: the one-thread kernel): a
// fixed table from chip_smoke.py's timings of every instance in turns at
// the padded path's widths, with their code flushed from the L2 (as in the
// MSM, after the slot gather), and alone and in the padded MSM with each
// instance forced (PERF.md keeps the numbers, G = 4 on Fp22 among them). On
// Fp22, G = 2 up to 262,144 lanes (five rounds, no thread idle: the
// residual's 32,768 lanes), then the one-thread kernel (its ten products
// inline; the main round's 942,080 lanes). A shape made on demand takes
// one instance: the one-thread kernel up to 8 words (on 2-3 words one
// thread's products are short and G = 2 ran 40-63 % slower), G = 2 where a
// block's 10 slots fit the 48 KB of static shared memory at 64 points (up
// to 18 words), else G = 4 (32 points, 31,680 B at 24 words).
constexpr bool k10_fits(int G) {
  return K10_SLOTS * S::NW * (32 / G * (BLOCK_THREADS / 32) + 1) * 4 <= 48 * 1024;
}
constexpr int K10_DYN_GROUP = S::NW <= 8 ? 1 : k10_fits(2) ? 2 : 4;
int k10_group(int64_t W) {
  if constexpr (S::DYN) return K10_DYN_GROUP;
  return W <= 262144 ? 2 : 1;
}
// The instances built: exactly the ones k10_group picks.
using K10Groups = std::conditional_t<S::DYN, std::integer_sequence<int, K10_DYN_GROUP>,
                                     std::integer_sequence<int, 1, 2>>;

// ---- K11: unified extended add, optionally masked, G threads a point ---------
// hwcd-3 on two points as three levels of products (group.cuh), K12's
// levels with P2's coordinates as the second operands. Slots: 0-3 X1 Y1
// Z1 T1, 4-7 X2 Y2 Z2 T2, 8 the constant k R; level 1 writes to 9-12
//   A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2), TT = T1 T2, D = Z1 (Z2 + Z2);
// level 2 writes C = TT (k R) to 13; level 3 writes X3 Y3 Z3 T3 to 0-3:
//   X3 = (B - A)(D - C), Y3 = (D + C)(B + A), Z3 = (D - C)(D + C), T3 = (B - A)(B + A),
// hwcd3's E F, G H, F G, E H, each operand's sum or difference formed by the
// thread that takes the product; every value < 2p. A level reads no slot
// that it writes, and the warp syncs between levels. Where MASKED and the
// mask is 0, the block stores P1's stored limbs, bit for bit, as the plain
// twin and K4m do (not the reduced P1 the loads give, which is equal mod p
// but not the limbs the caller gave).
// ops: X1 Y1 Z1 T1 X2 Y2 Z2 T2 [mask] X3 Y3 Z3 T3
template <int G, bool MASKED>
__global__ void __launch_bounds__(BLOCK_THREADS)
ed_add_group_kernel(const __grid_constant__ Operands ops, int64_t W,
                    const __grid_constant__ FieldConsts fc) {
  using Gr = Group<G>;
  constexpr int P = Gr::POINTS, ST = Gr::STRIDE;
  __shared__ uint32_t sh[14 * S::NW * ST];
  __shared__ bool keep[P];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * P;
  const int n = static_cast<int>(W - base < P ? W - base : P);  // this block's points
  for (int i = threadIdx.x; i < 8 * P; i += BLOCK_THREADS) {
    const int c = i / P, pt = i % P;
    if (pt < n) sh_put<S, ST>(sh, c, pt, load_reduced(ops, c, base + pt, fc));
  }
  for (int pt = threadIdx.x; pt < n; pt += BLOCK_THREADS) {
    sh_put<S, ST>(sh, 8, pt, fe_from<S>(fc.curve[0]));
    if (MASKED) keep[pt] = load_flag(ops, 8, base + pt);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = lane / G, rank = lane % G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  const bool active = grp < Gr::PER_WARP && pt < n;
  // each level's table: operands (a +- a2)(b +- b2), a difference where
  // bit j of sa (sb) is set, product j into slot out + j
  constexpr uint32_t none = nibbles(NONE, NONE, NONE, NONE);
  group_products<S, G, true>(sh, active, pt, rank, 4, nibbles(1, 1, 3, 2),
                             nibbles(0, 0, NONE, NONE), 0b0001, nibbles(5, 5, 7, 6),
                             nibbles(4, 4, NONE, 6), 0b0001, 9, fc);
  group_products<S, G, false>(sh, active, pt, rank, 1, nibbles(11), none, 0, nibbles(8), none, 0,
                              13, fc);
  group_products<S, G, true>(sh, active, pt, rank, 4, nibbles(10, 12, 12, 10),
                             nibbles(9, 13, 13, 9), 0b1101, nibbles(12, 10, 12, 10),
                             nibbles(13, 9, 13, 9), 0b0001, 0, fc);
  __syncthreads();
  constexpr int out = MASKED ? 9 : 8;
  for (int i = threadIdx.x; i < 4 * P; i += BLOCK_THREADS) {
    const int c = i / P, q = i % P;
    if (q >= n) continue;
    if (MASKED && !keep[q]) {  // P1's stored limbs, bit for bit
      copy_rows<S::NL>(ops, c, out + c, base + q);
    } else {
      store_out(ops, out + c, base + q, sh_get<S, ST>(sh, c, q));
    }
  }
}

// K11's G, the threads a point: 4, a level of at most 4 products in one
// round, at every width, masked or not. Measured beside it and removed
// (PERF.md keeps the times): G = 2 (won no width); the one-thread kernel,
// 17-21 % behind per Edwards MSM, ahead only at 32,768 < W <= 65,536 by
// less than the spread between turns, and masked 1.3-2.1x behind (its
// warps diverge on the mask).
constexpr int K11_GROUP = 4;

// ---- K12: k chained unified doublings, G threads a point (group.cuh) ------
// hwcd-3 with both operands equal, as three levels of products a doubling.
// Slots: 0-3 X Y Z T, 8 the constant k R; level 1 writes to 4-7
//   A = (Y - X)(Y - X), B = (Y + X)(Y + X), TT = T T, D = Z (Z + Z);
// level 2 writes C = TT (k R) to 9; level 3 writes the next X Y Z T to 0-3:
//   X = (B - A)(D - C), Y = (D + C)(B + A), Z = (D - C)(D + C), T = (B - A)(B + A),
// that is E F, G H, F G, E H with E = B - A, F = D - C, G = D + C, H = B + A:
// hwcd3's values mod p (D = 2 Z Z as one product, each operand's sum or
// difference formed by the thread that takes the product), every value
// < 2p, so the chain re-enters with its input bound at every doubling. A
// level reads no slot that it writes, and the warp syncs between levels.
// ops: X1 Y1 Z1 T1 X3 Y3 Z3 T3
template <int G>
__global__ void __launch_bounds__(BLOCK_THREADS)
ed_double_k_group_kernel(const __grid_constant__ Operands ops, int64_t W, int k,
                         const __grid_constant__ FieldConsts fc) {
  using Gr = Group<G>;
  constexpr int P = Gr::POINTS, ST = Gr::STRIDE;
  __shared__ uint32_t sh[10 * S::NW * ST];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * P;
  const int n = static_cast<int>(W - base < P ? W - base : P);  // this block's points
  for (int i = threadIdx.x; i < 4 * P; i += BLOCK_THREADS) {
    const int c = i / P, pt = i % P;
    if (pt < n) sh_put<S, ST>(sh, c, pt, load_reduced(ops, c, base + pt, fc));
  }
  for (int pt = threadIdx.x; pt < n; pt += BLOCK_THREADS) {
    sh_put<S, ST>(sh, 8, pt, fe_from<S>(fc.curve[0]));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = lane / G, rank = lane % G;
  const int pt = (threadIdx.x >> 5) * Gr::PER_WARP + grp;
  const bool active = grp < Gr::PER_WARP && pt < n;
  // each level's table: operands (a +- a2)(b +- b2), a difference where
  // bit j of sa (sb) is set, product j into slot out + j
  const auto lv = [](int step, uint32_t l1, uint32_t l2, uint32_t l3) {
    const int l = step % 3;
    return l == 0 ? l1 : l == 1 ? l2 : l3;
  };
  constexpr uint32_t none = nibbles(NONE, NONE, NONE, NONE);
#pragma unroll 1
  for (int step = 0; step < 3 * k; ++step) {
    group_products<S, G, true>(
        sh, active, pt, rank, lv(step, 4, 1, 4),
        lv(step, nibbles(1, 1, 3, 2), nibbles(6), nibbles(5, 7, 7, 5)),
        lv(step, nibbles(0, 0, NONE, NONE), none, nibbles(4, 9, 9, 4)),
        lv(step, 0b0001, 0, 0b1101),
        lv(step, nibbles(1, 1, 3, 2), nibbles(8), nibbles(7, 5, 7, 5)),
        lv(step, nibbles(0, 0, NONE, 2), none, nibbles(9, 4, 9, 4)),
        lv(step, 0b0001, 0, 0b0001), lv(step, 4, 9, 0), fc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * P; i += BLOCK_THREADS) {
    const int c = i / P, q = i % P;
    if (q < n) store_out(ops, 4 + c, base + q, sh_get<S, ST>(sh, c, q));
  }
}

// K12's G, the threads a point: 4, a level of 4 products in one round, at
// every width. chip_smoke.py times it beside its plain twin at K12's
// widths on the Edwards paths (23 and 1 lanes); PERF.md keeps the numbers of
// the instances measured beside it and removed: G = 2 (1.6x behind from 1
// to 4,096 lanes, ahead only at 65,536, which no path runs) and the
// one-thread kernel (2x behind).
constexpr int K12_GROUP = 4;

}  // namespace ed
}  // namespace msm

// Each entry point takes a field shape's ID (field.cuh) and refuses any but
// S's (Fp22, or the DynShape of a library made on demand), and field
// constants that do not fit it (a Pallas field: n = 22 too).
// group: 0 for the instance k10_group picks at width W, else the G of a
// built instance (the smoke's and the card test's comparison of every
// instance); refuses one that is not built.
extern "C" int msm_ed_pair_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                               int group, const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::ed;
  if (shape != S::ID || !fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto fc = field_consts_from_host<S>(consts);
  const Operands ops = operands_from_host(ptrs, lds, 12);
  const bool built = with_group(K10Groups{}, group > 0 ? group : k10_group(W), [&](auto G) {
    constexpr int g = decltype(G)::value;
    if constexpr (g == 1) {
      ed_pair_add_kernel<g><<<grid_for(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
    } else {
      ed_pair_add_group_kernel<g><<<Group<g>::grid(W), BLOCK_THREADS, 0, s>>>(ops, W, fc);
    }
  });
  if (!built) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The G of the instance msm_ed_pair_add launches at width W when group is
// 0; -1 for another shape than the library's.
extern "C" int msm_ed_pair_add_group(int shape, int64_t W) {
  return shape == msm::ed::S::ID ? msm::ed::k10_group(W) : -1;
}

// The Gs of K10's built instances into out[0, cap); returns how many there
// are, -1 for another shape than the library's.
extern "C" int msm_ed_pair_add_groups(int shape, int* out, int cap) {
  return shape == msm::ed::S::ID ? msm::list_groups(msm::ed::K10Groups{}, out, cap) : -1;
}

// masked != 0: ptrs/lds hold the mask (a per-lane flag) after the 8 inputs.
extern "C" int msm_ed_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                          int masked, const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::ed;
  if (shape != S::ID || !fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto fc = field_consts_from_host<S>(consts);
  const Operands ops = operands_from_host(ptrs, lds, masked ? 13 : 12);
  const dim3 grid = Group<K11_GROUP>::grid(W);
  if (masked) {
    ed_add_group_kernel<K11_GROUP, true><<<grid, BLOCK_THREADS, 0, s>>>(ops, W, fc);
  } else {
    ed_add_group_kernel<K11_GROUP, false><<<grid, BLOCK_THREADS, 0, s>>>(ops, W, fc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msm_ed_double_k(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                               int k, const uint32_t* consts, void* stream) {
  using namespace msm;
  using namespace msm::ed;
  if (shape != S::ID || !fits<S>(consts)) return static_cast<int>(cudaErrorInvalidValue);
  ed_double_k_group_kernel<K12_GROUP>
      <<<Group<K12_GROUP>::grid(W), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          operands_from_host(ptrs, lds, 8), W, k, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}
