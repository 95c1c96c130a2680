// The group design of the curve kernels: G threads of one warp own a point
// and split each level of a formula's independent products among them.
// Used by the Weierstrass K3, K4, K4m, K5 and K7 (curve.cuh) and the
// Edwards K11 and K12 (edwards.cu).
//
// A block of BLOCK_THREADS threads handles Group<G>::POINTS points: each warp
// holds 32 / G groups of G consecutive threads (a group never straddles a
// warp; with G = 3 or 6 two threads a warp idle). The block stages its
// points' input coordinates in shared memory (a storage's load: rows become
// register words once, lanes contiguous across the block's threads), each
// group then runs its formula's levels of independent products, G threads
// at a time, one product per thread per round (a loop around one mont_mul
// call), exchanging values through shared memory between levels
// (__syncwarp), and the block stores the outputs as it loaded the inputs
// (lanes contiguous). Every product and add on any thread of a group takes
// and returns values < 2p, as the one-thread kernels' do.
#pragma once

#include <type_traits>
#include <utility>

#include "field.cuh"

namespace msm {

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
__host__ __device__ constexpr uint32_t nibbles(int a0, int a1 = 0, int a2 = 0, int a3 = 0,
                                               int a4 = 0, int a5 = 0) {
  return a0 | a1 << 4 | a2 << 8 | a3 << 12 | a4 << 16 | static_cast<uint32_t>(a5) << 20;
}
__device__ __forceinline__ int nib(uint32_t t, int j) { return (t >> (4 * j)) & 15; }

// slot t_j + slot u_j, or slot t_j - slot u_j where bit j of `sub` is set
// (u_j == NONE: slot t_j alone), without a branch on the table; slot t_j
// alone where no product of the level sums (SUMS false).
template <class S, int STRIDE, bool SUMS>
__device__ __forceinline__ Fe<S> sh_operand(const uint32_t* sh, uint32_t t, uint32_t u,
                                            uint32_t sub, int j, int pt,
                                            const FieldConsts<S>& fc) {
  if constexpr (!SUMS) return sh_get<S, STRIDE>(sh, nib(t, j), pt);
  const int k = nib(u, j);
  const Fe<S> a = sh_get<S, STRIDE>(sh, nib(t, j), pt);
  const Fe<S> b = fe_select(k == NONE, fe_zero<S>(), sh_get<S, STRIDE>(sh, k == NONE ? 0 : k, pt));
  return (sub >> j) & 1u ? f_sub(a, b, fc) : f_add(a, b, fc);
}

// One level of np independent products of a group: product j = (a_j +- a'_j)
// * (b_j +- b'_j) into slot out + j (the signs: bit j of sa, sb), for j =
// rank, rank + G, ... (one mont_mul call site, so the loop body stays one
// product's code); then the warp syncs.
template <class S, int G, bool SUMS>
__device__ __forceinline__ void group_products(uint32_t* sh, bool active, int pt, int rank, int np,
                                               uint32_t a, uint32_t a2, uint32_t sa, uint32_t b,
                                               uint32_t b2, uint32_t sb, int out,
                                               const FieldConsts<S>& fc) {
  constexpr int STRIDE = Group<G>::STRIDE;
  if (active) {
#pragma unroll 1
    for (int j = rank; j < np; j += G) {
      const Fe<S> x = sh_operand<S, STRIDE, SUMS>(sh, a, a2, sa, j, pt, fc);
      const Fe<S> y = sh_operand<S, STRIDE, SUMS>(sh, b, b2, sb, j, pt, fc);
      sh_put<S, STRIDE>(sh, out + j, pt, mont_mul(x, y, fc));
    }
  }
  __syncwarp();
}

// ---- the instance lists of a kernel with several designs ---------------------
// A list std::integer_sequence<int, G...> names the instances built, by G (1:
// the one-thread kernel).

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

}  // namespace msm
