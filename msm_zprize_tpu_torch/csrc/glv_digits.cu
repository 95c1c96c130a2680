// K2: GLV decomposition fused with signed c-bit windowing of both halves.
// K9: signed c-bit windowing alone (no GLV), the twisted-Edwards scalar prep.
//
// K2 replaces msm_zprize_tpu/fields/pallas_scalar.py::glv_digits_pallas (body
// _scalar_kernel). Per scalar lane s (22 canonical 12-bit limbs of the
// scalar field; BLS12-377's, BLS12-381's and Pallas's GlvScalar modules all
// have the sizes below, and their constants come at run time; any other w =
// 12 GlvScalar, such as BN462's, takes a library built for its sizes, in
// which the same code runs on the word counts they give):
//   u_i = floor(s * m_i / 2^(12*K0))  mod 2^(12*(n_half+1))     (i = 0, 1)
//   s0  = s - (x0*v00 + x1*v10),  s1 = -(x0*v01 + x1*v11)   mod 2^(12*n_acc)
//   (sign_i, |s_i|) from the two's-complement top bit, |s_i| mod 2^(12*n_half)
// then the signed-digit recoding of |s0| and |s1| into K windows of c bits,
// and magnitude 0 on the columns whose point is at infinity (glv_prep's mask;
// signs untouched). The TPU body runs this on 12-bit limbs because the TPU
// has no wide integer product; Hopper has one, so K2 computes the SAME
// integers on 32-bit words with 32 x 32 -> 64-bit products:
//   * s: the 22 limbs repacked into 8 words (s < q < 2^256). m_i: 5 words
//     (13 limbs, < 2^156); v_ij: 5 words (11 limbs, < 2^132); the host packs
//     them (fields/cuda_scalar.py::_const_words).
//   * The shift 12*K0 = 276 = 8 words + 20 bits: u_i is words 8..12 of the
//     full 8 x 5-word product shifted right by 20 bits. s * m_i < 2^(255 +
//     156) = 2^411, so floor(s m_i / 2^276) < 2^135: the limb path's
//     truncation to 12 limbs (2^144) drops nothing, and neither does the
//     word path's (5 words, then masked to 144 bits as the limb path keeps).
//   * The four low products u_i * v_ij and the two combines run modulo 2^160
//     (5 words) where the limb path runs modulo 2^156 (13 limbs). 2^156
//     divides 2^160, so every bit below 156 is the limb path's bit, and only
//     those are read: the sign is bit 155, the magnitude the low 132 bits of
//     the value or of its negation. The planes are bit-identical to the limb
//     path's (the TPU body, GlvScalar.decompose + signed_digits), zero
//     digits carrying sign 0 included; tests/test_torch_scalar.py holds a
//     Python model of this word algorithm against both.
//   * Digits stream out of a 64-bit bit buffer refilled one word at a time
//     (a few instructions a window for any run-time c in 1..MAX_C), not from
//     a sweep over 11 limbs a window. A refill comes when fewer than c bits
//     are left, so at most c - 1 <= 29 bits sit below the 32 it adds: the
//     buffer never holds more than 61, and at least c after the refill.
// Two threads a scalar, one a GLV half: the two sit 16 lanes apart in one
// warp; each computes one u_i and takes the other's by a warp shuffle, then
// forms its own s_i and writes its own K windows. (One thread a scalar,
// both halves, was measured beside it and removed: level at 2^16, 1-3 %
// behind at 2^20.) A scalar reads 22 int32 and its 2 mask words and writes
// 2 x 2K int32, for ~260 32-bit multiply-adds: memory-bound.
//
// K9 replaces msm_zprize_tpu/fields/pallas_scalar.py::simple_digits_pallas
// (body _simple_kernel): per scalar lane, window k takes bits [k c, (k+1) c)
// of the canonical 12-bit limbs, adds the carry of window k-1, and recodes
// into a magnitude in [0, 2^(c-1)] and a sign (0 for a zero digit). The
// same int algorithm as the TPU body and scalar.py::signed_digits, so the
// planes are bit-identical. At the Edwards 2^16 shape it reads 21 and writes
// 2 x 23 int32 per lane with no multiplies: memory- and launch-bound. The
// limb count n is a runtime value (the scalar field's, 21 here), so each
// window reads its one to three limbs straight from global memory (L1
// serves the repeats) instead of staging them in registers.
#include "field.cuh"

namespace msm {

// The widest window both entries take (fields/cuda_scalar.py::MAX_C): the
// reference recoding (scalar.py::signed_digits) holds window + carry <= 2^c
// and 2^c itself in int32, exact for c <= 30. Both kernels compute in 32
// bits: K2's buffer is above; K9 shifts a limb left by the bits it has so
// far, at most c - 1 <= 29.
constexpr int MAX_C = 30;

// The limb sizes of the Python GlvScalar this kernel is built for (the entry
// refuses others), and the words of s.
#ifdef MSM_DYN_SCALAR
// A library built for one scalar module made on demand (_build.scalar_library
// passes its limb sizes and the words of s, a macro each, as it does a field
// shape's): any w = 12 GlvScalar, BN462's q (NS = 39, NH = 20, NACC = 22,
// K0L = 40, NM = 21, SW = 15; MW = 8, VW = 8, AW = 9) among them.
constexpr int NS = MSM_DYN_NS;
constexpr int NH = MSM_DYN_NH;
constexpr int NACC = MSM_DYN_NACC;
constexpr int K0L = MSM_DYN_K0L;
constexpr int NM = MSM_DYN_NM;
constexpr int SW = MSM_DYN_SW;                    // words of s: ceil(bits(q) / 32)
constexpr int MW = (LIMB_BITS * NM + 31) / 32;    // words of m_i
constexpr int VW = (LIMB_BITS * NH + 31) / 32;    // words of v_ij
constexpr int AW = (LIMB_BITS * NACC + 31) / 32;  // words of u_i and of the accumulators
#else
constexpr int NS = 22;    // scalar limbs (bits(q) = 253 or 255)
constexpr int NH = 11;    // limbs of |s_i|
constexpr int NACC = 13;  // two's-complement accumulator limbs
constexpr int K0L = 23;   // multiply-high shift, in limbs
constexpr int NM = 13;    // limbs of m_0, m_1
// Their word forms.
constexpr int SW = 8;                          // words of s
constexpr int MW = 5;                          // words of m_i
constexpr int VW = 5;                          // words of v_ij
constexpr int AW = 5;                          // words of u_i and of the accumulators
#endif
constexpr int SHIFT_W = LIMB_BITS * K0L / 32;     // 8 (BN462: 15)
constexpr int SHIFT_B = LIMB_BITS * K0L % 32;     // 20 (BN462: 0, a whole-word shift)
constexpr int U_BITS = LIMB_BITS * (NH + 1);      // u mod 2^144
constexpr int SIGN_BIT = LIMB_BITS * NACC - 1 - 32 * (AW - 1);  // bit 155 of the accumulator
constexpr int MAG_BITS = LIMB_BITS * NH;          // |s_i| mod 2^132
static_assert(MW == (LIMB_BITS * NM + 31) / 32 && VW == (LIMB_BITS * NH + 31) / 32 &&
              AW == (LIMB_BITS * NACC + 31) / 32 && 32 * AW >= U_BITS &&
              SHIFT_W < SW + MW && AW <= SW && SIGN_BIT > 0 && SIGN_BIT < 32,
              "the word sizes must be the fewest that hold the limb sizes");

// a mod 2^BITS in place: words wholly at or above bit BITS cleared, the word
// that BITS cuts masked (on the sizes above, the top word alone).
template <int BITS, int N>
__device__ __forceinline__ void keep_bits(uint32_t (&a)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (32 * (k + 1) <= BITS) continue;
    a[k] = 32 * k >= BITS ? 0u : a[k] & ((1u << (BITS - 32 * k)) - 1);
  }
}

struct GlvConsts {
  int32_t dims[5];     // n, n_half, n_acc, K0_limbs, n_m as the Python side has them
  int32_t sg[4];       // static sign of each term: +1 subtracts, -1 adds
  uint32_t m[2][MW];   // m0, m1
  uint32_t v[4][VW];   // v00, v10, v01, v11 (terms a, b, c, d), |v|
};

// s: the canonical limbs at `lane`, repacked into words (bits past 2^256 are
// 0 below q).
__device__ __forceinline__ void load_scalar(uint32_t (&w)[SW], const int32_t* __restrict__ s,
                                            int64_t lds, int64_t lane) {
#pragma unroll
  for (int i = 0; i < SW; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const uint32_t limb = static_cast<uint32_t>(__ldg(s + i * lds + lane));
    const int bit = LIMB_BITS * i, k = bit >> 5, off = bit & 31;
    if (k < SW) w[k] |= limb << off;
    if (off + LIMB_BITS > 32 && k + 1 < SW) w[k + 1] |= limb >> (32 - off);
  }
}

// u = floor(s * m / 2^(12*K0L)) mod 2^144: the full product (the low words
// give the carries), then words SHIFT_W.. shifted right by SHIFT_B bits (the
// words past the product's are 0).
__device__ __forceinline__ void mul_shift(uint32_t (&u)[AW], const uint32_t (&s)[SW],
                                          const uint32_t (&m)[MW]) {
  uint32_t p[SW + MW];
#pragma unroll
  for (int k = 0; k < SW; ++k) p[k] = 0;
#pragma unroll
  for (int j = 0; j < MW; ++j) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < SW; ++i) {
      c += static_cast<uint64_t>(s[i]) * m[j] + p[i + j];
      p[i + j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    p[SW + j] = static_cast<uint32_t>(c);
  }
#pragma unroll
  for (int k = 0; k < AW; ++k) {
    const int w = SHIFT_W + k;
    const uint32_t lo = w < SW + MW ? p[w] : 0u;
    if constexpr (SHIFT_B == 0) {
      u[k] = lo;
    } else {
      u[k] = (lo >> SHIFT_B) | (w + 1 < SW + MW ? p[w + 1] << (32 - SHIFT_B) : 0u);
    }
  }
  keep_bits<U_BITS>(u);
}

// acc = acc - t (sub) or acc + t, modulo 2^(32 AW); t = u * v mod 2^(32 AW).
// `sub` may differ between threads: the negation is a complement and a
// carry-in, no branch.
__device__ __forceinline__ void mul_acc(uint32_t (&acc)[AW], const uint32_t (&u)[AW],
                                        const uint32_t (&v)[VW], bool sub) {
  uint32_t t[AW];
#pragma unroll
  for (int k = 0; k < AW; ++k) t[k] = 0;
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i + j < AW; ++i) {
      c += static_cast<uint64_t>(u[i]) * v[j] + t[i + j];
      t[i + j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
  }
  uint64_t c = sub ? 1 : 0;
#pragma unroll
  for (int k = 0; k < AW; ++k) {
    c += static_cast<uint64_t>(acc[k]) + (sub ? ~t[k] : t[k]);
    acc[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// The sign (bit SIGN_BIT of the top word: bit 155) of a two's-complement
// accumulator, and its magnitude's low MAG_BITS (132) bits in place.
__device__ __forceinline__ uint32_t sign_abs(uint32_t (&a)[AW]) {
  const uint32_t top = (a[AW - 1] >> SIGN_BIT) & 1u;
  uint64_t c = top;
#pragma unroll
  for (int k = 0; k < AW; ++k) {
    c += top ? ~a[k] : a[k];
    a[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  keep_bits<MAG_BITS>(a);
  return top;
}

// Signed c-bit digits of the magnitude a, signs XOR g, magnitudes 0 where
// `masked`; digit k goes to row k of the (K, row_len) planes at column `col`.
// The windows stream out of a 64-bit buffer holding `have` unread bits,
// refilled a word at a time from the front of a queue of the words left.
__device__ __forceinline__ void digits(const uint32_t (&a)[AW], uint32_t g, bool masked, int c,
                                       int K, int32_t* __restrict__ mags,
                                       int32_t* __restrict__ signs, int64_t row_len,
                                       int64_t col) {
  const uint32_t half = 1u << (c - 1), full = 1u << c;
  uint32_t q[AW - 1];
#pragma unroll
  for (int k = 0; k < AW - 1; ++k) q[k] = a[k + 1];
  uint64_t buf = a[0];
  int have = 32;
  uint32_t carry = 0;
  int64_t at = col;
  for (int k = 0; k < K; ++k) {
    if (have < c) {
      buf |= static_cast<uint64_t>(q[0]) << have;
      have += 32;
#pragma unroll
      for (int j = 0; j + 1 < AW - 1; ++j) q[j] = q[j + 1];
      q[AW - 2] = 0;
    }
    const uint32_t l = (static_cast<uint32_t>(buf) & (full - 1)) + carry;
    buf >>= c;
    have -= c;
    const bool big = l > half;
    carry = big ? 1u : 0u;
    const uint32_t mag = big ? full - l : l;
    mags[at] = masked ? 0 : static_cast<int32_t>(mag);
    signs[at] = mag == 0 ? 0 : static_cast<int32_t>(carry ^ g);
    at += row_len;
  }
}

// Two threads a scalar, one a GLV half: lanes h*16 + j of a warp hold half h
// of scalar 16 w + j (w: the warp's index in the grid), so each half-warp's
// stores are 16 contiguous words. Thread h computes u_h and takes u_(1-h)
// from lane ^ 16; then s_h = [h == 0] s - terms (2h, 2h+1). Lanes past N
// compute on zeros and store nothing (the shuffle needs the whole warp).
constexpr int WARP_SCALARS = 16;

__global__ void __launch_bounds__(BLOCK_THREADS)
glv_digits_kernel(const int32_t* __restrict__ s, int64_t lds, int64_t N, int c, int K,
                       int32_t* __restrict__ mags, int32_t* __restrict__ signs,
                       const int32_t* __restrict__ inf, const __grid_constant__ GlvConsts gc) {
  const int t = threadIdx.x & 31, h = t >> 4;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t lane = warp * WARP_SCALARS + (t & (WARP_SCALARS - 1));
  const bool live = lane < N;
  uint32_t sw[SW];
  if (live) {
    load_scalar(sw, s, lds, lane);
  } else {
#pragma unroll
    for (int k = 0; k < SW; ++k) sw[k] = 0;
  }
  uint32_t m[MW], mine[AW], u0[AW], u1[AW];
#pragma unroll
  for (int k = 0; k < MW; ++k) m[k] = h ? gc.m[1][k] : gc.m[0][k];
  mul_shift(mine, sw, m);
#pragma unroll
  for (int k = 0; k < AW; ++k) {
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine[k], WARP_SCALARS);
    u0[k] = h ? other : mine[k];
    u1[k] = h ? mine[k] : other;
  }
  uint32_t acc[AW], va[VW], vb[VW];
#pragma unroll
  for (int k = 0; k < AW; ++k) acc[k] = h ? 0u : sw[k];
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    va[k] = h ? gc.v[2][k] : gc.v[0][k];
    vb[k] = h ? gc.v[3][k] : gc.v[1][k];
  }
  mul_acc(acc, u0, va, (h ? gc.sg[2] : gc.sg[0]) > 0);
  mul_acc(acc, u1, vb, (h ? gc.sg[3] : gc.sg[1]) > 0);
  const uint32_t g = sign_abs(acc);
  if (!live) return;
  const int64_t col = h * N + lane;
  digits(acc, g, inf != nullptr && __ldg(inf + col) != 0, c, K, mags, signs, 2 * N, col);
}

// ---- K9: signed c-bit windows of plain scalars --------------------------------
__global__ void __launch_bounds__(BLOCK_THREADS)
simple_digits_kernel(const int32_t* __restrict__ s, int64_t lds, int n, int64_t N, int c,
                     int K, int32_t* __restrict__ mags, int32_t* __restrict__ signs) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const uint32_t half = 1u << (c - 1), full = 1u << c;
  uint32_t carry = 0;
  for (int k = 0; k < K; ++k) {
    const int off = k * c;
    uint32_t val = 0;
    int produced = 0;
    for (int j = off / LIMB_BITS; produced < c && j < n; ++j) {
      const uint32_t limb = static_cast<uint32_t>(__ldg(s + j * lds + lane));
      if (produced == 0) {
        const int sh = off % LIMB_BITS;
        val = limb >> sh;
        produced = LIMB_BITS - sh;
      } else {
        val |= limb << produced;
        produced += LIMB_BITS;
      }
    }
    const uint32_t l = (val & (full - 1)) + carry;
    const bool big = l > half;
    carry = big ? 1u : 0u;
    const uint32_t mag = big ? full - l : l;
    mags[k * N + lane] = static_cast<int32_t>(mag);
    signs[k * N + lane] = (big && mag != 0) ? 1 : 0;
  }
}

}  // namespace msm

// ptrs: {scalars, mags, signs}; lds: {lds}. Outputs are (K, N) int32.
extern "C" int msm_simple_digits(const uint64_t* ptrs, const int64_t* lds, int64_t N, int n,
                                 int c, int K, void* stream) {
  using namespace msm;
  if (n < 1 || c < 1 || c > MAX_C || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  simple_digits_kernel<<<grid_for(N), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0], n, N, c, K,
      reinterpret_cast<int32_t*>(ptrs[1]), reinterpret_cast<int32_t*>(ptrs[2]));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: {scalars, mags, signs, inf}; inf 0 (no mask) or the (2N,) int32 flags
// of the GLV-expanded points; lds: {lds}. Outputs are (K, 2N) int32: GLV half
// 0 in columns [0, N), half 1 in [N, 2N) (glv_prep's layout).
extern "C" int msm_glv_digits(const uint64_t* ptrs, const int64_t* lds, int64_t N,
                              int c, int K, const int32_t* consts, void* stream) {
  using namespace msm;
  GlvConsts gc;
  std::memcpy(&gc, consts, sizeof gc);
  if (gc.dims[0] != NS || gc.dims[1] != NH || gc.dims[2] != NACC ||
      gc.dims[3] != K0L || gc.dims[4] != NM || c < 1 || c > MAX_C || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t threads = (N + WARP_SCALARS - 1) / WARP_SCALARS * 32;
  glv_digits_kernel<<<grid_for(threads), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0], N, c, K,
      reinterpret_cast<int32_t*>(ptrs[1]), reinterpret_cast<int32_t*>(ptrs[2]),
      reinterpret_cast<const int32_t*>(ptrs[3]), gc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msm_glv_const_words() { return sizeof(msm::GlvConsts) / sizeof(int32_t); }
