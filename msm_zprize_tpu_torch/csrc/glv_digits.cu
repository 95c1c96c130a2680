// K2: GLV decomposition fused with signed c-bit windowing of both halves.
// K9: signed c-bit windowing alone (no GLV), the twisted-Edwards scalar prep.
//
// Replaces msm_zprize_tpu/fields/pallas_scalar.py::glv_digits_pallas (body
// _scalar_kernel). Per scalar lane s (22 canonical 12-bit limbs of the
// scalar field; BLS12-377's, BLS12-381's and Pallas's GlvScalar modules all
// have the sizes below, and their constants come at run time):
//   u_i = floor(s * m_i / 2^(12*K0))            (multiply-high, i = 0, 1)
//   s0  = s - (x0*v00 + x1*v10),  s1 = -(x0*v01 + x1*v11)   mod 2^(12*n_acc)
//   (sign_i, |s_i|) from the two's-complement top bit
// then the signed-digit recoding of |s0| and |s1| into K windows of c bits.
// It runs the same 12-bit limb algorithm in int32 as the TPU kernel and the
// JAX jnp path (GlvScalar.decompose + signed_digits), so the output is
// bit-identical, zero digits carrying sign 0 included.
//
// What bounds it on an H100: at 2^16 scalars it reads 22 and writes 44
// int32 per lane for ~1,000 int32 multiply-adds, so it is memory- and
// launch-bound. One thread per scalar, limb-major coalesced loads; the
// limb sizes are compile-time so the products stay in registers. The
// constants (m_i, v_ij, their signs) come from the Python GlvScalar and
// the entry point refuses a scalar module whose sizes differ.
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

constexpr int NS = 22;    // scalar limbs (bits(q) = 253 or 255)
constexpr int NH = 11;    // limbs of |s_i|
constexpr int NACC = 13;  // two's-complement accumulator limbs
constexpr int K0L = 23;   // multiply-high shift, in limbs
constexpr int NM = 13;    // limbs of m_0, m_1

struct GlvConsts {
  int32_t dims[5];      // n, n_half, n_acc, K0_limbs, n_m as the Python side has them
  int32_t sg[4];        // static sign of each term: +1 subtracts, -1 adds
  int32_t m0[NM];
  int32_t m1[NM];
  int32_t v[4][NH];     // v00, v10, v01, v11 (terms a, b, c, d), zero-padded
};

template <int N>
__device__ __forceinline__ void sub_mod(int32_t* r, const int32_t* x, const int32_t* y) {
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int32_t t = x[i] - y[i] + borrow;
    r[i] = t & LIMB_MASK;
    borrow = t >> LIMB_BITS;
  }
}

template <int N>
__device__ __forceinline__ void add_mod(int32_t* r, const int32_t* x, const int32_t* y) {
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int32_t t = x[i] + y[i] + carry;
    r[i] = t & LIMB_MASK;
    carry = t >> LIMB_BITS;
  }
}

// floor(x * m / 2^(12*K0L)): low NH+1 limbs.
__device__ __forceinline__ void mul_shift_floor(int32_t* u, const int32_t* xs,
                                                const int32_t* m) {
  int32_t cols[NS + NM];
#pragma unroll
  for (int k = 0; k < NS + NM; ++k) cols[k] = 0;
#pragma unroll
  for (int j = 0; j < NM; ++j) {
#pragma unroll
    for (int i = 0; i < NS; ++i) cols[i + j] += xs[i] * m[j];
  }
  int32_t carry = 0;
#pragma unroll
  for (int k = 0; k < K0L + NH + 1; ++k) {
    const int32_t t = cols[k] + carry;
    if (k >= K0L) u[k - K0L] = t & LIMB_MASK;
    carry = t >> LIMB_BITS;
  }
}

// Low NACC limbs of u * v (u: NH+1 limbs, v: NH limbs).
__device__ __forceinline__ void mul_low(int32_t* r, const int32_t* u, const int32_t* v) {
  int32_t cols[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) cols[k] = 0;
#pragma unroll
  for (int j = 0; j < NH; ++j) {
#pragma unroll
    for (int i = 0; i < NH + 1; ++i) {
      if (i + j < NACC) cols[i + j] += u[i] * v[j];
    }
  }
  int32_t carry = 0;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int32_t t = cols[k] + carry;
    r[k] = t & LIMB_MASK;
    carry = t >> LIMB_BITS;
  }
}

// base - sg * t  (mod 2^(12*NACC))
__device__ __forceinline__ void combine(int32_t* r, const int32_t* base, int32_t sg,
                                        const int32_t* t) {
  int32_t a[NACC], b[NACC];
  sub_mod<NACC>(a, base, t);
  add_mod<NACC>(b, base, t);
#pragma unroll
  for (int i = 0; i < NACC; ++i) r[i] = sg > 0 ? a[i] : b[i];
}

// Two's-complement sign and magnitude (low NH limbs).
__device__ __forceinline__ int32_t sign_abs(int32_t* mag, const int32_t* x) {
  const int32_t top = (x[NACC - 1] >> (LIMB_BITS - 1)) & 1;
  int32_t zero[NACC], neg[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) zero[i] = 0;
  sub_mod<NACC>(neg, zero, x);
#pragma unroll
  for (int i = 0; i < NH; ++i) mag[i] = top ? neg[i] : x[i];
  return top;
}

// Signed c-bit digits of a (NH canonical limbs), signs XOR g; digit k goes
// to row k of the (K, row_len) outputs at column `col`.
__device__ __forceinline__ void digits(const int32_t* a, int32_t g, int c, int K,
                                       int32_t* __restrict__ mags,
                                       int32_t* __restrict__ signs,
                                       int64_t row_len, int64_t col) {
  const int32_t half = 1 << (c - 1), full = 1 << c;
  int32_t carry = 0;
  for (int k = 0; k < K; ++k) {
    const int off = k * c;
    int32_t val = 0;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int lo = LIMB_BITS * j;
      if (lo + LIMB_BITS > off && lo < off + c) {
        val |= lo >= off ? a[j] << (lo - off) : a[j] >> (off - lo);
      }
    }
    const int32_t l = (val & (full - 1)) + carry;
    const int32_t big = l > half ? 1 : 0;
    carry = big;
    const int32_t mag = big ? full - l : l;
    const int32_t sgn = mag == 0 ? 0 : (big ^ g);
    mags[k * row_len + col] = mag;
    signs[k * row_len + col] = sgn;
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS)
glv_digits_kernel(const int32_t* __restrict__ s, int64_t lds, int64_t N, int c, int K,
                  int32_t* __restrict__ mags, int32_t* __restrict__ signs,
                  const __grid_constant__ GlvConsts gc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  int32_t xs[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) xs[i] = __ldg(s + i * lds + lane);

  int32_t u0[NH + 1], u1[NH + 1];
  mul_shift_floor(u0, xs, gc.m0);
  mul_shift_floor(u1, xs, gc.m1);

  int32_t ta[NACC], tb[NACC], tc[NACC], td[NACC];
  mul_low(ta, u0, gc.v[0]);
  mul_low(tb, u1, gc.v[1]);
  mul_low(tc, u0, gc.v[2]);
  mul_low(td, u1, gc.v[3]);

  int32_t s_acc[NACC], zero[NACC], s0[NACC], s1[NACC], tmp[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    s_acc[i] = xs[i];
    zero[i] = 0;
  }
  combine(tmp, s_acc, gc.sg[0], ta);
  combine(s0, tmp, gc.sg[1], tb);
  combine(tmp, zero, gc.sg[2], tc);
  combine(s1, tmp, gc.sg[3], td);

  int32_t a0[NH], a1[NH];
  const int32_t g0 = sign_abs(a0, s0);
  const int32_t g1 = sign_abs(a1, s1);
  digits(a0, g0, c, K, mags, signs, 2 * N, lane);
  digits(a1, g1, c, K, mags, signs, 2 * N, N + lane);
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
  if (n < 1 || c < 1 || c > 20 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  simple_digits_kernel<<<grid_for(N), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0], n, N, c, K,
      reinterpret_cast<int32_t*>(ptrs[1]), reinterpret_cast<int32_t*>(ptrs[2]));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: {scalars, mags, signs}; lds: {lds}. Outputs are (K, 2N) int32:
// GLV half 0 in columns [0, N), half 1 in [N, 2N) (glv_prep's layout).
extern "C" int msm_glv_digits(const uint64_t* ptrs, const int64_t* lds, int64_t N,
                              int c, int K, const int32_t* consts, void* stream) {
  using namespace msm;
  GlvConsts gc;
  std::memcpy(&gc, consts, sizeof gc);
  if (gc.dims[0] != NS || gc.dims[1] != NH || gc.dims[2] != NACC ||
      gc.dims[3] != K0L || gc.dims[4] != NM || c < 1 || c > 20 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  glv_digits_kernel<<<grid_for(N), BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0], N, c, K,
      reinterpret_cast<int32_t*>(ptrs[1]), reinterpret_cast<int32_t*>(ptrs[2]), gc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msm_glv_const_words() { return sizeof(msm::GlvConsts) / sizeof(int32_t); }
