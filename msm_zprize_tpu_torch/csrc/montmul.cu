// K1: batched Montgomery product x * y * R^-1 mod p on (n, W) limb tensors.
// K8: batched x^e for a static exponent e, one launch for the whole chain.
//
// K1 replaces msm_zprize_tpu/fields/pallas_mul.py::montmul_pallas (body
// _montmul_kernel via _mm_rows): the TPU kernel splits the product into
// three constant-coefficient convolutions over (n, 128)-lane blocks padded
// to 4096 lanes. Here one thread owns one lane and runs CIOS over 32-bit
// words (field.cuh); the ragged edge is masked, so nothing is padded.
// The output is (x*y + q*p) / R with the unique q < R that makes the
// division exact, the same integer as the TPU kernel's and the JAX conv
// path's: canonical limbs, value < 2p for inputs < 4p.
//
// K8 replaces pallas_mul.py::exp_const_pallas (body _exp_kernel: 4-bit
// windows, the exponent's bits as constants, compute-both-and-select). Its
// chain is the host's list of ops (the exponent is static, so the list is
// the same for every lane: a uniform loop), and G threads of one warp share
// each product of a lane (below: the design, its traps and its probe).
//
// What bounds them on an H100. K1 at the main paths' shapes (beta * x over
// 65,536 lanes; batch_inverse's rows) moves 3 x n x 4 bytes per lane for
// one product, so it is memory- and launch-bound; limb-major loads keep
// each warp's accesses coalesced (limb i of 32 neighbouring lanes is one
// 128-byte line). K8 runs on ONE lane in the Edwards MSM and on one to four
// in each batch_add level of the affine modes (the Fermat inverse of
// batch_inverse's grand total: e = p - 2, ~450 dependent products), so it
// is one lane's latency: the length of the chain times one product's
// latency, which G threads shorten by splitting the product's digit
// products (one thread's CIOS product is a chain of 2 NW^2 dependent
// multiply-adds).
//
// K13: the same Montgomery product on row-codec storage (codec.cuh):
// decode two (rows, W) operands into register words, mont_mul with the
// limb code's own R = 2^(12 n), encode the result (< 2p). Replaces
// msm_zprize_tpu/fields/fma51_pallas.py::montmul51_pallas (body
// _montmul51_kernel: decode rows to 12-bit digits, the interval-tracked
// CIOS, encode with a conditional-subtract chain). The output is already
// canonical and < 2p, so the encode is a pure repack. Instantiated for
// every entry of codec.cuh's table: PackedCodec on Fp32 and Fp33 (13 rows;
// beta * x of the packed MSMs of BLS12-377 and BLS12-381), PackedCodec (9
// rows) and Fma51Codec (10 rows) on Fp22 and Fp22c (Pallas: beta * x of
// its fma51 MSM on Fma51Codec). Bound as K1: bytes and launches at 65,536
// lanes, with 13 (10) rows a value instead of 32 (22).
//
// K1 and K8 are instantiated for every field shape of field.cuh: the four of
// the main library, or the one shape made on demand of a library built for
// it (n = 1..63, every field the limb code takes; K8 one thread a lane from
// 13 words up). The entry points take the shape's ID (and K13 the codec id)
// and refuse any other, and field constants that do not fit the shape named.
#include "codec.cuh"

namespace msm {

template <class S>
__global__ void __launch_bounds__(BLOCK_THREADS)
montmul_kernel(const int32_t* __restrict__ x, int64_t ldx,
               const int32_t* __restrict__ y, int64_t ldy,
               int32_t* __restrict__ out, int64_t ldo, int64_t W,
               const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe<S> a = load_fe<S>(x, ldx, lane, fc);
  const Fe<S> b = load_fe<S>(y, ldy, lane, fc);
  store_fe(mont_mul(a, b, fc), out, ldo, lane);
}

template <class S, class C>
__global__ void __launch_bounds__(BLOCK_THREADS)
montmul_rows_kernel(const int32_t* __restrict__ x, int64_t ldx,
                    const int32_t* __restrict__ y, int64_t ldy,
                    int32_t* __restrict__ out, int64_t ldo, int64_t W,
                    const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe<S> a = load_rows<S, C>(x, ldx, lane);
  const Fe<S> b = load_rows<S, C>(y, ldy, lane);
  store_rows<S, C>(mont_mul(a, b, fc), out, ldo, lane);
}

// ---- K8: x^e, one warp a lane ------------------------------------------------
// The chain. The host (cuda_mul.exp_chain) writes it as a list of ops on a
// running value `cur` and slots (a table of odd powers, x^2, the domain
// constants): MSB-first sliding windows of up to 5 bits, each starting and
// ending on a one bit and multiplying by an odd power x^(2t+1) from the
// table, single squarings between windows; the window width is the one
// that needs the fewest products for this e. For e = p - 2 on BLS12-377
// that is 16 products for the table, 373 squarings and 57 multiplies: 446
// (plain binary: 556). The kernel walks the list with ONE product call
// site, so the chain's code is one product's code.
//
// The product. The 32 threads of a warp share each product of a lane in
// the non-interleaved three-product form of the TPU's K1 body
// (pallas_mul.py's _montmul_kernel): T = a b, m = (T mod R') (-p^-1) mod
// R', (T + m p) / R'. Values are ND digits of 30 bits (ND = 13 on 12
// words, 9 on 8), one a thread, so a digit product is below 2^60 and a
// column of up to 16 of them sums in one 64-bit register: thread t sums
// column t (2 ND - 1 <= 32 columns), one IMAD.WIDE a product, reading the
// other operand's digit t - j from lane t - j by a warp shuffle, and no
// carry crosses threads. Carries are never propagated along the value: a
// column splits into three 30-bit pieces that land on digits t, t + 1,
// t + 2, and one more split of their sums leaves every digit below
// 2^30 + 3 (warp_relax: three shuffles up), a redundant form that the next
// product takes as it is (13 products of such digits still sum below
// 2^64). Each of the three products ends in that split, so every thread
// ends with its digit of the result, in a register.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the same product
// with the digits and columns in shared memory and G = 4, 8, 16 or 32
// threads a lane was fastest at G = 32 on every shape and width (0.29 ms
// for e = p - 2 on BLS12-377 against 0.41-0.85), and the shuffles took it
// to 0.25 ms.
//
// Traps, and what the design does about them:
// * R. The product divides by R' = 2^(30 ND), not by the limb code's
//   R = 2^(12 n) (2^384, and 2^264 = 2^256 * 2^8, 2^396 = 2^384 * 2^12,
//   two of them not word-aligned). A chain run in R' and stored as it is
//   would be wrong by a power of two mod p. So the chain enters R' with one
//   product by R'^2 / R mod p (x R -> x R') and leaves it with one product
//   by R mod p (y R' -> y R): two more products, and no product cuts m or
//   shifts at a bit that is not a digit boundary.
// * The bits above 256 on Pallas (4p > 2^256): the digits hold 270 bits,
//   so no value in the chain needs a carry kept above a top word; load_fe
//   folds bit 256 on the way in, as every Pallas load does.
// * The low half of T + m p is 0 mod R' and its relaxed digits are >= 0
//   and sum below 2 R', so it is 0 or R': its carry into the high half is
//   1 exactly when one of its digits is not 0 (one warp vote).
// * Lanes past the value. A digit from ND up is 0 on every thread, and a
//   shuffle from lane t - j < 0 reads lane 32 + t - j >= ND (2 ND - 1 <=
//   32), also 0, except for T's digits (they reach 2 ND - 1): m's columns
//   mask j > t.
// * Bounds. With a, b < 4p, m below R' (1 + 2^-28) and R' > 16p on every
//   shape, (T + m p) / R' < 16p^2 / R' + (1 + 2^-28) p < 2p: every product
//   returns a value below 2p in relaxed digits, as the next one takes it.
//   The last product's digits are carried into words and stored as
//   canonical limbs below 2p (e = 0 stores one).
// This product lives in K8 only; field.cuh's mont_mul (one thread, CIOS)
// still runs K1-K14.
//
// The probe (exp_probe_kernel; no path launches it): x^e on one thread a
// lane by MSB-first binary square-and-multiply over e's bits with
// field.cuh's mont_mul (R), both operands in registers: K8's chain before
// its warp design. Its time over its products (e's bit length plus its
// popcount) is one thread's dependent product latency, the lowest per
// product that one thread has shown (a chain of cur * x alone, or of
// squarings alone, takes 7-14 % more on 12 words): the unit of the curve
// kernels' latency floors that chip_smoke.py prints.
constexpr int EXP_BITS = 384;     // e < 2^384
constexpr int EXP_OP_WORDS = 192;  // 768 ops, 4 a word: any e < 2^384 needs < 560
constexpr int DIGIT_BITS = 30;
constexpr uint32_t DIGIT_MASK = (1u << DIGIT_BITS) - 1;
constexpr int EXP_DIGITS_MAX = 13;
// An op: kind in bits 6-7, a slot in bits 0-4. Slots 0-15 hold the table
// x^(2t+1), 16 x^2, 17 R'^2 / R, 18 R mod p; slot 31 is cur (a square).
constexpr int EXP_MUL = 0, EXP_SAVE = 1;  // cur *= slot; slot = cur; (kind 2) cur = slot
constexpr int EXP_SLOTS = 19, EXP_X = 16, EXP_INTO = 17, EXP_BACK = 18, EXP_CUR = 31;
constexpr int EXP_WARPS = 4;  // lanes (warps) a block
constexpr unsigned WARP_ALL = 0xffffffffu;

template <class S>
__host__ __device__ constexpr int exp_digits() {
  return (32 * S::NW + DIGIT_BITS - 1) / DIGIT_BITS;
}

// Whether K8 runs S on a warp's digits (at most EXP_DIGITS_MAX, so 12 words:
// every shape of the main library and DynShapes up to p ~ 2^381), or on one
// thread a lane (exp_thread_kernel below: the wider DynShapes, n <= 63).
template <class S>
constexpr bool exp_warp() {
  return exp_digits<S>() <= EXP_DIGITS_MAX;
}

// The host's words (cuda_mul._exp_args): the op list, then the chain's
// constants as ND digits (zeros above).
struct ExpArgs {
  int32_t nops;
  uint32_t ops[EXP_OP_WORDS];
  uint32_t p[EXP_DIGITS_MAX];
  uint32_t pn[EXP_DIGITS_MAX];    // -p^-1 mod R'
  uint32_t into[EXP_DIGITS_MAX];  // R'^2 / R mod p: x R -> x R'
  uint32_t back[EXP_DIGITS_MAX];  // R mod p: y R' -> y R
  __device__ int op(int i) const { return (ops[i >> 2] >> (8 * (i & 3))) & 0xFF; }
};

// Thread t's relaxed digit of the columns held one a thread (col: column t):
// the pieces of columns t, t-1, t-2 and t-3 (shuffled up; 0 below lane 0).
__device__ __forceinline__ uint32_t warp_relax(uint64_t col, int t) {
  uint64_t c[4] = {col, 0, 0, 0};
#pragma unroll
  for (int d = 1; d < 4; ++d) {
    const uint64_t v = __shfl_up_sync(WARP_ALL, col, d);
    c[d] = t >= d ? v : 0;
  }
  const auto piece = [](uint64_t v, int s) {
    return static_cast<uint32_t>(v >> (DIGIT_BITS * s)) & DIGIT_MASK;
  };
  const uint32_t d1 = piece(c[0], 0) + piece(c[1], 1) + piece(c[2], 2);
  const uint32_t d0 = piece(c[1], 0) + piece(c[2], 1) + piece(c[3], 2);
  return (d1 & DIGIT_MASK) + (d0 >> DIGIT_BITS);
}

// a * b / R' mod p on one warp: thread t holds digit t of a and of b (0 from
// ND up) and returns digit t of the product (0 from ND up).
template <class S>
__device__ __forceinline__ uint32_t warp_mul(uint32_t a, uint32_t b, int t, const ExpArgs& ea) {
  constexpr int ND = exp_digits<S>();
  static_assert(2 * ND <= 32, "a warp holds a product's columns");
  uint64_t s[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const uint32_t bj = __shfl_sync(WARP_ALL, b, j);
    s[j & 3] += static_cast<uint64_t>(bj) * __shfl_sync(WARP_ALL, a, t - j);
  }
  const uint32_t e = warp_relax(s[0] + s[1] + s[2] + s[3], t);  // T's digit t
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = 0;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const uint32_t ej = __shfl_sync(WARP_ALL, e, t - j);
    s[j & 3] += static_cast<uint64_t>(ea.pn[j]) * (j <= t ? ej : 0u);
  }
  const uint64_t mc = s[0] + s[1] + s[2] + s[3];
  const uint32_t m = warp_relax(t < ND ? mc : 0, t);  // mod R': the columns below ND
  const uint32_t mt = t < ND ? m : 0;
  s[0] = e;
#pragma unroll
  for (int j = 1; j < 4; ++j) s[j] = 0;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    s[j & 3] += static_cast<uint64_t>(ea.p[j]) * __shfl_sync(WARP_ALL, mt, t - j);
  }
  const uint32_t d = warp_relax(s[0] + s[1] + s[2] + s[3], t);  // digit t of T + m p
  const bool carry = __ballot_sync(WARP_ALL, t < ND && d != 0) != 0;
  const uint32_t r = __shfl_sync(WARP_ALL, d, t + ND);
  return t < ND ? r + (t == 0 && carry) : 0;
}

template <class S>
__device__ __forceinline__ void fe_to_digits(const Fe<S>& a, uint32_t* d) {
  constexpr int ND = exp_digits<S>();
#pragma unroll
  for (int q = 0; q < ND; ++q) {
    const int bit = DIGIT_BITS * q, w = bit >> 5, off = bit & 31;
    uint64_t v = w < S::NW ? a.v[w] : 0;
    if (w + 1 < S::NW) v |= static_cast<uint64_t>(a.v[w + 1]) << 32;
    d[q] = static_cast<uint32_t>(v >> off) & DIGIT_MASK;
  }
}

// Relaxed digits of a value < 2^(32 NW) -> words: one carry pass, then the bits.
template <class S>
__device__ __forceinline__ Fe<S> digits_to_fe(const uint32_t* src) {
  constexpr int ND = exp_digits<S>();
  uint32_t d[ND];
  uint32_t c = 0;
#pragma unroll
  for (int q = 0; q < ND; ++q) {
    const uint32_t t = src[q] + c;
    d[q] = t & DIGIT_MASK;
    c = t >> DIGIT_BITS;
  }
  Fe<S> r = fe_zero<S>();
#pragma unroll
  for (int q = 0; q < ND; ++q) {
    const int bit = DIGIT_BITS * q, w = bit >> 5, off = bit & 31;
    if (w < S::NW) r.v[w] |= d[q] << off;
    if (off + DIGIT_BITS > 32 && w + 1 < S::NW) r.v[w + 1] |= d[q] >> (32 - off);
  }
  return r;
}

// K8, one warp a lane (EXP_WARPS lanes a block): the warp keeps the running
// value in registers, a digit a thread, and the slots in shared memory.
template <class S>
__global__ void __launch_bounds__(32 * EXP_WARPS)
exp_warp_kernel(const int32_t* __restrict__ x, int64_t ldx, int32_t* __restrict__ out,
                int64_t ldo, int64_t W, const __grid_constant__ ExpArgs ea,
                const __grid_constant__ FieldConsts<S> fc) {
  constexpr int ND = exp_digits<S>();
  __shared__ uint32_t slots[EXP_WARPS][EXP_SLOTS * ND];
  const int t = threadIdx.x & 31;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * EXP_WARPS + (threadIdx.x >> 5);
  if (lane >= W) return;  // the whole warp
  if (ea.nops == 0) {     // e = 0
    if (t == 0) store_fe(fe_from<S>(fc.one), out, ldo, lane);
    return;
  }
  uint32_t* sh = slots[threadIdx.x >> 5];
  // x's digits pass through slot X (later x^2) on the way in, and the
  // result's on the way out
  if (t == 0) fe_to_digits<S>(load_fe<S>(x, ldx, lane, fc), sh + EXP_X * ND);
  if (t < ND) {
    sh[EXP_INTO * ND + t] = ea.into[t];
    sh[EXP_BACK * ND + t] = ea.back[t];
  }
  __syncwarp();
  uint32_t cur = t < ND ? sh[EXP_X * ND + t] : 0;
  int op = EXP_INTO;  // the op list between the two domain changes
  for (int i = 0; i <= ea.nops + 1; ++i) {
    const int next = i < ea.nops ? ea.op(i) : EXP_BACK, slot = op & 31;
    if (op >> 6 == EXP_MUL) {
      cur = warp_mul<S>(cur, slot == EXP_CUR ? cur : t < ND ? sh[slot * ND + t] : 0, t, ea);
    } else if (op >> 6 == EXP_SAVE) {
      if (t < ND) sh[slot * ND + t] = cur;
      __syncwarp();
    } else {
      cur = t < ND ? sh[slot * ND + t] : 0;
    }
    op = next;
  }
  if (t < ND) sh[EXP_X * ND + t] = cur;
  __syncwarp();
  if (t == 0) store_fe(digits_to_fe<S>(sh + EXP_X * ND), out, ldo, lane);
}

// K8 on one thread a lane, for the shapes too wide for a warp's digits
// (DynShapes of 13 to 24 words: p up to 2^751, e up to 2^768): the same op
// list, walked with field.cuh's mont_mul in R itself (so no domain change),
// the running value in registers and the slots (the odd powers, x^2) in the
// thread's local memory. A simple design that is right first: the chain is
// one thread's dependent products.
constexpr int EXP_WIDE_OP_WORDS = 320;  // 1,280 ops: any e < 2^768 needs < 1,000
constexpr int EXP_WIDE_BITS = 768;

struct ExpWideArgs {
  int32_t nops;
  uint32_t ops[EXP_WIDE_OP_WORDS];
  __device__ int op(int i) const { return (ops[i >> 2] >> (8 * (i & 3))) & 0xFF; }
};

template <class S>
__global__ void __launch_bounds__(BLOCK_THREADS)
exp_thread_kernel(const int32_t* __restrict__ x, int64_t ldx, int32_t* __restrict__ out,
                  int64_t ldo, int64_t W, const __grid_constant__ ExpWideArgs ea,
                  const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  Fe<S> slots[EXP_X + 1];
  Fe<S> cur = load_fe<S>(x, ldx, lane, fc);  // < 4p: mont_mul takes it
  if (ea.nops == 0) cur = fe_from<S>(fc.one);  // e = 0
  for (int i = 0; i < ea.nops; ++i) {
    const int op = ea.op(i), slot = op & 31;
    if (op >> 6 == EXP_MUL) {
      cur = mont_mul(cur, slot == EXP_CUR ? cur : slots[slot], fc);
    } else if (op >> 6 == EXP_SAVE) {
      slots[slot] = cur;
    } else {
      cur = slots[slot];
    }
  }
  store_fe(cond_sub(cur, fc.two_p), out, ldo, lane);  // x itself (e = 1) may be >= 2p
}

// The probe's exponent: bit i of e is bit (i % 32) of w[i / 32], i < nbits.
struct ExpBits {
  uint32_t w[EXP_BITS / 32];
  int32_t nbits;
};

template <class S>
__global__ void __launch_bounds__(BLOCK_THREADS)
exp_probe_kernel(const int32_t* __restrict__ x, int64_t ldx, int32_t* __restrict__ out,
                 int64_t ldo, int64_t W, const __grid_constant__ ExpBits e,
                 const __grid_constant__ FieldConsts<S> fc) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const Fe<S> a = load_fe<S>(x, ldx, lane, fc);
  Fe<S> acc = fe_from<S>(fc.one);
  for (int i = e.nbits - 1; i >= 0; --i) {
    acc = mont_square(acc, fc);
    if ((e.w[i >> 5] >> (i & 31)) & 1u) acc = mont_mul(acc, a, fc);
  }
  store_fe(acc, out, ldo, lane);
}

template <class S>
int launch_montmul(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                   const uint32_t* consts, cudaStream_t stream) {
  montmul_kernel<S><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0],
      reinterpret_cast<const int32_t*>(ptrs[1]), lds[1],
      reinterpret_cast<int32_t*>(ptrs[2]), lds[2], W, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

template <class S, class C>
int launch_montmul_rows(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                        const uint32_t* consts, cudaStream_t stream) {
  montmul_rows_kernel<S, C><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0],
      reinterpret_cast<const int32_t*>(ptrs[1]), lds[1],
      reinterpret_cast<int32_t*>(ptrs[2]), lds[2], W, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int launch_exp(const uint64_t* ptrs, const int64_t* lds, int64_t W, const ExpArgs& e,
               const uint32_t* consts, cudaStream_t stream) {
  const auto grid = static_cast<unsigned>((W + EXP_WARPS - 1) / EXP_WARPS);
  exp_warp_kernel<S><<<grid, 32 * EXP_WARPS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0], reinterpret_cast<int32_t*>(ptrs[1]),
      lds[1], W, e, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int launch_exp_thread(const uint64_t* ptrs, const int64_t* lds, int64_t W, const ExpWideArgs& e,
                      const uint32_t* consts, cudaStream_t stream) {
  exp_thread_kernel<S><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0], reinterpret_cast<int32_t*>(ptrs[1]),
      lds[1], W, e, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int launch_exp_probe(const uint64_t* ptrs, const int64_t* lds, int64_t W, const ExpBits& e,
                     const uint32_t* consts, cudaStream_t stream) {
  exp_probe_kernel<S><<<grid_for(W), BLOCK_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(ptrs[0]), lds[0], reinterpret_cast<int32_t*>(ptrs[1]),
      lds[1], W, e, field_consts_from_host<S>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace msm

static int refused(int code) { return code < 0 ? static_cast<int>(cudaErrorInvalidValue) : code; }

// ptrs: {x, y, out} device pointers; lds: {ldx, ldy, ldo} row strides;
// shape: a field shape's ID (field.cuh).
extern "C" int msm_montmul(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                           const uint32_t* consts, void* stream) {
  using namespace msm;
  const auto s = static_cast<cudaStream_t>(stream);
  return refused(with_field(shape, consts, [&](auto f) {
    return launch_montmul<decltype(f)>(ptrs, lds, W, consts, s);
  }));
}

// K13. ptrs: {x, y, out}; lds: row strides; codec: a codec id of the table
// in codec.cuh (msm_codec_rows says how many rows each pair takes).
extern "C" int msm_montmul_rows(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                                int codec, const uint32_t* consts, void* stream) {
  using namespace msm;
  const auto s = static_cast<cudaStream_t>(stream);
  return refused(with_codec(shape, codec, [&](auto e) {
    using E = decltype(e);
    if (!fits<typename E::S>(consts)) return -1;
    return launch_montmul_rows<typename E::S, typename E::C>(ptrs, lds, W, consts, s);
  }));
}

// K8. ptrs: {x, out}; lds: {ldx, ldo}; args: the words of ExpArgs (the op
// list of e's chain, the chain's digit constants), or of ExpWideArgs (the op
// list) on a shape that K8 runs one thread a lane (msm_exp_layout says which).
extern "C" int msm_exp_const(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                             const uint32_t* args, const uint32_t* consts, void* stream) {
  using namespace msm;
  const auto s = static_cast<cudaStream_t>(stream);
  return refused(with_field(shape, consts, [&](auto f) {
    using S = decltype(f);
    if constexpr (exp_warp<S>()) {
      ExpArgs e;
      std::memcpy(&e, args, sizeof e);
      if (e.nops < 0 || e.nops > 4 * EXP_OP_WORDS) return static_cast<int>(cudaErrorInvalidValue);
      return launch_exp<S>(ptrs, lds, W, e, consts, s);
    } else {
      ExpWideArgs e;
      std::memcpy(&e, args, sizeof e);
      if (e.nops < 0 || e.nops > 4 * EXP_WIDE_OP_WORDS) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch_exp_thread<S>(ptrs, lds, W, e, consts, s);
    }
  }));
}

// K8's probe: on no path (chip_smoke.py times it). ptrs: {x, out}; lds:
// {ldx, ldo}; bits: e's 32-bit words (EXP_BITS / 32), then its bit length.
extern "C" int msm_exp_probe(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                             const uint32_t* bits, const uint32_t* consts, void* stream) {
  using namespace msm;
  ExpBits e;
  std::memcpy(&e, bits, sizeof e);
  if (e.nbits < 0 || e.nbits > EXP_BITS) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return refused(with_field(shape, consts, [&](auto f) {
    return launch_exp_probe<decltype(f)>(ptrs, lds, W, e, consts, s);
  }));
}

// Host-side layout check: words of FieldConsts the Python side must pack for
// a field shape (-1: no shape has that ID).
extern "C" int msm_field_const_words(int shape) {
  return msm::with_shape(shape, [](auto f) { return msm::field_const_words<decltype(f)>(); });
}

// Rows a value of a field shape takes in the codec `codec`, from the table
// in codec.cuh, -1 for none: the Python side checks its codec's row count
// against it and names the table's entries when it refuses one.
extern "C" int msm_codec_rows(int shape, int codec) {
  return msm::with_codec(shape, codec, [](auto e) { return decltype(e)::C::ROWS; });
}

// K8's host layout: {op words, digits max, exponent bits, words of ExpArgs,
// and the same three of ExpWideArgs: op words, exponent bits, words}, and
// (shape >= 0) the digits of a value of that shape in the warp's chain, 0
// where K8 runs the shape one thread a lane (-1: no such shape).
extern "C" int msm_exp_layout(int shape, int* out) {
  using namespace msm;
  out[0] = EXP_OP_WORDS;
  out[1] = EXP_DIGITS_MAX;
  out[2] = EXP_BITS;
  out[3] = sizeof(ExpArgs) / sizeof(uint32_t);
  out[4] = EXP_WIDE_OP_WORDS;
  out[5] = EXP_WIDE_BITS;
  out[6] = sizeof(ExpWideArgs) / sizeof(uint32_t);
  return with_shape(shape, [](auto f) {
    using S = decltype(f);
    return exp_warp<S>() ? exp_digits<S>() : 0;
  });
}

