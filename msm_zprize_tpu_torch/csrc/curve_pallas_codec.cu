// K14 on the Pallas base field (Fp22c): K3-K7 on row-codec storage, in its
// own nvcc process:
//   * (10, W) Fma51Codec rows: five 51-bit limbs as (26, 25)-bit pair rows,
//     256 bits, the layout of the JAX package's mode="fma51" (its kernel
//     CurveKernels(codec=Fma51Codec(p)) through _curve_call,
//     msm_zprize_tpu/curves/pallas_curve.py:149 with _rd/_wr at :166-192);
//     it needs p < 2^255 - 2^206, so Pallas is its one Weierstrass curve;
//   * (9, W) PackedCodec rows (31 bits each, 279 bits).
// Each load assembles the 8 register words from the rows (codec.cuh::
// load_rows; stored values are < 2p < 2^256, so no row bit lies above the
// words), each store scatters them back, and pass-through lanes (K4m mask
// 0, K7 inf2 set) copy the rows bit for bit. A lane moves 10 (9) words a
// coordinate against the 22 of limb storage.
#include "curve.cuh"

int msm::wei::packed_fp22c(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W,
                           int arg, int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<RowStore<Fp22c, Packed31<9>>>(kernel, ptrs, lds, W, arg, group, consts, s);
}

int msm::wei::fma51_fp22c(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W,
                          int arg, int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<RowStore<Fp22c, Fma51Rows>>(kernel, ptrs, lds, W, arg, group, consts, s);
}
