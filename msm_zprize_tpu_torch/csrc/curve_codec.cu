// K14: K3, K4, K4m, K5, K6, K7 on row-codec storage, (13, W) 31-bit rows of
// BLS12-377's base field (PackedCodec). The formulas, the kernels and the
// bounds argument are in curve.cuh; this unit instantiates them for that
// storage in its own nvcc process, beside curve.cu.
//
// Replaces CurveKernels(codec=PackedCodec(p)) through _curve_call
// (msm_zprize_tpu/curves/pallas_curve.py:149, the codec boundary
// _KernelBase._rd/_wr at :166-192): each load assembles the 12 register
// words from 13 rows (codec.cuh::load_rows), each store scatters them back,
// and pass-through lanes (K4m mask 0, K7 inf2 set) copy the 13 rows bit for
// bit. The arithmetic is K3-K7's; the bytes a lane moves fall from 32 to 13
// words per coordinate (K3: 912 -> 380 bytes per lane), so the operation
// bound is unchanged and the byte bound falls ~2.5x. The loads are what
// these kernels wait on (curve.cuh), so the time falls with the bytes.
// Built with -DMSM_DYN_SHAPE, the same kernels on PackedCodec rows of the
// shape made on demand (MSM_DYN_ROWS rows: 15 on BN462's base field).
#include "curve.cuh"

#ifdef MSM_DYN_SHAPE
int msm::wei::packed_dyn(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W,
                         int arg, int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<RowStore<DynShape, Packed31<MSM_DYN_ROWS>>>(kernel, ptrs, lds, W, arg,
                                                                  group, consts, s);
}
#else
int msm::wei::packed_fp32(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W,
                          int arg, int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<RowStore<Fp32, Packed31<13>>>(kernel, ptrs, lds, W, arg, group, consts, s);
}
#endif
