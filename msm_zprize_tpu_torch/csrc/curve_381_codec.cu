// K14 on BLS12-381's base field: K3-K7 on (13, W) 31-bit PackedCodec rows
// decoded into Fp33's 12 register words (R = 2^396), as curve_codec.cu does
// for BLS12-377. This unit instantiates curve.cuh's kernels for that storage
// in its own nvcc process.
#include "curve.cuh"

int msm::wei::packed_fp33(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W,
                          int arg, int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<RowStore<Fp33, Packed31<13>>>(kernel, ptrs, lds, W, arg, group, consts, s);
}
