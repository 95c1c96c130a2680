// K3, K4, K4m, K5, K6, K7 on native storage of BLS12-381's base field:
// (33, W) 12-bit limb tensors, 12 register words and a 12-bit tail round
// (Fp33, R = 2^396). The formulas, the kernels and the bounds argument are
// in curve.cuh; this unit instantiates them for LimbStore<Fp33> in its own
// nvcc process. 3b = 12.
#include "curve.cuh"

int msm::wei::limbs_fp33(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W,
                         int arg, int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<LimbStore<Fp33>>(kernel, ptrs, lds, W, arg, group, consts, s);
}
