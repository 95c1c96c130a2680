// K3, K4, K4m, K5, K6, K7 on native storage of the Pallas base field:
// (22, W) 12-bit limb tensors in the CARRY shape Fp22c (8 register words,
// an 8-bit tail round, R = 2^264; 2p < 2^256 <= 4p, so loads fold bit 256
// and additions keep the carry out of the top word: field.cuh). The
// formulas, the kernels and the bounds argument are in curve.cuh; this unit
// instantiates them for LimbStore<Fp22c> in its own nvcc process. 3b = 15.
#include "curve.cuh"

int msm::wei::limbs_fp22c(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W,
                          int arg, int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<LimbStore<Fp22c>>(kernel, ptrs, lds, W, arg, group, consts, s);
}
