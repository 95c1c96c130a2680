// K3, K4, K4m, K5, K6, K7 on native storage: (32, W) 12-bit limb tensors.
// The formulas, the kernels and the bounds argument are in curve.cuh; this
// unit instantiates them for LimbStore<Fp32> (BLS12-377's base field).
#include "curve.cuh"

using msm::wei::S;
using Store = msm::LimbStore<S>;

// Each entry point takes the field's limb count n and refuses any but 32.
extern "C" int msm_aff_pair_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                                const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_aff_pair_add<Store>(ptrs, lds, W, consts,
                                              static_cast<cudaStream_t>(stream));
}

// masked != 0 (K4m): ptrs/lds hold the mask (a per-lane flag) after the 6 inputs.
extern "C" int msm_proj_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                            int masked, const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_add<Store>(ptrs, lds, W, masked, consts,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int msm_proj_double_k(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                                 int k, const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_double_k<Store>(ptrs, lds, W, k, consts,
                                               static_cast<cudaStream_t>(stream));
}

extern "C" int msm_proj_double(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                               const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_double<Store>(ptrs, lds, W, consts,
                                             static_cast<cudaStream_t>(stream));
}

extern "C" int msm_proj_add_mixed(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                                  const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_add_mixed<Store>(ptrs, lds, W, consts,
                                                static_cast<cudaStream_t>(stream));
}
