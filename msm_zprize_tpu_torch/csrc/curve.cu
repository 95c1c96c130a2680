// K3, K4, K4m, K5, K6, K7 on native storage of BLS12-377's base field:
// (32, W) 12-bit limb tensors. The formulas, the kernels and the bounds
// argument are in curve.cuh; this unit instantiates them for
// LimbStore<Fp32>, and holds the one C entry of every curve unit.
#include "curve.cuh"

namespace msm {
namespace wei {

int limbs_fp32(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
               const uint32_t* consts, cudaStream_t s) {
  return launch_curve<LimbStore<Fp32>>(kernel, ptrs, lds, W, arg, consts, s);
}

// The curve units and the (shape ID, codec id; 0: limbs) each takes.
struct CurveUnitEntry {
  int shape, codec;
  CurveUnit* launch;
};
constexpr CurveUnitEntry CURVE_UNITS[] = {
    {Fp32::ID, 0, limbs_fp32},   {Fp32::ID, CODEC_PACKED31, packed_fp32},
    {Fp33::ID, 0, limbs_fp33},   {Fp33::ID, CODEC_PACKED31, packed_fp33},
    {Fp22c::ID, 0, limbs_fp22c}, {Fp22c::ID, CODEC_PACKED31, packed_fp22c},
    {Fp22c::ID, CODEC_FMA51, fma51_fp22c},
};

}  // namespace wei
}  // namespace msm

// Curve kernel `kernel` (curve.cuh's CURVE_K3..CURVE_K7) on the storage of
// the field shape `shape` (a field.cuh ID) and the codec `codec` (0 for
// 12-bit limbs, else a codec.cuh codec id). ptrs/lds: the kernel's operands
// in its order (curve.cuh), then its outputs; arg: K4's masked flag, K5's k.
// Refuses a (shape, codec) pair no unit builds, and field constants that do
// not fit the shape.
extern "C" int msm_curve(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                         int kernel, int codec, int arg, const uint32_t* consts, void* stream) {
  for (const auto& unit : msm::wei::CURVE_UNITS) {
    if (unit.shape == shape && unit.codec == codec) {
      return unit.launch(kernel, ptrs, lds, W, arg, consts, static_cast<cudaStream_t>(stream));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
