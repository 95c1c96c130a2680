// K3, K4, K4m, K5, K6, K7 on native storage of BLS12-377's base field:
// (32, W) 12-bit limb tensors. The formulas, the kernels and the bounds
// argument are in curve.cuh; this unit instantiates them for
// LimbStore<Fp32>, and holds the one C entry of every curve unit. Built with
// -DMSM_DYN_SHAPE (_build.py, a shape made on demand, n = 1..63), it
// instantiates them for LimbStore<DynShape>, and its table names the two
// codec units of that library (curve_codec.cu, curve_pallas_codec.cu).
#include "curve.cuh"

namespace msm {
namespace wei {

// The curve units and the (shape ID, codec id; 0: limbs) each takes.
struct CurveUnitEntry {
  int shape, codec;
  CurveUnit* launch;
};

#ifdef MSM_DYN_SHAPE
// A library built for one shape made on demand (field.cuh's DynShape): this
// unit on limbs, and the shape's codec storages (codec.cuh's table).
int limbs_dyn(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
              int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<LimbStore<DynShape>>(kernel, ptrs, lds, W, arg, group, consts, s);
}
constexpr CurveUnitEntry CURVE_UNITS[] = {
    {DynShape::ID, 0, limbs_dyn}, {DynShape::ID, CODEC_PACKED31, packed_dyn},
#if MSM_DYN_ROWS <= 9
    {DynShape::ID, CODEC_FMA51, fma51_dyn},
#endif
};
#else
int limbs_fp32(int kernel, const uint64_t* ptrs, const int64_t* lds, int64_t W, int arg,
               int group, const uint32_t* consts, cudaStream_t s) {
  return launch_curve<LimbStore<Fp32>>(kernel, ptrs, lds, W, arg, group, consts, s);
}

constexpr CurveUnitEntry CURVE_UNITS[] = {
    {Fp32::ID, 0, limbs_fp32},   {Fp32::ID, CODEC_PACKED31, packed_fp32},
    {Fp33::ID, 0, limbs_fp33},   {Fp33::ID, CODEC_PACKED31, packed_fp33},
    {Fp22c::ID, 0, limbs_fp22c}, {Fp22c::ID, CODEC_PACKED31, packed_fp22c},
    {Fp22c::ID, CODEC_FMA51, fma51_fp22c},
};
#endif

// fn(S{}) for the shape S with ID `shape` when a curve unit builds the
// storage (shape, codec), else -1.
template <class Fn>
int with_curve_unit(int shape, int codec, Fn fn) {
  for (const auto& unit : CURVE_UNITS) {
    if (unit.shape == shape && unit.codec == codec) return with_shape(shape, fn);
  }
  return -1;
}

}  // namespace wei
}  // namespace msm

// Curve kernel `kernel` (curve.cuh's CURVE_K3..CURVE_K7) on the storage of
// the field shape `shape` (a field.cuh ID) and the codec `codec` (0 for
// 12-bit limbs, else a codec.cuh codec id). ptrs/lds: the kernel's operands
// in its order (curve.cuh), then its outputs; arg: K4's masked flag, K5's k;
// group: 0 for the instance curve_group's table picks at this width, else
// the G of a built K3, K4, K5 or K7 instance. Refuses a (shape, codec) pair no unit
// builds, an instance not built, and field constants that do not fit the
// shape.
extern "C" int msm_curve(const uint64_t* ptrs, const int64_t* lds, int64_t W, int shape,
                         int kernel, int codec, int arg, int group, const uint32_t* consts,
                         void* stream) {
  for (const auto& unit : msm::wei::CURVE_UNITS) {
    if (unit.shape == shape && unit.codec == codec) {
      return unit.launch(kernel, ptrs, lds, W, arg, group, consts,
                         static_cast<cudaStream_t>(stream));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The G (threads a point) of the instance that msm_curve launches for
// kernel `kernel` (with `arg` as msm_curve takes it) at width W on the
// storage (shape, codec) when group is 0; -1 for a storage no unit builds.
extern "C" int msm_curve_group(int shape, int codec, int kernel, int64_t W, int arg) {
  return msm::wei::with_curve_unit(shape, codec, [&](auto s) {
    return msm::wei::curve_group<decltype(s)>(kernel, W, arg != 0, codec != 0);
  });
}

// The Gs of the instances of kernel `kernel` (K3, K4 with `masked`, K5, K7)
// built on the storage (shape, codec), into out[0, cap): the ones msm_curve
// takes as its group; returns how many there are, -1 for a storage no unit
// builds.
extern "C" int msm_curve_groups(int shape, int codec, int kernel, int masked, int* out, int cap) {
  return msm::wei::with_curve_unit(shape, codec, [&](auto s) {
    return msm::wei::built_groups<decltype(s)>(kernel, masked != 0, codec != 0, out, cap);
  });
}
