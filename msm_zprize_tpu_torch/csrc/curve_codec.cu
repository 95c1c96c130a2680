// K14: K3, K4, K4m, K5, K6, K7 on row-codec storage, (13, W) 31-bit rows of
// BLS12-377's base field (PackedCodec, the first entry of codec.cuh's codec
// table). The formulas, the kernels and the bounds argument are in
// curve.cuh; this unit instantiates them for that storage in its own nvcc
// process, beside curve.cu.
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
//
// Fma51Codec storage needs a Weierstrass curve below 2^255 - 2^206 (Pallas)
// and the field shape with a ninth value word: ROADMAP queue 1, item 15.
#include <type_traits>

#include "curve.cuh"

using msm::wei::S;
using Entry = std::tuple_element_t<0, msm::CodecTable>;
static_assert(std::is_same_v<Entry::S, S>, "K14 takes the field shape of curve.cuh");
using Store = msm::RowStore<S, Entry::C>;

// The same entry points as curve.cu's, on row storage: each takes the
// field's limb count n and refuses any but 32.
extern "C" int msm_codec_aff_pair_add(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                                      int n, const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_aff_pair_add<Store>(ptrs, lds, W, consts,
                                              static_cast<cudaStream_t>(stream));
}

extern "C" int msm_codec_proj_add(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                                  int masked, const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_add<Store>(ptrs, lds, W, masked, consts,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int msm_codec_proj_double_k(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                                       int n, int k, const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_double_k<Store>(ptrs, lds, W, k, consts,
                                               static_cast<cudaStream_t>(stream));
}

extern "C" int msm_codec_proj_double(const uint64_t* ptrs, const int64_t* lds, int64_t W, int n,
                                     const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_double<Store>(ptrs, lds, W, consts,
                                             static_cast<cudaStream_t>(stream));
}

extern "C" int msm_codec_proj_add_mixed(const uint64_t* ptrs, const int64_t* lds, int64_t W,
                                        int n, const uint32_t* consts, void* stream) {
  if (n != S::NL) return static_cast<int>(cudaErrorInvalidValue);
  return msm::wei::launch_proj_add_mixed<Store>(ptrs, lds, W, consts,
                                                static_cast<cudaStream_t>(stream));
}
