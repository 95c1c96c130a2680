"""PyTorch + CUDA port of the MSM pipelines of ``msm_zprize_tpu``.

The JAX package stays the reference; this package mirrors two of its paths
with torch glue and hand-written CUDA kernels for Hopper (``csrc/``): the
BLS12-377 projective MSM (``Weierstrass.msm`` ->
``msm_batched_affine(mode="projective")``) and the ed-on-bls12-377
twisted-Edwards MSM (``TwistedEdwards.msm`` -> ``msm_basic_edwards(mode=
"padded")``). Every
kernel wrapper dispatches on the device of its tensors: CUDA tensors launch
the kernel, CPU tensors run the plain PyTorch twin. Importing this package
imports neither JAX nor any module of the JAX package.
"""
