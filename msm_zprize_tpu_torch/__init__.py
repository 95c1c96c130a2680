"""PyTorch + CUDA port of the BLS12-377 MSM pipeline of ``msm_zprize_tpu``.

The JAX package stays the reference; this package mirrors its main path
(``Weierstrass.msm`` -> ``msm_batched_affine(mode="projective")``) with
torch glue and hand-written CUDA kernels for Hopper (``csrc/``). Every
kernel wrapper dispatches on the device of its tensors: CUDA tensors launch
the kernel, CPU tensors run the plain PyTorch twin. Importing this package
imports neither JAX nor any module of the JAX package.
"""
