"""K1 and K8 wrappers: Montgomery product and static exponentiation
(``csrc/montmul.cu``).

K1 replaces ``msm_zprize_tpu/fields/pallas_mul.py::montmul_pallas``. On the
BLS12-377 main path it computes beta * x for the GLV endomorphism over all
N points; on the Edwards path it carries ``batch_inverse``. K8 replaces
``exp_const_pallas``: x^e in one launch, the Fermat inverse at the bottom of
``batch_inverse``. CUDA tensors launch the kernels; CPU tensors run the
plain twins ``MontgomeryFp.montmul_plain`` (the JAX conv path's algorithm)
and ``MontgomeryFp.exp_const_plain`` (the JAX windowed square-and-multiply).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..counters import COUNTS

__all__ = ["montmul", "exp_const"]

KERNEL = "k1_montmul"
K8 = "k8_exp_const"


def montmul(F, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x*y*R^-1 mod p for (n, W) int32 limb tensors (values < 4p; CUDA
    operands may have strided limb rows). Output (n, W): canonical limbs,
    value < 2p."""
    if _build.on_cpu(x, y):
        return F.montmul_plain(x, y)
    n, W = x.shape[0], x.shape[-1]
    lds = [_build.rows(x, n, W, "x"), _build.rows(y, n, W, "y"), W]
    words = _build.field_words(F)
    out = torch.empty((n, W), dtype=torch.int32, device=x.device)
    if W == 0:
        return out
    lib, _ = _build.library()
    code = lib.msm_montmul(
        _build.ptrs(x, y, out), _build.ints(lds), W, n, words, _build.stream_of(x)
    )
    _build.check(code, KERNEL)
    COUNTS[KERNEL] += 1
    return out


def exp_const(F, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a static exponent e >= 0 on (n, W) Montgomery limbs (values
    < 4p). Output (n, W): canonical limbs, value < 2p (e = 0 gives one)."""
    if e < 0:
        raise ValueError("exp_const needs e >= 0")
    if _build.on_cpu(x):
        return F.exp_const_plain(x, e)
    n, W = x.shape[0], x.shape[-1]
    lds = [_build.rows(x, n, W, "x"), W]
    words = _build.field_words(F)
    lib, _ = _build.library()
    n_words = lib.msm_exp_words() - 1
    if e.bit_length() > 32 * n_words:
        raise ValueError(f"the K8 kernel takes exponents below 2^{32 * n_words}")
    ebits = [(e >> (32 * i)) & 0xFFFFFFFF for i in range(n_words)] + [e.bit_length()]
    out = torch.empty((n, W), dtype=torch.int32, device=x.device)
    if W == 0:
        return out
    code = lib.msm_exp_const(
        _build.ptrs(x, out), _build.ints(lds), W, n, _build.ints(ebits, ctypes.c_uint32),
        words, _build.stream_of(x),
    )
    _build.check(code, K8)
    COUNTS[K8] += 1
    return out
