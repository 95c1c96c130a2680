"""K2 and K9 wrappers: scalar digits (``csrc/glv_digits.cu``).

K2 replaces ``msm_zprize_tpu/fields/pallas_scalar.py::glv_digits_pallas``
(GLV decomposition + signed windowing, the BLS12-377 path); K9 replaces
``simple_digits_pallas`` (signed windowing alone, the Edwards path). CUDA
tensors launch the kernels; CPU tensors run the plain twins
``glv_digits_plain`` (``GlvScalar.decompose`` + ``signed_digits``) and
``signed_digits``. Kernel and twin return bit-identical digit planes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..counters import COUNTS
from .scalar import GlvScalar, signed_digits

__all__ = ["glv_digits", "glv_digits_plain", "simple_digits"]

KERNEL = "k2_glv_digits"
K9 = "k9_simple_digits"


def glv_digits_plain(S: GlvScalar, scalars: torch.Tensor, c: int, K: int):
    sg0, u0, sg1, u1 = S.decompose(scalars)
    m0, s0 = signed_digits(u0, c, K, S.w, scalar_sign=sg0)
    m1, s1 = signed_digits(u1, c, K, S.w, scalar_sign=sg1)
    return torch.cat([m0, m1], dim=-1), torch.cat([s0, s1], dim=-1)


@functools.cache
def _consts(S: GlvScalar) -> ctypes.Array:
    """GlvConsts words (csrc/glv_digits.cu) from the scalar module, packed
    once per module."""
    if S.w != 12 or len(S.m0) != len(S.m1):
        raise ValueError("the K2 kernel supports 12-bit limbs only")
    words = [S.n, S.n_half, S.n_acc, S.K0_limbs, len(S.m0)]
    terms = S.terms()
    words += [sg for _, sg, _ in terms]
    words += [int(v) for v in S.m0] + [int(v) for v in S.m1]
    for _, _, name in terms:
        v = S.sv[name][1]
        if len(v) > S.n_half:
            raise ValueError(f"basis row {name} wider than n_half limbs")
        words += [int(x) for x in np.pad(v, (0, S.n_half - len(v)))]
    lib, _ = _build.library()
    if len(words) != lib.msm_glv_const_words():
        raise ValueError(
            "scalar module sizes differ from the compiled K2 kernel "
            f"(n={S.n}, n_half={S.n_half}, n_acc={S.n_acc}, K0={S.K0_limbs}, n_m={len(S.m0)})"
        )
    return _build.ints(words, ctypes.c_int32)


def glv_digits(S: GlvScalar, scalars: torch.Tensor, c: int, K: int):
    """scalars: (n, N) canonical limbs in [0, q). Returns (mags, signs),
    each (K, 2N) int32: GLV half 0 in columns [0, N), half 1 in [N, 2N)."""
    if _build.on_cpu(scalars):
        return glv_digits_plain(S, scalars, c, K)
    N = scalars.shape[-1]
    lds = [_build.rows(scalars, S.n, N, "scalars")]
    words = _consts(S)
    mags = torch.empty((K, 2 * N), dtype=torch.int32, device=scalars.device)
    signs = torch.empty_like(mags)
    if N == 0:
        return mags, signs
    lib, _ = _build.library()
    code = lib.msm_glv_digits(
        _build.ptrs(scalars, mags, signs), _build.ints(lds), N, c, K, words,
        _build.stream_of(scalars),
    )
    _build.check(code, KERNEL)
    COUNTS[KERNEL] += 1
    return mags, signs


def simple_digits(scalars: torch.Tensor, c: int, K: int, w: int = 12):
    """scalars: (n, N) canonical w-bit limbs. Returns (mags, signs), each
    (K, N) int32: signed c-bit digits, magnitudes in [0, 2^(c-1)], a zero
    digit with sign 0."""
    if _build.on_cpu(scalars):
        return signed_digits(scalars, c, K, w)
    if w != 12:
        raise ValueError("the K9 kernel supports 12-bit limbs only")
    n, N = scalars.shape
    lds = [_build.rows(scalars, n, N, "scalars")]
    mags = torch.empty((K, N), dtype=torch.int32, device=scalars.device)
    signs = torch.empty_like(mags)
    if N == 0:
        return mags, signs
    lib, _ = _build.library()
    code = lib.msm_simple_digits(
        _build.ptrs(scalars, mags, signs), _build.ints(lds), N, n, c, K,
        _build.stream_of(scalars),
    )
    _build.check(code, K9)
    COUNTS[K9] += 1
    return mags, signs
