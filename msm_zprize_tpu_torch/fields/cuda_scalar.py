"""K2 and K9 wrappers: scalar digits (``csrc/glv_digits.cu``).

K2 replaces ``msm_zprize_tpu/fields/pallas_scalar.py::glv_digits_pallas``
(GLV decomposition + signed windowing, the BLS12-377 path); K9 replaces
``simple_digits_pallas`` (signed windowing alone, the Edwards path). CUDA
tensors launch the kernels; CPU tensors run the plain twins
``glv_digits_plain`` (``GlvScalar.decompose`` + ``signed_digits``, then
glv_prep's infinity mask) and ``signed_digits``. Kernel and twin return
bit-identical digit planes. K2 computes on 32-bit words what the twin
computes on 12-bit limbs; ``_const_words`` packs its constants. The main
library's K2 takes the modules of BLS12-377, BLS12-381 and Pallas (their
sizes, ``_build.GLV_MAIN_DIMS``); any other w = 12 ``GlvScalar`` (BN462's
462-bit q among them) launches K2 from a library built for its sizes
(``_build.scalar_library``). K9 takes any limb count n at run time.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..counters import COUNTS
from .scalar import GlvScalar, signed_digits

__all__ = ["MAX_C", "glv_digits", "glv_digits_plain", "simple_digits"]

KERNEL = "k2_glv_digits"
K9 = "k9_simple_digits"
# The widest window c (csrc/glv_digits.cu::MAX_C): signed_digits, here and in
# the JAX package, holds window + carry <= 2^c and 2^c in int32.
MAX_C = 30


def _check_window(c: int) -> None:
    if not 1 <= c <= MAX_C:
        raise ValueError(f"window size c={c} outside 1..{MAX_C}: the digit recoding holds 2^c in int32")


def glv_digits_plain(S: GlvScalar, scalars: torch.Tensor, c: int, K: int, inf=None):
    sg0, u0, sg1, u1 = S.decompose(scalars)
    m0, s0 = signed_digits(u0, c, K, S.w, scalar_sign=sg0)
    m1, s1 = signed_digits(u1, c, K, S.w, scalar_sign=sg1)
    mags = torch.cat([m0, m1], dim=-1)
    if inf is not None:  # points at infinity never contribute: zero their digits
        mags = torch.where(inf.bool()[None, :], 0, mags)
    return mags, torch.cat([s0, s1], dim=-1)


def _words(limbs, w: int, count: int) -> list[int]:
    """A little-endian limb array as ``count`` 32-bit words."""
    value = sum(int(v) << (w * i) for i, v in enumerate(limbs))
    if value >> (32 * count):
        raise ValueError(f"a K2 constant is wider than {count} words")
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(count)]


def _dims(S: GlvScalar) -> tuple:
    """The sizes K2 is built for (``_build.GLV_MAIN_DIMS``' order): n, n_half,
    n_acc, K0 limbs, limbs of m_i, and the 32-bit words of a scalar."""
    return (S.n, S.n_half, S.n_acc, S.K0_limbs, len(S.m0), -(-S.q.bit_length() // 32))


def _library(S: GlvScalar):
    """The kernel library whose K2 takes S: the main one, or S's own."""
    dims = _dims(S)
    return _build.library() if dims == _build.GLV_MAIN_DIMS else _build.scalar_library(dims)


def _const_words(S: GlvScalar) -> list[int]:
    """GlvConsts (csrc/glv_digits.cu) as 32-bit words: the limb sizes, the
    four terms' signs, m0 and m1 in MW words each, then |v| of the terms
    a-d in VW words each (MW, VW: the fewest words that hold the limbs of
    m_i and of |s_i|; 5 and 5 on the main library's modules)."""
    if S.w != 12 or len(S.m0) != len(S.m1):
        raise ValueError("the K2 kernel supports 12-bit limbs only")
    mw, vw = -(-S.w * len(S.m0) // 32), -(-S.w * S.n_half // 32)
    words = [S.n, S.n_half, S.n_acc, S.K0_limbs, len(S.m0)]
    terms = S.terms()
    words += [sg & 0xFFFFFFFF for _, sg, _ in terms]
    words += _words(S.m0, S.w, mw) + _words(S.m1, S.w, mw)
    for _, _, name in terms:
        v = S.sv[name][1]
        if len(v) > S.n_half:
            raise ValueError(f"basis row {name} wider than n_half limbs")
        words += _words(v, S.w, vw)
    return words


@functools.cache
def _consts(S: GlvScalar) -> ctypes.Array:
    """``_const_words`` for the C entry, packed once per module; the
    compiled kernel must take as many words (its sizes are the module's)."""
    words = _const_words(S)
    lib, _ = _library(S)
    if len(words) != lib.msm_glv_const_words():
        raise ValueError(
            "scalar module sizes differ from the compiled K2 kernel "
            f"(n={S.n}, n_half={S.n_half}, n_acc={S.n_acc}, K0={S.K0_limbs}, n_m={len(S.m0)})"
        )
    return _build.ints(words, ctypes.c_uint32)


def glv_digits(S: GlvScalar, scalars: torch.Tensor, c: int, K: int, inf=None):
    """scalars: (n, N) canonical limbs in [0, q); inf: None or the (2N,)
    int32 infinity flags of the GLV-expanded points. Returns (mags, signs),
    each (K, 2N) int32: GLV half 0 in columns [0, N), half 1 in [N, 2N);
    magnitudes 0 in the columns whose flag is set (signs untouched).
    c must lie in 1..MAX_C."""
    _check_window(c)
    operands = (scalars,) if inf is None else (scalars, inf)
    if _build.on_cpu(*operands):
        return glv_digits_plain(S, scalars, c, K, inf)
    N = scalars.shape[-1]
    lds = [_build.rows(scalars, S.n, N, "scalars")]
    if inf is not None:
        _build.flags(inf, 2 * N, "inf")
    words = _consts(S)
    mags = torch.empty((K, 2 * N), dtype=torch.int32, device=scalars.device)
    signs = torch.empty_like(mags)
    if N == 0:
        return mags, signs
    lib, _ = _library(S)
    ptrs = (ctypes.c_uint64 * 4)(*_build.ptrs(scalars, mags, signs),
                                 0 if inf is None else inf.data_ptr())
    code = lib.msm_glv_digits(ptrs, _build.ints(lds), N, c, K, words, _build.stream_of(scalars))
    _build.check(code, KERNEL)
    COUNTS[KERNEL] += 1
    return mags, signs


def simple_digits(scalars: torch.Tensor, c: int, K: int, w: int = 12):
    """scalars: (n, N) canonical w-bit limbs. Returns (mags, signs), each
    (K, N) int32: signed c-bit digits, magnitudes in [0, 2^(c-1)], a zero
    digit with sign 0. c must lie in 1..MAX_C."""
    _check_window(c)
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
