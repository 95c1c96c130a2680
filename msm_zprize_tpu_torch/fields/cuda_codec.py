"""K13 wrapper: the Montgomery product on row-codec storage
(``csrc/montmul.cu``, ``montmul_rows_kernel``), and its plain twin.

K13 replaces ``msm_zprize_tpu/fields/fma51_pallas.py::montmul51_pallas``. On
the codec modes' paths it computes beta * x for the GLV endomorphism over
all N points: on ``PackedCodec`` rows (13 on BLS12-377 and BLS12-381, 9 on
Pallas, 15 on BN462's 462-bit field, any p through the library of its
shape made on demand) in ``mode="packed"``, on 10 ``Fma51Codec`` pair rows
in Pallas's ``mode="fma51"`` (any p < 2^255 - 2^206). CUDA tensors launch the
kernel; CPU tensors run ``montmul_rows_plain``: decode to digit planes,
``MontgomeryFp.montmul_plain`` (the twin of K1), encode. Both give the same
integer, x*y*R^-1 mod p below 2p with R = 2^(12 n), in the codec's rows.
"""

from __future__ import annotations

import torch

from .. import _build
from ..counters import COUNTS
from .codec import CODEC_IDS

__all__ = ["montmul_rows", "montmul_rows_plain"]

# launch counters: K13 on PackedCodec rows (beta * x of the packed MSMs), and
# on Fma51Codec rows (beta * x of Pallas's fma51 MSM)
K13, K13_FMA51 = "k13_montmul_rows", "k13_montmul_rows_fma51"


def montmul_rows_plain(F, codec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The twin of K13 on (rows, *batch) codec rows of values < 2p."""
    out = F.montmul_plain(codec.to_digits(F, x), codec.to_digits(F, y))
    return codec.from_digits(F, out)


def montmul_rows(F, codec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x*y*R^-1 mod p for (rows, W) int32 codec rows of values < 2p (CUDA
    operands may have strided rows). Output (rows, W): a value < 2p."""
    if _build.on_cpu(x, y):
        return montmul_rows_plain(F, codec, x, y)
    rows, W = codec.rows, x.shape[-1]
    lds = [_build.rows(x, rows, W, "x"), _build.rows(y, rows, W, "y"), W]
    cid = _build.codec_arg(F, codec)
    words = _build.field_words(F)
    out = torch.empty((rows, W), dtype=torch.int32, device=x.device)
    if W == 0:
        return out
    shape = _build.field_shape(F)
    lib, _ = _build.library(shape)
    code = lib.msm_montmul_rows(
        _build.ptrs(x, y, out), _build.ints(lds), W, shape, cid, words, _build.stream_of(x),
    )
    name = K13_FMA51 if cid == CODEC_IDS["Fma51Codec"] else K13
    _build.check(code, name)
    COUNTS[name] += 1
    return out
