"""K1 wrapper: batched Montgomery product (``csrc/montmul.cu``).

Replaces ``msm_zprize_tpu/fields/pallas_mul.py::montmul_pallas``. On the
MSM main path it computes beta * x for the GLV endomorphism over all N
points. CUDA tensors launch the kernel; CPU tensors run the plain twin
``MontgomeryFp.montmul_plain`` (the JAX conv path's algorithm).
"""

from __future__ import annotations

import torch

from .. import _build
from ..counters import COUNTS

__all__ = ["montmul"]

KERNEL = "k1_montmul"


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
        _build.ptrs(x, y, out), _build.ints(lds), W, words, _build.stream_of(x)
    )
    _build.check(code, KERNEL)
    COUNTS[KERNEL] += 1
    return out
