"""Limb codec and generic limb-vector arithmetic on torch int32 tensors.

Mirror of ``msm_zprize_tpu/fields/limbs.py`` with the same layout: a vector
of big integers is an ``int32`` tensor of shape ``(n, *batch)``, limbs
little-endian along axis 0, ``w`` bits per limb (default 12). The products
here are bounded by the same int32 column budget as the JAX code
(``2n * 2^(2w) < 2^31``), and ``>>`` on int32 is an arithmetic shift, as
in JAX, so signed intermediates carry the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..bigint.field import to_limbs

__all__ = [
    "DTYPE",
    "LimbScheme",
    "pack",
    "unpack",
    "carry_chain",
    "mul_low",
    "mul_full",
    "mul_shift_floor",
    "add_mod_pow2",
    "sub_mod_pow2",
    "negate_mod_pow2",
    "extract_bits",
    "bit_planes",
    "column",
]

DTYPE = torch.int32


@dataclass(frozen=True)
class LimbScheme:
    """w bits per limb, n limbs (total capacity n*w bits)."""

    w: int
    n: int

    @cached_property
    def mask(self) -> int:
        return (1 << self.w) - 1

    @cached_property
    def bits(self) -> int:
        return self.n * self.w

    def to_limbs(self, x: int) -> list[int]:
        return to_limbs(x, self.w, self.n)


def pack(values, scheme: LimbScheme) -> np.ndarray:
    """Python ints -> (n, B) int32 limb array (numpy, host side)."""
    out = np.empty((scheme.n, len(values)), dtype=np.int32)
    for j, v in enumerate(values):
        if not 0 <= v < (1 << scheme.bits):
            raise ValueError("value out of limb range")
        out[:, j] = scheme.to_limbs(v)
    return out


def unpack(arr, scheme: LimbScheme) -> list[int]:
    """(n, *batch) limb array -> list of Python ints (limbs may be signed:
    the sum is exact either way)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.asarray(arr).reshape(scheme.n, -1)
    out = []
    for j in range(flat.shape[1]):
        x = 0
        for i in range(scheme.n):
            x += int(flat[i, j]) << (scheme.w * i)
        out.append(x)
    return out


def carry_chain(limbs: torch.Tensor, w: int, n_out: int | None = None) -> torch.Tensor:
    """Sequential carry propagation: (m, B) limbs (possibly oversized or
    signed) -> (n_out, B) canonical limbs in [0, 2^w); the carry out of the
    top limb is dropped (arithmetic mod 2^(w*n_out))."""
    mask = (1 << w) - 1
    m = limbs.shape[0]
    n_out = m if n_out is None else n_out
    out = []
    carry = None
    for i in range(n_out):
        t = limbs[i] if i < m else torch.zeros_like(limbs[0])
        if carry is not None:
            t = t + carry
        out.append(t & mask)
        carry = t >> w
    return torch.stack(out, dim=0)


def _column_products(x: torch.Tensor, y: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Schoolbook columns C_k = sum_{i+j=k} x_i*y_j for k < n_cols."""
    nx, ny = x.shape[0], y.shape[0]
    batch = torch.broadcast_shapes(x.shape[1:], y.shape[1:])
    C = torch.zeros((n_cols,) + tuple(batch), dtype=DTYPE, device=x.device)
    for j in range(min(ny, n_cols)):
        hi = min(j + nx, n_cols)
        C[j:hi] += x[: hi - j] * y[j]
    return C


def mul_full(x: torch.Tensor, y: torch.Tensor, w: int) -> torch.Tensor:
    """Exact product of (nx, B) * (ny, B) -> (nx+ny, B) canonical limbs."""
    n_cols = x.shape[0] + y.shape[0]
    return carry_chain(_column_products(x, y, n_cols), w, n_cols)


def mul_low(x: torch.Tensor, y: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """Low ``n_out`` limbs of x*y (product mod 2^(w*n_out))."""
    return carry_chain(_column_products(x, y, n_out), w, n_out)


def mul_shift_floor(x, y, w: int, shift_limbs: int, n_out: int) -> torch.Tensor:
    """floor((x*y) >> (w*shift_limbs)), low ``n_out`` limbs of the result."""
    hi = mul_full(x, y, w)[shift_limbs : shift_limbs + n_out]
    if hi.shape[0] < n_out:
        pad = torch.zeros((n_out - hi.shape[0],) + hi.shape[1:], dtype=DTYPE, device=hi.device)
        hi = torch.cat([hi, pad], dim=0)
    return hi


def add_mod_pow2(x, y, w: int, n: int) -> torch.Tensor:
    """(x + y) mod 2^(w*n) over canonical limbs; result canonical."""
    return carry_chain(x[:n] + y[:n], w, n)


def sub_mod_pow2(x, y, w: int, n: int) -> torch.Tensor:
    """(x - y) mod 2^(w*n) over canonical limbs (two's-complement wrap)."""
    return carry_chain(x[:n] - y[:n], w, n)


def negate_mod_pow2(x, w: int, n: int) -> torch.Tensor:
    """(-x) mod 2^(w*n)."""
    return sub_mod_pow2(torch.zeros_like(x[:n]), x, w, n)


def column(limbs: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """A limb constant as an (m, 1, ..) column on ref's device, broadcastable
    against ref's (n, *batch)."""
    return torch.as_tensor(limbs, device=ref.device).reshape((-1,) + (1,) * (ref.dim() - 1))


def bit_planes(limbs: torch.Tensor, w: int) -> torch.Tensor:
    """Every bit of canonical (n, *batch) limbs, LSB first: (n * w, *batch)
    int32 in {0, 1}."""
    idx = torch.arange(limbs.shape[0] * w, device=limbs.device)
    shifts = (idx % w).to(limbs.dtype).reshape((-1,) + (1,) * (limbs.dim() - 1))
    return (limbs[idx // w] >> shifts) & 1


def extract_bits(limbs: torch.Tensor, offset: int, count: int, w: int) -> torch.Tensor:
    """The ``count``-bit window at bit ``offset`` of canonical (n, B) limbs
    -> (B,) int32; windows may span any number of limbs."""
    n = limbs.shape[0]
    k, sh = offset // w, offset % w
    val = torch.zeros(limbs.shape[1:], dtype=DTYPE, device=limbs.device)
    produced = 0
    while produced < count and k < n:
        piece = limbs[k] >> sh if produced == 0 else limbs[k]
        val = val | (piece << produced)
        produced += w - sh if produced == 0 else w
        k += 1
    return val & ((1 << count) - 1)
