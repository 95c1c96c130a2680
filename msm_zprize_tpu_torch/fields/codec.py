"""Row codecs: field values stored as int32 rows instead of 12-bit digit planes.

Mirror of the codec classes of ``msm_zprize_tpu/fields/fma51_pallas.py``
(``_RowCodecMethods``, ``Fma51Codec``, ``PackedCodec``). A value is held in
``rows`` int32 planes, row r holding bits [offsets[r], offsets[r] +
widths[r]) of the value; every row is masked to its width and never
negative. Two codecs:

* ``PackedCodec(p)``: dense 31-bit rows, ceil((bits(p) + 1) / 31) of them
  (13 for BLS12-377's 377-bit field against 32 digit planes), any p;
* ``Fma51Codec(p)``: five 51-bit limbs as 10 rows of (26, 25)-bit halves,
  the top pair (26, 26) (256 bits), only for p < 2^255 - 2^206.

``to_digits`` and ``from_digits`` convert rows to and from the port's
(n, *batch) 12-bit digit planes as plain torch ops: the glue of the codec
MSM modes (``from_native``/``to_native``, ``coord_cneg``) and the building
blocks of the plain twins of K13 and K14. The CUDA kernels decode and
encode the same layouts in registers (``csrc/codec.cuh``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np
import torch

__all__ = ["Fma51Codec", "PackedCodec", "FMA51_BOUND", "CODEC_IDS", "codec_id", "regroup"]

W51, N51 = 51, 5
# The 51x5 layout keeps lazy [0, 2p) values only below this bound
# (the reference's src/51x5/field.ts:15-18)
FMA51_BOUND = (1 << 255) - (1 << 206)


def _layout(widths) -> tuple:
    off, acc = [], 0
    for wd in widths:
        off.append(acc)
        acc += wd
    return tuple(off)


@lru_cache(maxsize=None)
def _plan(src_widths: tuple, dst_widths: tuple, ndim: int, device: torch.device):
    """regroup's tables, made once per layout pair and device: for each
    piece slot j, (source row, right shift, mask, left shift) per
    destination plane; a plane with fewer pieces gets mask 0."""
    so, do = _layout(src_widths), _layout(dst_widths)
    pieces = []
    for lo_d, wd_d in zip(do, dst_widths):
        row = []
        for r, (lo_s, wd_s) in enumerate(zip(so, src_widths)):
            lo, hi = max(lo_s, lo_d), min(lo_s + wd_s, lo_d + wd_d)
            if lo < hi:
                row.append((r, lo - lo_s, (1 << (hi - lo)) - 1, lo - lo_d))
        pieces.append(row)
    shape = (len(dst_widths),) + (1,) * (ndim - 1)
    plan = []
    for j in range(max(len(p) for p in pieces)):
        cols = np.array([p[j] if j < len(p) else (0, 0, 0, 0) for p in pieces], dtype=np.int64)
        idx = torch.as_tensor(cols[:, 0], device=device)
        plan.append((idx, *(torch.as_tensor(cols[:, i].astype(np.int32), device=device).reshape(shape)
                            for i in (1, 2, 3))))
    return plan


@torch.no_grad()
def regroup(src: torch.Tensor, src_widths, dst_widths) -> torch.Tensor:
    """Re-cut the bits of (len(src_widths), *batch) int32 planes into
    (len(dst_widths), *batch) planes: plane j of the result holds bits
    [sum(dst_widths[:j]), ... + dst_widths[j]) of the value the source
    planes hold (each source plane read within its width; bits past the
    source's capacity are 0, bits past the destination's are dropped).

    Each destination plane draws from at most a few source planes: one
    gather, shift and mask per piece slot, all planes at once. The source
    planes must be non-negative."""
    plan = _plan(tuple(src_widths), tuple(dst_widths), src.dim(), src.device)
    out = torch.zeros((len(dst_widths),) + tuple(src.shape[1:]), dtype=torch.int32, device=src.device)
    for idx, rs, mask, ls in plan:
        out |= ((src.index_select(0, idx) >> rs) & mask) << ls
    return out


class _RowCodecMethods:
    """Shared machinery of the row codecs: ``widths`` (from the subclass)
    fixes the offsets and the bit capacity."""

    @cached_property
    def offsets(self) -> tuple:
        return _layout(self.widths)

    @cached_property
    def capacity_bits(self) -> int:
        return self.offsets[-1] + self.widths[-1]

    # ---- host-side pack/unpack -------------------------------------------

    def pack(self, values) -> np.ndarray:
        """Python ints in [0, 2^capacity) -> (rows, B) int32 rows."""
        out = np.zeros((self.rows, len(values)), dtype=np.int32)
        for j, v in enumerate(values):
            if not 0 <= v < (1 << self.capacity_bits):
                raise ValueError(f"value outside the codec's {self.capacity_bits}-bit capacity")
            for r, (off, wd) in enumerate(zip(self.offsets, self.widths)):
                out[r, j] = (v >> off) & ((1 << wd) - 1)
        return out

    def unpack(self, arr) -> list:
        """(rows, *batch) rows -> Python ints."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr).reshape(self.rows, -1)
        out = []
        for j in range(a.shape[1]):
            v = 0
            for r, off in enumerate(self.offsets):
                v |= int(a[r, j]) << off
            out.append(v)
        return out

    # ---- torch decode/encode (the glue, and the plain twins of K13/K14) -----

    def to_digits(self, F, arr: torch.Tensor) -> torch.Tensor:
        """(rows, *batch) rows -> (n, *batch) canonical 12-bit digit planes of
        the field F (a ``MontgomeryFp``); bits at or above 12 n are dropped."""
        return regroup(arr, self.widths, (F.w,) * F.n)

    def from_digits(self, F, digits: torch.Tensor, vmax: int | None = None) -> torch.Tensor:
        """(n, *batch) digit planes of a value <= vmax (default 2p - 1) ->
        (rows, *batch) rows of a value in [0, 2p). The digits are carried
        to canonical form, then the conditional-subtract chain of the JAX
        package's kernel encode takes the largest k p (k a power of two)
        while vmax >= 2p. For values below 2p this is a pure repack, equal to
        the JAX ``from_digits`` row for row (which takes the caller's word
        that the value is below 2p and runs no chain)."""
        p = F.p
        vmax = 2 * p - 1 if vmax is None else vmax
        d = F.canon(digits)
        while vmax >= 2 * p:
            k = 2
            while 2 * k * p <= vmax:
                k <<= 1
            d = F._sub_const_select(d, np.array(F.scheme.to_limbs(k * p), dtype=np.int32))
            vmax = max(k * p - 1, vmax - k * p)
        return regroup(d, (F.w,) * F.n, self.widths)


@dataclass(frozen=True)
class Fma51Codec(_RowCodecMethods):
    """5 x 51-bit limbs as 10 int32 rows of (26, 25)-bit halves; the top
    pair's hi row holds 26 bits (a 52-bit top limb, 256 bits in all)."""

    p: int

    def __post_init__(self):
        if not self.p < FMA51_BOUND:
            raise ValueError(f"51x5 requires p < 2^255 - 2^206; p has {self.p.bit_length()} bits")

    rows: int = 10

    @cached_property
    def widths(self) -> tuple:
        w = []
        for i in range(N51):
            w.append(26)
            w.append(25 if i < N51 - 1 else 26)
        return tuple(w)

    def pack51(self, limbs51) -> list:
        """5 x 51-bit int limbs -> the 10 row ints."""
        v = sum(int(l) << (W51 * i) for i, l in enumerate(limbs51))
        return [(v >> off) & ((1 << wd) - 1) for off, wd in zip(self.offsets, self.widths)]


@dataclass(frozen=True)
class PackedCodec(_RowCodecMethods):
    """Dense 31-bit rows, valid for any p: ceil((bits(p) + 1) / 31) rows
    hold a [0, 2p) value (13 for a 377-bit field)."""

    p: int
    row_bits: int = 31

    @cached_property
    def widths(self) -> tuple:
        need = self.p.bit_length() + 1  # [0, 2p) capacity
        return (self.row_bits,) * -(-need // self.row_bits)

    @cached_property
    def rows(self) -> int:
        return len(self.widths)


# The kernels' names of the codecs (``csrc/codec.cuh``): 31-bit packed rows,
# 51x5 pair rows.
CODEC_IDS = {"PackedCodec": 1, "Fma51Codec": 2}


def codec_id(codec) -> int:
    """The id of ``codec`` in the kernels' codec table."""
    if isinstance(codec, PackedCodec) and codec.row_bits == 31:
        return CODEC_IDS["PackedCodec"]
    if isinstance(codec, Fma51Codec):
        return CODEC_IDS["Fma51Codec"]
    raise ValueError(f"no CUDA kernel for the codec {codec!r}")
