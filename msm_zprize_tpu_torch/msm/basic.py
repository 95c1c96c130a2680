"""Twisted-Edwards MSM: signed digits (no GLV) on the padded bucket engine.

Mirror of the Edwards padded path of ``msm_zprize_tpu/msm/basic.py``:

* ``accumulate_edwards_padded``: signed c-bit digits (K9), normalization of
  the points to Z = 1 (``batch_normalize``: K1 and one K8), and the padded
  engine with the fused unit-Z level-1 kernel (K10) and unified adds (K11);
* ``finalize_edwards``: log-depth bucket reduction and Horner (K11, K12).

Only ``mode="padded"`` is ported; the halving engine (``mode="basic"``) is
ROADMAP queue 1, item 9 ("Other MSM modes").
"""

from __future__ import annotations

import torch

from ..curves.edwards import EdwardsOps, ExtPoints
from ..fields.cuda_scalar import simple_digits
from . import engine
from .common import default_windows, window_size

__all__ = ["edwards_prep", "accumulate_edwards_padded", "finalize_edwards", "msm_basic_edwards"]


class _EdAcc:
    """Extended-point accumulator ops for the bucket reduction and Horner."""

    def __init__(self, E: EdwardsOps, device):
        self.E = E
        self.device = device

    def zero(self, *batch):
        return self.E.zeros(*batch, device=self.device)

    def add(self, a, b):
        return self.E.add(ExtPoints(*a), ExtPoints(*b))

    def double_k(self, a, k):
        return self.E.double_k(ExtPoints(*a), k)


def edwards_prep(E: EdwardsOps, scalars, points: ExtPoints, scalar_bits: int, c: int):
    """Signed c-bit digits of the scalars and the points normalized to Z = 1
    (the identity stays the identity). Returns (pts, mags, signs, K, L)."""
    K = default_windows(scalar_bits, c)
    L = 1 << (c - 1)
    mags, signs = simple_digits(scalars, c, K)
    return E.batch_normalize(points), mags, signs, K, L


def accumulate_edwards_padded(E: EdwardsOps, scalars, points: ExtPoints, scalar_bits: int,
                              c: int) -> ExtPoints:
    """Extended bucket sums (leaves (n, K, L); the identity marks empty
    buckets). The points are normalized to affine (Z = 1) so each slot
    gathers only (x, y), and the level-1 kernel rebuilds T."""
    pts, mags, signs, K, L = edwards_prep(E, scalars, points, scalar_bits, c)
    F = E.F
    device = mags.device

    def prepare(leaves, sg, valid):
        x, y = leaves
        one = F.ones_mont(*y.shape[1:], device=device)
        xs = torch.where(valid, F.cneg(x, sg), torch.zeros_like(x))
        ys = torch.where(valid, y, one)
        return xs, ys, one, F.montmul(xs, ys)

    def pair_add(a, b):
        return tuple(E.add(ExtPoints(*a), ExtPoints(*b)))

    def pair_level1(a, b, sa, sb, va, vb):
        return tuple(E.ed_pair_add(a[0], a[1], sa, va, b[0], b[1], sb, vb))

    def zero_like(K_, L_):
        return tuple(E.zeros(K_, L_, device=device))

    # stream the window axis when the (M, K, L) slot buffers exceed the budget
    M = engine.slot_count(mags.shape[-1], L)
    chunks = max(1, -(-(M * K * L) // engine.MAX_SLOTS))
    sums = engine.accumulate_buckets_padded(
        (pts.X, pts.Y), mags, signs, L, pair_add, prepare, zero_like,
        pair_level1=pair_level1, window_chunks=chunks,
    )
    return ExtPoints(*sums)


def finalize_edwards(E: EdwardsOps, sums: ExtPoints, c: int) -> ExtPoints:
    """Bucket reduction + Horner -> a (n, 1)-batched extended point."""
    acc = _EdAcc(E, sums.X.device)
    c0 = max((c - 1) // 2, 1)
    per_window = engine.reduce_buckets_log(sums, c0, acc)
    return engine.horner(per_window, c, acc.add, acc.double_k)


def msm_basic_edwards(E: EdwardsOps, scalars, points: ExtPoints, scalar_bits: int,
                      c: int | None = None, mode: str = "padded") -> ExtPoints:
    """scalars: (n_scalar, N) plain limbs; points: extended batch (N).
    Returns the MSM as one extended point (batch size 1)."""
    if mode != "padded":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP queue 1, item 9: other MSM modes)"
        )
    N = points.X.shape[-1]
    if c is None:
        c = window_size("edwards", max(N.bit_length() - 1, 1))
    sums = accumulate_edwards_padded(E, scalars, points, scalar_bits, c)
    return finalize_edwards(E, sums, c)
