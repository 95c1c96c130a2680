"""MSM without GLV over any complete curve group: signed digits (K9) on
the padded or the halving bucket engine.

Mirror of ``msm_zprize_tpu/msm/basic.py``:

* ``msm_basic_projective``: projective Weierstrass points on the halving
  engine, pair adds on K4, then log-depth reduction and Horner (K4, K5);
* ``accumulate_edwards`` (``mode="basic"``): twisted-Edwards points on the
  halving engine, pair adds on K11;
* ``accumulate_edwards_padded`` (``mode="padded"``, the default): signed
  digits, normalization to Z = 1 (``batch_normalize``: K1 and one K8), and
  the padded engine with the fused unit-Z level-1 kernel (K10) and unified
  adds (K11);
* ``finalize_edwards``: log-depth bucket reduction and Horner (K11, K12).
"""

from __future__ import annotations

import torch

from ..curves.edwards import EdwardsOps, ExtPoints
from ..curves.weierstrass import ProjectivePoints, WeierstrassOps
from ..fields.cuda_scalar import simple_digits
from . import engine
from .batched_affine import finalize_projective_buckets
from .common import default_windows, window_size

__all__ = [
    "msm_basic_projective", "edwards_prep", "accumulate_edwards", "accumulate_edwards_padded",
    "finalize_edwards", "msm_basic_edwards",
]

EDWARDS_MODES = ("padded", "basic")


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


def _signed_windows(scalars, scalar_bits: int, c: int):
    """Signed c-bit digits of plain scalars (K9). Returns (mags, signs, K, L)."""
    K = default_windows(scalar_bits, c)
    mags, signs = simple_digits(scalars, c, K)
    return mags, signs, K, 1 << (c - 1)


def msm_basic_projective(W: WeierstrassOps, scalars, points: ProjectivePoints, scalar_bits: int,
                         c: int | None = None) -> ProjectivePoints:
    """MSM over projective Weierstrass points (no GLV); scalars (n, B) plain
    limbs. Returns one projective point (batch size 1)."""
    B = points.X.shape[-1]
    if c is None:
        c = window_size("projective", max(B.bit_length() - 1, 1))
    mags, signs, K, L = _signed_windows(scalars, scalar_bits, c)
    device = points.X.device

    def prepare(P, flag):
        return ProjectivePoints(P.X, W.F.cneg(P.Y, flag), P.Z)

    def pair_add(P0, P1, has_partner, valid):
        return engine.select(has_partner, W.proj_add(P0, P1), P0)

    sums, _ = engine.accumulate_buckets(points, mags, signs, L, pair_add, prepare,
                                        lambda K_, L_: W.proj_zeros(K_, L_, device=device))
    return finalize_projective_buckets(W, sums, c)


def accumulate_edwards(E: EdwardsOps, scalars, points: ExtPoints, scalar_bits: int,
                       c: int) -> ExtPoints:
    """Extended bucket sums (leaves (n, K, L); the identity where empty) by
    the halving engine: the unified add needs no mask, so a pair add is K11
    and a select."""
    mags, signs, K, L = _signed_windows(scalars, scalar_bits, c)
    acc = _EdAcc(E, points.X.device)

    def pair_add(P0, P1, has_partner, valid):
        return engine.select(has_partner, E.add(P0, P1), P0)

    sums, _ = engine.accumulate_buckets(points, mags, signs, L, pair_add, E.cneg, acc.zero)
    return sums


def edwards_prep(E: EdwardsOps, scalars, points: ExtPoints, scalar_bits: int, c: int):
    """Signed c-bit digits of the scalars and the points normalized to Z = 1
    (the identity stays the identity). Returns (pts, mags, signs, K, L)."""
    mags, signs, K, L = _signed_windows(scalars, scalar_bits, c)
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
    mode: "padded" (the default) or "basic" (the halving engine). Returns
    the MSM as one extended point (batch size 1)."""
    if mode not in EDWARDS_MODES:
        raise ValueError(f"unknown Edwards MSM mode {mode!r}; expected one of {EDWARDS_MODES}")
    N = points.X.shape[-1]
    if c is None:
        c = window_size("edwards", max(N.bit_length() - 1, 1))
    if mode == "padded":
        sums = accumulate_edwards_padded(E, scalars, points, scalar_bits, c)
    else:
        sums = accumulate_edwards(E, scalars, points, scalar_bits, c)
    return finalize_edwards(E, sums, c)
