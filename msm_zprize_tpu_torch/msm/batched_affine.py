"""Flagship MSM: GLV + signed digits + padded projective bucket engine.

Mirror of the projective mode of ``msm_zprize_tpu/msm/batched_affine.py``:

* ``glv_prep``: beta * x for the endomorphism (K1) and the fused GLV
  decomposition + signed windowing of both scalar halves (K2);
* ``accumulate_glv_projective``: the padded engine with the fused level-1
  kernel (K3) and complete projective adds (K4);
* ``finalize_projective_buckets``: log-depth bucket reduction and Horner
  (K4, K5).

Only ``mode="projective"`` is ported; the batched-affine and halving modes
are ROADMAP queue-1 item 9 ("Other MSM modes").
"""

from __future__ import annotations

import torch

from ..curves.weierstrass import AffinePoints, ProjectivePoints, WeierstrassOps
from ..fields.cuda_scalar import glv_digits
from ..fields.scalar import GlvScalar
from . import engine
from .common import default_windows, window_size

__all__ = [
    "glv_prep",
    "accumulate_glv_projective",
    "finalize_projective_buckets",
    "msm_batched_affine",
]


def glv_prep(W: WeierstrassOps, S: GlvScalar, scalars, points: AffinePoints, c: int):
    """GLV decomposition + endomorphism expansion to 2N points, and signed
    c-bit digits of both scalar halves. Returns (pts2, mags, signs, K, L)."""
    K = default_windows(S.max_bits, c)
    L = 1 << (c - 1)
    endo = W.endomorphism(points)
    pts2 = AffinePoints(*(torch.cat([a, b], dim=-1) for a, b in zip(points, endo)))
    mags, signs = glv_digits(S, scalars, c, K)
    # points at infinity never contribute: zero their digits
    mags = torch.where(pts2.inf.bool()[None, :], 0, mags)
    return pts2, mags, signs, K, L


class _ProjAcc:
    """Projective accumulator ops for the bucket reduction and Horner."""

    def __init__(self, W: WeierstrassOps, device):
        self.W = W
        self.device = device

    def zero(self, *batch):
        return self.W.proj_zeros(*batch, device=self.device)

    def add(self, a, b):
        return self.W.proj_add(ProjectivePoints(*a), ProjectivePoints(*b))

    def double_k(self, a, k):
        return self.W.proj_double_k(ProjectivePoints(*a), k)


def accumulate_glv_projective(W: WeierstrassOps, S: GlvScalar, scalars, points: AffinePoints,
                              c: int):
    """Projective bucket sums (leaves (n, K, L); the identity, Z = 0, marks
    empty buckets) of the GLV-expanded, signed-digit MSM."""
    pts2, mags, signs, K, L = glv_prep(W, S, scalars, points, c)
    device = mags.device

    def prepare(leaves, flag, valid):
        x, y = leaves
        y = W.coord_cneg(y, flag)
        one = W.coord_ones(*y.shape[1:], device=device)
        # the exact identity (0 : 1 : 0) on invalid lanes: RCB completeness
        # needs curve points, and clamped-gather lanes are not to be counted
        return (
            torch.where(valid, x, torch.zeros_like(x)),
            torch.where(valid, y, one),
            torch.where(valid, one, torch.zeros_like(one)),
        )

    def pair_add(a, b):
        return tuple(W.proj_add(ProjectivePoints(*a), ProjectivePoints(*b)))

    def zero_like(K_, L_):
        return tuple(W.proj_zeros(K_, L_, device=device))

    def pair_level1(a, b, sa, sb, va, vb):
        return tuple(W.aff_pair_add(a[0], a[1], sa, va, b[0], b[1], sb, vb))

    # stream the window axis when the (M, K, L) slot buffers exceed the budget
    M = engine.slot_count(mags.shape[-1], L)
    chunks = max(1, -(-(M * K * L) // engine.MAX_SLOTS))
    sums = engine.accumulate_buckets_padded(
        (pts2.x, pts2.y), mags, signs, L, pair_add, prepare, zero_like,
        pair_level1=pair_level1, window_chunks=chunks,
    )
    return ProjectivePoints(*sums)


def finalize_projective_buckets(W: WeierstrassOps, sums: ProjectivePoints, c: int) -> ProjectivePoints:
    """Bucket reduction + Horner -> a (n, 1)-batched projective point."""
    acc = _ProjAcc(W, sums.X.device)
    c0 = max((c - 1) // 2, 1)
    per_window = engine.reduce_buckets_log(sums, c0, acc)
    return engine.horner(per_window, c, acc.add, acc.double_k)


def msm_batched_affine(W: WeierstrassOps, S: GlvScalar, scalars, points: AffinePoints,
                       c: int | None = None, mode: str = "projective") -> ProjectivePoints:
    """scalars: (n_scalar, N) plain limbs in [0, q); points: affine batch (N).
    Returns the MSM as one projective point (batch size 1)."""
    if mode != "projective":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP queue 1, item 9: other MSM modes)"
        )
    N = points.x.shape[-1]
    if c is None:
        c = window_size("batched-affine", max(N.bit_length() - 1, 1))
    sums = accumulate_glv_projective(W, S, scalars, points, c)
    return finalize_projective_buckets(W, sums, c)
