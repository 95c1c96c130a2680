"""Flagship MSM: GLV + signed digits, in three accumulation modes.

Mirror of ``msm_zprize_tpu/msm/batched_affine.py``:

* ``glv_prep``: beta * x for the endomorphism (K1) and the fused GLV
  decomposition + signed windowing of both scalar halves, with the digits
  of points at infinity zeroed (K2 for ``GlvScalar``; any other scalar
  module, the special split ``GlvScalarSpecialMsm`` among them, takes its
  own ``decompose`` and ``signed_digits`` as torch ops, as in the JAX
  package, which has no kernel for them);
* ``mode="projective"`` (the default): the padded engine with the fused
  level-1 kernel (K3) and complete projective adds (K4), then
  ``finalize_projective_buckets``: log-depth reduction and Horner (K4, K5);
* ``mode="affine"``: the reference's ZPrize pipeline, the halving engine
  with batched-affine adds (``WeierstrassOps.batch_add``: one shared batch
  inversion per level, K1 and K8), then ``finalize_affine_buckets``: the
  sequential reduction on mixed adds (K7) and Horner;
* ``mode="halving"``: the halving engine with masked complete adds (K4m),
  then ``finalize_projective_buckets``.

``safe=False`` (``msm_unsafe``) is the msmUnsafe contract of the affine
mode: every effective point distinct. The codec storage modes (``"packed"``,
``"fma51"``) run the projective pipeline with row-codec curve ops
(``curves/weierstrass51.py``) as ``W``; ``parallel/api.py`` converts the
points in and the result out.
"""

from __future__ import annotations

import torch

from ..curves.weierstrass import AffinePoints, ProjectivePoints, WeierstrassOps
from ..fields.cuda_scalar import glv_digits
from ..fields.scalar import GlvScalar, signed_digits
from . import engine
from .common import default_windows, window_size

__all__ = [
    "glv_prep",
    "accumulate_glv_projective",
    "accumulate_batched_affine",
    "accumulate_glv_halving",
    "finalize_projective_buckets",
    "finalize_affine_buckets",
    "msm_batched_affine",
]

MODES = ("projective", "affine", "halving")


def glv_prep(W: WeierstrassOps, S: GlvScalar, scalars, points: AffinePoints, c: int):
    """GLV decomposition + endomorphism expansion to 2N points (beta * x on
    K1, or K13 on codec rows), and signed c-bit digits of both scalar
    halves. Returns (pts2, mags, signs, K, L)."""
    K = default_windows(S.max_bits, c)
    L = 1 << (c - 1)
    endo = W.endomorphism(points)
    pts2 = AffinePoints(*(torch.cat([a, b], dim=-1) for a, b in zip(points, endo)))
    if isinstance(S, GlvScalar):
        # points at infinity never contribute: K2 zeroes their digits
        mags, signs = glv_digits(S, scalars, c, K, inf=pts2.inf)
        return pts2, mags, signs, K, L
    sg0, u0, sg1, u1 = S.decompose(scalars)
    m0, s0 = signed_digits(u0, c, K, S.w, scalar_sign=sg0)
    m1, s1 = signed_digits(u1, c, K, S.w, scalar_sign=sg1)
    mags = torch.where(pts2.inf.bool()[None, :], 0, torch.cat([m0, m1], dim=-1))
    return pts2, mags, torch.cat([s0, s1], dim=-1), K, L


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


class _AffineAcc(_ProjAcc):
    """Projective accumulators fed by affine bucket points (mixed adds, K7;
    empty buckets are infinity, which K7 passes over)."""

    def add_point(self, acc, pt, nonempty):
        return self.W.proj_add_affine(ProjectivePoints(*acc), AffinePoints(*pt))


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


def accumulate_batched_affine(W: WeierstrassOps, S: GlvScalar, scalars, points: AffinePoints,
                              c: int, safe: bool = True):
    """Affine bucket sums (leaves (n, K, L), infinity where empty) and the
    empty mask (K, L), by the halving engine with batched-affine adds."""
    pts2, mags, signs, K, L = glv_prep(W, S, scalars, points, c)
    device = mags.device

    def pair_add(P0, P1, has_partner, valid):
        summed = W.batch_add(P0, P1, safe=safe, active=has_partner)
        return engine.select(has_partner, summed, P0)

    return engine.accumulate_buckets(
        pts2, mags, signs, L, pair_add, W.affine_cneg,
        lambda K_, L_: W.affine_zeros(K_, L_, device=device),
    )


def accumulate_glv_halving(W: WeierstrassOps, S: GlvScalar, scalars, points: AffinePoints,
                           c: int):
    """Projective bucket sums (the identity, Z = 0, where empty) and the
    empty mask, by the halving engine with masked complete adds (K4m): the
    gather moves affine points, which become projective after it."""
    pts2, mags, signs, K, L = glv_prep(W, S, scalars, points, c)
    device = mags.device

    def pair_add(P0, P1, has_partner, valid):
        return W.proj_add(P0, P1, mask=has_partner)

    return engine.accumulate_buckets(
        pts2, mags, signs, L, pair_add, lambda A, flag: W.from_affine(W.affine_cneg(A, flag)),
        lambda K_, L_: W.proj_zeros(K_, L_, device=device),
    )


def finalize_affine_buckets(W: WeierstrassOps, sums: AffinePoints, empty, c: int) -> ProjectivePoints:
    """Sequential bucket reduction on mixed adds + Horner -> a (n, 1)-batched
    projective point."""
    acc = _AffineAcc(W, sums.x.device)
    c0 = max((c - 1) // 2, 1)
    per_window = engine.reduce_buckets(sums, empty, c0, acc)
    return engine.horner(per_window, c, acc.add, acc.double_k)


def finalize_projective_buckets(W: WeierstrassOps, sums: ProjectivePoints, c: int) -> ProjectivePoints:
    """Bucket reduction + Horner -> a (n, 1)-batched projective point."""
    acc = _ProjAcc(W, sums.X.device)
    c0 = max((c - 1) // 2, 1)
    per_window = engine.reduce_buckets_log(sums, c0, acc)
    return engine.horner(per_window, c, acc.add, acc.double_k)


def msm_batched_affine(W: WeierstrassOps, S: GlvScalar, scalars, points: AffinePoints,
                       c: int | None = None, safe: bool = True,
                       mode: str = "projective") -> ProjectivePoints:
    """scalars: (n_scalar, N) plain limbs in [0, q); points: affine batch (N).
    Returns the MSM as one projective point (batch size 1). ``safe`` reaches
    only the affine mode (the complete adds of the others are always safe)."""
    if mode not in MODES:
        raise ValueError(f"unknown MSM mode {mode!r}; expected one of {MODES}")
    N = points.x.shape[-1]
    if c is None:
        c = window_size("batched-affine", max(N.bit_length() - 1, 1))
    if mode == "projective":
        sums = accumulate_glv_projective(W, S, scalars, points, c)
        return finalize_projective_buckets(W, sums, c)
    if mode == "halving":
        sums, _ = accumulate_glv_halving(W, S, scalars, points, c)
        return finalize_projective_buckets(W, sums, c)
    sums, empty = accumulate_batched_affine(W, S, scalars, points, c, safe)
    return finalize_affine_buckets(W, sums, empty, c)
