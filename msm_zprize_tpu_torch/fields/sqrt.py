"""Batched square roots and the quadratic-residue test over torch limb tensors.

Mirror of ``msm_zprize_tpu/fields/sqrt.py`` (``FieldSqrt``, ``make_sqrt``):
fixed-depth Tonelli-Shanks with per-lane masks, no data-dependent control
flow. Write p - 1 = Q 2^M with Q odd and c0 = z^Q for a non-residue z:

    t = x^Q, r = x^((Q+1)/2), c = c0
    for i = M, M-1, ..., 2:
        d = t^(2^(i-2));  where d != 1: r *= c, t *= c^2
        c = c^2

For M = 1 (p = 3 mod 4) the root is the one power x^((p+1)/4). The long
powers are ``exp_const`` (K8 on the card); the squaring chain and the masked
products are K1 launches, sum(i - 2) squarings for i = M..2 (990 on
BLS12-377's base field, M = 46). Every lane runs every step: the depth is the
same for every input.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .fp import MontgomeryFp, make_field

__all__ = ["FieldSqrt", "make_sqrt"]


def _nonresidue(p: int) -> int:
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return z


class FieldSqrt:
    """Batched sqrt and quadratic-residue test for one field."""

    def __init__(self, F: MontgomeryFp):
        self.F = F
        p = F.p
        Q, M = p - 1, 0
        while Q % 2 == 0:
            Q //= 2
            M += 1
        self.Q = Q
        self.M = M
        self.z = _nonresidue(p)
        self.c0_mont = pow(self.z, Q, p) * F.R % p  # a primitive 2^M-th root of unity

    def is_square(self, x):
        """Euler's criterion x^((p-1)/2) == 1, with x = 0 a square. x in
        Montgomery form (any representative); returns (*batch,) bool."""
        F = self.F
        e = F.exp_const(x, (F.p - 1) // 2)
        return F.is_equal(e, F.ones_mont(*x.shape[1:], device=x.device)) | F.is_zero(x)

    def sqrt(self, x):
        """(root, ok): root^2 == x on the lanes where ok; a non-residue lane
        has ok False and an unspecified root. sqrt(0) = 0 with ok True."""
        F = self.F
        if self.M == 1:
            r = F.exp_const(x, (F.p + 1) // 4)
        else:
            t = F.exp_const(x, self.Q)
            r = F.exp_const(x, (self.Q + 1) // 2)
            c = F.const(self.c0_mont, x).expand(x.shape).contiguous()
            one = F.ones_mont(*x.shape[1:], device=x.device)
            for i in range(self.M, 1, -1):
                d = t
                for _ in range(i - 2):
                    d = F.montsquare(d)
                flag = ~F.is_equal(d, one)
                c2 = F.montsquare(c)
                r = torch.where(flag, F.montmul(r, c), r)
                t = torch.where(flag, F.montmul(t, c2), t)
                c = c2
        zero = F.is_zero(x)
        ok = F.is_equal(F.montsquare(r), x) | zero
        return torch.where(zero, torch.zeros_like(r), r), ok


@lru_cache(maxsize=None)
def make_sqrt(p: int, w: int = 12) -> FieldSqrt:
    return FieldSqrt(make_field(p, w))
