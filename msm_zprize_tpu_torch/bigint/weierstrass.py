"""Host short-Weierstrass curve (a = 0), affine: y^2 = x^3 + b.

Mirror of ``msm_zprize_tpu/bigint/weierstrass.py::AffineCurve``'s group law
and ``random``: ``None`` is the identity, a point otherwise an ``(x, y)``
tuple of ints in [0, p).
"""

from __future__ import annotations

from ..curves.params import WeierstrassParams
from .field import inverse, random_field, sqrt

__all__ = ["AffineCurve"]


class AffineCurve:
    zero = None

    def __init__(self, params: WeierstrassParams):
        self.params = params
        self.p = params.modulus
        self.b = params.b % params.modulus

    def add(self, P, Q):
        p = self.p
        if P is None:
            return Q
        if Q is None:
            return P
        (x1, y1), (x2, y2) = P, Q
        if x1 == x2:
            return None if (y1 + y2) % p == 0 else self.double(P)
        m = (y2 - y1) * inverse(x2 - x1, p) % p
        x3 = (m * m - x1 - x2) % p
        return x3, (m * (x1 - x3) - y1) % p

    def double(self, P):
        p = self.p
        if P is None or P[1] == 0:
            return None
        x, y = P
        m = 3 * x * x * inverse(2 * y, p) % p
        x3 = (m * m - 2 * x) % p
        return x3, (m * (x - x3) - y) % p

    def scale(self, s: int, P):
        """Double-and-add, LSB first."""
        R, Q = None, P
        while s > 0:
            if s & 1:
                R = self.add(R, Q)
            Q = self.double(Q)
            s >>= 1
        return R

    def is_on_curve(self, P) -> bool:
        if P is None:
            return True
        x, y = P
        return (y * y - (x * x * x + self.b)) % self.p == 0

    def random(self, rng):
        """x uniform until x^3 + b is a square, y its root with a random
        sign, then the cofactor cleared: a point of the prime-order
        subgroup (the domain of the complete formulas)."""
        p = self.p
        while True:
            x = random_field(p, rng)
            y = sqrt((x * x * x + self.b) % p, p)
            if y is None:
                continue
            if rng.getrandbits(1):
                y = (-y) % p
            P = (x, y)
            if self.params.cofactor != 1:
                P = self.scale(self.params.cofactor, P)
                if P is None:
                    continue
            return P
