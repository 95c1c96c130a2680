"""Host twisted-Edwards curve (a = -1): -x^2 + y^2 = 1 + d x^2 y^2, in
extended coordinates (X, Y, Z, T), identity (0, 1, 1, 0).

Mirror of ``msm_zprize_tpu/bigint/edwards.py::EdwardsCurve``'s group law
(add-2008-hwcd-3, k = 2d) and ``random``.
"""

from __future__ import annotations

from ..curves.params import EdwardsParams
from .field import inverse, random_field, sqrt

__all__ = ["EdwardsCurve"]


class EdwardsCurve:
    zero = (0, 1, 1, 0)

    def __init__(self, params: EdwardsParams):
        self.params = params
        self.p = params.modulus
        self.d = params.d % params.modulus
        self.k = 2 * self.d % params.modulus

    def is_zero(self, P) -> bool:
        X, Y, Z, _ = P
        return X % self.p == 0 and (Y - Z) % self.p == 0

    def add(self, P, Q):
        """Strongly unified: doubles and adds the identity alike."""
        p = self.p
        X1, Y1, Z1, T1 = P
        X2, Y2, Z2, T2 = Q
        A = (Y1 - X1) * (Y2 - X2) % p
        B = (Y1 + X1) * (Y2 + X2) % p
        C = T1 * self.k % p * T2 % p
        D = 2 * Z1 * Z2 % p
        E, F, G, H = (B - A) % p, (D - C) % p, (D + C) % p, (B + A) % p
        return E * F % p, G * H % p, F * G % p, E * H % p

    def double(self, P):
        return self.add(P, P)

    def scale(self, s: int, P):
        R, Q = self.zero, P
        while s > 0:
            if s & 1:
                R = self.add(R, Q)
            Q = self.double(Q)
            s >>= 1
        return R

    def from_affine(self, xy):
        x, y = xy
        p = self.p
        return x % p, y % p, 1, x * y % p

    def to_affine(self, P):
        X, Y, Z, _ = P
        zi = inverse(Z, self.p)
        return X * zi % self.p, Y * zi % self.p

    def random(self, rng):
        """y uniform until (y^2 - 1) / (d y^2 + 1) is a square, x its root
        with a random sign, then the cofactor cleared."""
        p = self.p
        while True:
            y = random_field(p, rng)
            denom = (self.d * y * y + 1) % p
            if denom == 0:
                continue
            x = sqrt((y * y - 1) * inverse(denom, p) % p, p)
            if x is None:
                continue
            if rng.getrandbits(1):
                x = (-x) % p
            P = self.scale(self.params.cofactor, self.from_affine((x, y)))
            if self.is_zero(P):
                continue
            return P
