"""Host short-Weierstrass curve (a = 0): y^2 = x^3 + b.

Mirror of ``msm_zprize_tpu/bigint/weierstrass.py``: ``AffineCurve`` (``None``
is the identity, a point otherwise an ``(x, y)`` tuple of ints in [0, p))
and ``ProjectiveCurve`` (``(X, Y, Z)``, identity ``(0, 1, 0)``; the
add-1998-cmo-2 / dbl-1998-cmo-2 formulas), with the same group law, the
same ``random`` draws and the same oracle methods. ``WeierstrassParams`` is
the port's own (``curves/params.py``).
"""

from __future__ import annotations

from ..curves.params import WeierstrassParams
from .field import Field, inverse, random_field, sqrt

__all__ = ["WeierstrassParams", "AffineCurve", "ProjectiveCurve"]


class AffineCurve:
    zero = None

    def __init__(self, params: WeierstrassParams):
        self.params = params
        self.F = Field(params.modulus)
        self.p = params.modulus
        self.b = params.b % params.modulus

    def is_zero(self, P) -> bool:
        return P is None

    def eq(self, P, Q) -> bool:
        return P == Q

    def neg(self, P):
        return None if P is None else (P[0], (-P[1]) % self.p)

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

    def is_in_subgroup(self, P) -> bool:
        return self.scale(self.params.order, P) is None

    def endomorphism(self, P):
        """(x, y) -> (beta x, y): the scalar lambda on the subgroup."""
        if P is None:
            return None
        assert self.params.beta is not None
        return self.params.beta * P[0] % self.p, P[1]

    def random(self, rng=None):
        """x uniform until x^3 + b is a square, y its root with a random
        sign, then the cofactor cleared: a point of the prime-order
        subgroup (the domain of the complete formulas)."""
        p = self.p
        while True:
            x = random_field(p, rng)
            y = sqrt((x * x * x + self.b) % p, p)
            if y is None:
                continue
            if rng is not None and rng.getrandbits(1):
                y = (-y) % p
            P = (x, y)
            if self.params.cofactor != 1:
                P = self.scale(self.params.cofactor, P)
                if P is None:
                    continue
            return P


class ProjectiveCurve:
    """(X : Y : Z) with identity (0 : 1 : 0): the JAX oracle's formulas
    (add-1998-cmo-2 with its doubling fallback, dbl-1998-cmo-2)."""

    zero = (0, 1, 0)

    def __init__(self, params: WeierstrassParams):
        self.params = params
        self.F = Field(params.modulus)
        self.b = params.b % params.modulus

    def is_zero(self, P) -> bool:
        return P[2] == 0

    def eq(self, P, Q) -> bool:
        """Equal as points: X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1 (both at infinity
        or neither)."""
        p = self.F.p
        (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
        if Z1 == 0 or Z2 == 0:
            return Z1 == Z2
        return (X1 * Z2 - X2 * Z1) % p == 0 and (Y1 * Z2 - Y2 * Z1) % p == 0

    def neg(self, P):
        X, Y, Z = P
        return X, (-Y) % self.F.p, Z

    def add(self, P, Q):
        p = self.F.p
        if P[2] == 0:
            return Q
        if Q[2] == 0:
            return P
        (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
        Y1Z2, X1Z2, Z1Z2 = Y1 * Z2 % p, X1 * Z2 % p, Z1 * Z2 % p
        u = (Y2 * Z1 - Y1Z2) % p
        v = (X2 * Z1 - X1Z2) % p
        if v == 0:
            return self.double(P) if u == 0 else self.zero  # P == Q, or P == -Q
        vv = v * v % p
        vvv = vv * v % p
        R = vv * X1Z2 % p
        A = (u * u % p * Z1Z2 - vvv - 2 * R) % p
        return v * A % p, (u * (R - A) - vvv * Y1Z2) % p, vvv * Z1Z2 % p

    def double(self, P):
        p = self.F.p
        X1, Y1, Z1 = P
        if Z1 == 0 or Y1 == 0:
            return self.zero
        w = 3 * X1 * X1 % p
        s = Y1 * Z1 % p
        ss = s * s % p
        Ry = Y1 * s % p
        B = X1 * Ry % p
        h = (w * w - 8 * B) % p
        return 2 * h * s % p, (w * (4 * B - h) - 8 * Ry * Ry) % p, 8 * ss * s % p

    def sub(self, P, Q):
        return self.add(P, self.neg(Q))

    def scale(self, s: int, P):
        """Double-and-add, LSB first."""
        R, Q = self.zero, P
        while s > 0:
            if s & 1:
                R = self.add(R, Q)
            Q = self.double(Q)
            s >>= 1
        return R

    def to_affine(self, P):
        X, Y, Z = P
        if Z == 0:
            return None
        zi = inverse(Z, self.F.p)
        return X * zi % self.F.p, Y * zi % self.F.p

    def from_affine(self, P):
        return self.zero if P is None else (P[0], P[1], 1)

    def is_on_curve(self, P) -> bool:
        """Y^2 Z = X^3 + b Z^3; any (0 : Y : 0) is the identity."""
        X, Y, Z = P
        p = self.F.p
        if Z == 0:
            return (X, Y % p) == (0, 1) or X == 0
        return (Y * Y % p * Z - (X * X * X + self.b * Z * Z % p * Z)) % p == 0

    def random(self, rng=None, random_z: bool = True):
        """AffineCurve.random's point, scaled by a random Z (the same draws)."""
        x, y = AffineCurve(self.params).random(rng)
        if random_z:
            z = random_field(self.F.p, rng) or 1
            return x * z % self.F.p, y * z % self.F.p, z
        return x, y, 1
