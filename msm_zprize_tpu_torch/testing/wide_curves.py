"""Curves of the wide-field tests: BN462, ed25519 and a toy curve at n = 63.

Test fixtures, not curves of the port's public surface (``curves/params.py``
and ``WEIERSTRASS_CURVES`` keep the JAX package's four): they drive the
kernels of fields outside the main library's shapes through the normal
entry points, ``Weierstrass.create(BN462).msm`` and
``TwistedEdwards.create(ED25519).msm``.

* ``BN462``: the Barreto-Naehrig curve of the IRTF CFRG draft
  *Pairing-Friendly Curves* (draft-irtf-cfrg-pairing-friendly-curves,
  BN462), y^2 = x^3 + 5 over a 462-bit p, u = 2^114 + 2^101 - 2^14 - 1,
  p = 36u^4 + 36u^3 + 24u^2 + 6u + 1, prime order q = 36u^4 + 36u^3 +
  18u^2 + 6u + 1 (cofactor 1), generator (1, y) with y a square root of 6.
  Its GLV endomorphism (x, y) -> (beta x, y) acts as lambda = 36u^3 + 18u^2
  + 6u + 1, a cube root of unity mod q; beta = 18u^3 + 18u^2 + 9u + 1, the
  cube root of unity mod p that matches it. Both fields take n = 39 limbs
  (R = 2^468): a shape made on demand of 15 words, and a GLV scalar module
  of halves of ~231 bits.
* ``ED25519``: the twisted Edwards form of Curve25519 (RFC 8032, section
  5.1): -x^2 + y^2 = 1 + d x^2 y^2 over p = 2^255 - 19, d = -121665 /
  121666, subgroup order l = 2^252 + 27742317777372353535851937790883648493
  (cofactor 8), base point B with y = 4/5 and x the even root. Its field
  takes the 9-word shape made on demand (n = 22, 2p > 2^256).
* ``TOY63_P`` = 2^750 + 12883, a prime p = 3 (mod 4) of 751 bits,
  n = 63 limbs, R = 2^756 > 32p, the widest field the limb code takes (24
  words); ``toy63_points`` draws points of y^2 = x^3 + ``TOY63_B`` on it by
  square root (p = 3 mod 4). No group of known order: the curve kernels'
  formulas are polynomial identities, so the kernels and their twins compare
  on any values, and these points only make the inputs real ones.

Each fact above is asserted here, once, at import.
"""

from __future__ import annotations

import numpy as np

from ..bigint import field as bf
from ..bigint.weierstrass import AffineCurve
from ..curves.params import EdwardsParams, WeierstrassParams
from .points import _edwards_add, _scale

__all__ = ["BN462", "ED25519", "TOY63_P", "TOY63_B", "toy63_points"]

_u = 2**114 + 2**101 - 2**14 - 1
_p462 = 36 * _u**4 + 36 * _u**3 + 24 * _u**2 + 6 * _u + 1
_q462 = 36 * _u**4 + 36 * _u**3 + 18 * _u**2 + 6 * _u + 1
_y462 = bf.sqrt(6, _p462)
BN462 = WeierstrassParams(
    label="bn462",
    modulus=_p462,
    order=_q462,
    cofactor=1,
    b=5,
    generator=(1, min(_y462, _p462 - _y462)),
    lambda_=36 * _u**3 + 18 * _u**2 + 6 * _u + 1,
    beta=18 * _u**3 + 18 * _u**2 + 9 * _u + 1,
)

_p25519 = (1 << 255) - 19
_d25519 = -121665 * pow(121666, -1, _p25519) % _p25519
_y25519 = 4 * pow(5, -1, _p25519) % _p25519
_x25519 = bf.sqrt((_y25519 * _y25519 - 1) * pow(_d25519 * _y25519 * _y25519 + 1, -1, _p25519)
                  % _p25519, _p25519)
ED25519 = EdwardsParams(
    label="ed25519",
    modulus=_p25519,
    order=(1 << 252) + 27742317777372353535851937790883648493,
    cofactor=8,
    d=_d25519,
    generator=(_x25519 if _x25519 % 2 == 0 else _p25519 - _x25519, _y25519),
)

TOY63_P = (1 << 750) + 12883
TOY63_B = 7


def _check() -> None:
    p, q = BN462.modulus, BN462.order
    assert p.bit_length() == q.bit_length() == 462
    assert bf.is_probable_prime(p) and bf.is_probable_prime(q)
    curve, G = AffineCurve(BN462), BN462.generator
    assert curve.is_on_curve(G) and curve.scale(q, G) is None
    assert pow(BN462.lambda_, 3, q) == 1 != BN462.lambda_
    assert pow(BN462.beta, 3, p) == 1 != BN462.beta
    assert curve.scale(BN462.lambda_, G) == (BN462.beta * G[0] % p, G[1])
    E, (x, y) = ED25519, ED25519.generator
    pe = E.modulus
    assert (-x * x + y * y - 1 - E.d * x * x % pe * y * y) % pe == 0 and x % 2 == 0
    assert _scale(_edwards_add(E), (0, 1), E.order, E.generator) == (0, 1)
    assert bf.is_probable_prime(E.order)
    assert bf.is_probable_prime(TOY63_P) and TOY63_P % 4 == 3 and TOY63_P.bit_length() == 751


def toy63_points(count: int, seed: int) -> list[tuple[int, int]]:
    """``count`` points (x, y) of y^2 = x^3 + TOY63_B over TOY63_P: x drawn
    from ``numpy.random.default_rng(seed)``, y = (x^3 + b)^((p + 1) / 4)
    where that squares back (about half the draws)."""
    p, rng, out = TOY63_P, np.random.default_rng(seed), []
    while len(out) < count:
        x = int.from_bytes(rng.bytes(96), "little") % p
        rhs = (x * x * x + TOY63_B) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            out.append((x, y))
    return out


_check()
