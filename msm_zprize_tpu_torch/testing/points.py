"""Host-side MSM inputs with known discrete logs (tests and the smoke run).

``points_with_logs`` (short Weierstrass) and ``ed_points_with_logs``
(twisted Edwards) walk the group: P_0 = r_0 G, and each next point adds one
entry of a table of multiples of B = r_1 G,

    P_{i+1} = P_i + (d_i + 1) B,      d_i uniform in [0, 2^c),

so every point costs one affine addition and its discrete log is known:
a_{i+1} = a_i + (d_i + 1) r_1 mod q. Then

    sum_i s_i P_i == (sum_i s_i a_i mod q) G,

and one scalar multiplication checks an MSM of any size exactly. All points
are multiples of G, so they lie in its prime-order subgroup (as the
complete RCB doubling requires, and with no square root to take on the
Edwards curve). Randomness comes from ``numpy.random.default_rng(seed)``.
The device generator of random points is ``random_points_fast``
(``parallel/api.py``); these points are for checks by discrete log.
"""

from __future__ import annotations

import numpy as np

from ..bigint.weierstrass import AffineCurve
from ..curves.params import EdwardsParams, WeierstrassParams

__all__ = [
    "points_with_logs", "expected_msm", "naive_msm",
    "ed_add", "ed_points_with_logs", "ed_expected_msm", "ed_naive_msm",
]


def ed_add(params: EdwardsParams, P, Q):
    """Twisted-Edwards (a = -1) affine addition, identity (0, 1):
    x3 = (x1 y2 + y1 x2) / (1 + d t), y3 = (y1 y2 + x1 x2) / (1 - d t) with
    t = x1 x2 y1 y2. Unified: it doubles and adds the identity alike."""
    p, d = params.modulus, params.d
    (x1, y1), (x2, y2) = P, Q
    dt = d * x1 * x2 % p * y1 * y2 % p
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dt, -1, p) % p
    y3 = (y1 * y2 + x1 * x2) * pow(1 - dt, -1, p) % p
    return x3, y3


def _scale(add, zero, k: int, P):
    """k * P by double-and-add over ``add``."""
    R = zero
    while k:
        if k & 1:
            R = add(R, P)
        P = add(P, P)
        k >>= 1
    return R


def _walk(add, zero, G, q: int, N: int, seed: int, c: int):
    rng = np.random.default_rng(seed)
    r0, r1 = (int.from_bytes(rng.bytes(48), "little") % q for _ in range(2))
    table = [_scale(add, zero, r1, G)]
    for _ in range(1, 1 << c):
        table.append(add(table[-1], table[0]))
    P, a = _scale(add, zero, r0, G), r0
    points, logs = [], []
    for d in rng.integers(0, 1 << c, size=N).tolist():
        points.append(P)
        logs.append(a)
        P = add(P, table[d])
        a = (a + (d + 1) * r1) % q
    return points, logs


def _weierstrass_add(params):
    return AffineCurve(params).add


def _edwards_add(params):
    return lambda P, Q: ed_add(params, P, Q)


def points_with_logs(params: WeierstrassParams, N: int, seed: int, c: int = 8):
    """Returns (points, logs): N affine (x, y) int tuples and their discrete
    logs base ``params.generator``."""
    return _walk(_weierstrass_add(params), None, params.generator, params.order, N, seed, c)


def expected_msm(params: WeierstrassParams, scalars, logs):
    """The exact MSM result as an affine int point (None = identity)."""
    e = sum(s * a for s, a in zip(scalars, logs)) % params.order
    return _scale(_weierstrass_add(params), None, e, params.generator)


def naive_msm(params: WeierstrassParams, scalars, points):
    """sum_i s_i P_i by one double-and-add per point: an oracle that needs
    no discrete logs, for small N."""
    add = _weierstrass_add(params)
    acc = None
    for s, P in zip(scalars, points):
        acc = add(acc, _scale(add, None, s, P))
    return acc


def ed_points_with_logs(params: EdwardsParams, N: int, seed: int, c: int = 8):
    """``points_with_logs`` on a twisted-Edwards curve: N affine (x, y) int
    tuples in the subgroup of ``params.generator`` and their logs."""
    return _walk(_edwards_add(params), (0, 1), params.generator, params.order, N, seed, c)


def ed_expected_msm(params: EdwardsParams, scalars, logs):
    """The exact Edwards MSM result as an affine int point ((0, 1) = identity)."""
    e = sum(s * a for s, a in zip(scalars, logs)) % params.order
    return _scale(_edwards_add(params), (0, 1), e, params.generator)


def ed_naive_msm(params: EdwardsParams, scalars, points):
    """sum_i s_i P_i on a twisted-Edwards curve, one double-and-add per point."""
    add = _edwards_add(params)
    acc = (0, 1)
    for s, P in zip(scalars, points):
        acc = add(acc, _scale(add, (0, 1), s, P))
    return acc
