"""Host-side MSM inputs with known discrete logs (tests and the smoke run).

``points_with_logs`` walks the group: P_0 = r_0 G, and each next point adds
one entry of a table of multiples of B = r_1 G,

    P_{i+1} = P_i + (d_i + 1) B,      d_i uniform in [0, 2^c),

so every point costs one affine addition and its discrete log is known:
a_{i+1} = a_i + (d_i + 1) r_1 mod q. Then

    sum_i s_i P_i == (sum_i s_i a_i mod q) G,

and one scalar multiplication checks an MSM of any size exactly. All points
lie in the odd-order subgroup generated by G, as the complete RCB doubling
requires. Randomness comes from ``numpy.random.default_rng(seed)``. Not
public API: the device generator is a later slice.
"""

from __future__ import annotations

import numpy as np

from ..curves.params import WeierstrassParams

__all__ = ["points_with_logs", "expected_msm", "naive_msm"]


def _affine_add(P, Q, p: int):
    """Affine addition (None = identity) with the built-in modular inverse."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        m = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
    else:
        m = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (m * m - x1 - x2) % p
    return x3, (m * (x1 - x3) - y1) % p


def _scale(k: int, P, p: int):
    """k * P by double-and-add over ``_affine_add``."""
    R = None
    while k:
        if k & 1:
            R = _affine_add(R, P, p)
        P = _affine_add(P, P, p)
        k >>= 1
    return R


def points_with_logs(params: WeierstrassParams, N: int, seed: int, c: int = 8):
    """Returns (points, logs): N affine (x, y) int tuples and their discrete
    logs base ``params.generator``."""
    rng = np.random.default_rng(seed)
    q, p, G = params.order, params.modulus, params.generator
    r0, r1 = (int.from_bytes(rng.bytes(48), "little") % q for _ in range(2))
    table = [_scale(r1, G, p)]
    for _ in range(1, 1 << c):
        table.append(_affine_add(table[-1], table[0], p))
    P, a = _scale(r0, G, p), r0
    points, logs = [], []
    for d in rng.integers(0, 1 << c, size=N).tolist():
        points.append(P)
        logs.append(a)
        P = _affine_add(P, table[d], p)
        a = (a + (d + 1) * r1) % q
    return points, logs


def expected_msm(params: WeierstrassParams, scalars, logs):
    """The exact MSM result as an affine int point (None = identity)."""
    e = sum(s * a for s, a in zip(scalars, logs)) % params.order
    return _scale(e, params.generator, params.modulus)


def naive_msm(params: WeierstrassParams, scalars, points):
    """sum_i s_i P_i by one double-and-add per point: an oracle that needs
    no discrete logs, for small N."""
    acc = None
    for s, P in zip(scalars, points):
        acc = _affine_add(acc, _scale(s, P, params.modulus), params.modulus)
    return acc
