"""Host GLV decomposition: the short lattice basis and the split of a scalar.

Mirror of ``msm_zprize_tpu/bigint/glv.py``: with lambda a cube root of
unity in F_q acting as (x, y) -> (beta x, y), a scalar s splits as

    s == (-1)^sign0 s0 + lambda (-1)^sign1 s1   (mod q)

with s0, s1 of about half q's bits. The basis comes from the extended
Euclid rows on (q, lambda): the consecutive pair with determinant +-q and
the smallest largest entry (a fixed stopping point leaves some lambdas,
BLS12-381's z^2 - 1 ~ sqrt(q) among them, unbalanced); the split is the
rounded Babai step in exact integers. ``fields/scalar.py::glv_basis``, the
basis of the GLV scalar modules and K2, reads it from here.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["GlvParams", "glv_params", "decompose", "egcd_stop_early"]


def egcd_stop_early(lambda_: int, q: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Two short rows (v00, v01), (v10, v11), each with v_i0 + v_i1 lambda
    == 0 (mod q), |v_ij| ~ sqrt(q), of determinant +-q."""
    rows = [(q, 0)]  # r_i = s_i q + t_i lambda gives the row (r_i, -t_i)
    old_r, r, old_t, t = q, lambda_ % q, 0, 1
    rows.append((r, -t))
    while r != 0:
        quo = old_r // r
        old_r, r = r, old_r - quo * r
        old_t, t = t, old_t - quo * t
        rows.append((r, -t))
    pairs = [(a, b) for a, b in zip(rows, rows[1:]) if abs(a[0] * b[1] - a[1] * b[0]) == q]
    assert pairs, "no consecutive row pair with determinant +-q"
    return min(pairs, key=lambda ab: max(map(abs, ab[0] + ab[1])))


def _round_div(a: int, b: int) -> int:
    """a / b rounded to the nearest integer (ties toward +inf), exactly."""
    if b < 0:
        a, b = -a, -b
    return (2 * a + b) // (2 * b)


@dataclass(frozen=True)
class GlvParams:
    q: int
    lambda_: int
    v00: int
    v01: int
    v10: int
    v11: int
    det: int
    max_bits: int  # a bound on the bit length of the split's halves


def glv_params(q: int, lambda_: int) -> GlvParams:
    (v00, v01), (v10, v11) = egcd_stop_early(lambda_, q)
    bound = max(abs(v00) + abs(v10), abs(v01) + abs(v11)) + 1
    return GlvParams(q=q, lambda_=lambda_, v00=v00, v01=v01, v10=v10, v11=v11,
                     det=v00 * v11 - v01 * v10, max_bits=bound.bit_length())


def decompose(s: int, g: GlvParams) -> tuple[int, int, int, int]:
    """(sign0, |s0|, sign1, |s1|), signs 0 or 1."""
    s %= g.q
    # Babai rounding: (x0, x1) = round((s, 0) V^-1), V^-1 = [[v11, -v01], [-v10, v00]] / det
    x0 = _round_div(s * g.v11, g.det)
    x1 = _round_div(-s * g.v01, g.det)
    s0 = s - (x0 * g.v00 + x1 * g.v10)
    s1 = -(x0 * g.v01 + x1 * g.v11)
    assert (s0 + g.lambda_ * s1 - s) % g.q == 0
    assert max(abs(s0), abs(s1)).bit_length() <= g.max_bits
    return int(s0 < 0), abs(s0), int(s1 < 0), abs(s1)
