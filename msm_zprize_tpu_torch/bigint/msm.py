"""Host MSM oracle: S = sum_i s_i G_i over Python ints.

Mirror of ``msm_zprize_tpu/bigint/msm.py``: unsigned-window Pippenger over
any curve object with ``zero``, ``add``, ``double`` (the port's
``ProjectiveCurve`` and ``EdwardsCurve``), and a double-and-add cross-check.
On the card, where nothing of JAX is imported, it is the port's third
oracle beside ``testing/points.py``'s double-and-add and known discrete logs.
"""

from __future__ import annotations

__all__ = ["msm", "msm_naive"]


def msm_naive(curve, scalars, points):
    """sum scale(s_i, P_i): O(N bits), a cross-check only."""
    acc = curve.zero
    for s, P in zip(scalars, points):
        acc = curve.add(acc, curve.scale(s, P))
    return acc


def msm(curve, scalars, points, scalar_bits: int, c: int | None = None):
    """Unsigned c-bit windows (default c = max(log2 ceil(N) - 1, 1)), bucket
    sums by running suffix sums, Horner over the windows; ``points`` in the
    curve's own representation (projective or extended tuples)."""
    N = len(scalars)
    assert N == len(points) and N > 0
    if c is None:
        c = max(N.bit_length() - 2, 1)
    K = -(-scalar_bits // c)
    L = 1 << c
    window_sums = []
    for k in range(K):
        buckets = [curve.zero] * L  # bucket 0 unused
        for s, P in zip(scalars, points):
            digit = (s >> (k * c)) & (L - 1)
            if digit:
                buckets[digit] = curve.add(buckets[digit], P)
        running = total = curve.zero  # sum_l l B_l by running suffix sums
        for digit in range(L - 1, 0, -1):
            running = curve.add(running, buckets[digit])
            total = curve.add(total, running)
        window_sums.append(total)
    acc = window_sums[-1]
    for k in range(K - 2, -1, -1):
        for _ in range(c):
            acc = curve.double(acc)
        acc = curve.add(acc, window_sums[k])
    return acc
