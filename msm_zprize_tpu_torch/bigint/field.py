"""Host field arithmetic mod a prime p: inverse, Tonelli-Shanks square root
and uniform sampling.

Mirror of ``msm_zprize_tpu/bigint/field.py`` (``inverse``, ``two_adicity``,
``is_square``, ``sqrt``, ``random_field``): the same algorithms, so the same
root is chosen, and the same draws from a ``random.Random``.
"""

from __future__ import annotations

__all__ = ["inverse", "two_adicity", "is_square", "sqrt", "random_field"]


def inverse(a: int, p: int) -> int:
    """a^-1 mod p; raises ZeroDivisionError on a == 0 (mod p)."""
    a %= p
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in F_p")
    return pow(a, -1, p)


def two_adicity(p: int) -> tuple[int, int]:
    """Write p - 1 = 2^S * t with t odd; return (S, t)."""
    t, S = p - 1, 0
    while t % 2 == 0:
        t //= 2
        S += 1
    return S, t


def is_square(a: int, p: int) -> bool:
    a %= p
    return a == 0 or pow(a, (p - 1) // 2, p) == 1


def _find_nonsquare(p: int) -> int:
    z = 2
    while is_square(z, p):
        z += 1
    return z


def sqrt(a: int, p: int) -> int | None:
    """Tonelli-Shanks square root; None for non-squares."""
    a %= p
    if a == 0:
        return 0
    if p % 4 == 3:
        r = pow(a, (p + 1) // 4, p)
        return r if r * r % p == a else None
    S, t = two_adicity(p)
    c = pow(_find_nonsquare(p), t, p)
    r = pow(a, (t + 1) // 2, p)
    u = pow(a, t, p)  # invariant: r^2 = a u
    M = S
    while u != 1:
        i, v = 0, u  # the least i with u^(2^i) == 1
        while v != 1:
            v = v * v % p
            i += 1
            if i == M:
                return None  # a non-square
        b = pow(c, 1 << (M - i - 1), p)
        r = r * b % p
        c = b * b % p
        u = u * c % p
        M = i
    return r


def random_field(p: int, rng) -> int:
    """Uniform element of [0, p) by rejection, from ``rng.getrandbits``
    (masked to p's bit length, so a draw is rejected less than half the time)."""
    nbits = 8 * ((p.bit_length() + 7) // 8)
    while True:
        x = rng.getrandbits(nbits) & ((1 << p.bit_length()) - 1)
        if x < p:
            return x
