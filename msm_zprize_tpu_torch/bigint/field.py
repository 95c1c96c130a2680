"""Host field arithmetic mod a prime p: the port's bigint oracle layer.

Mirror of ``msm_zprize_tpu/bigint/field.py`` with its names and signatures:
``mod``, ``field_exp``, ``egcd``, ``inverse`` (raising on 0, the
must-throw side of the equivalence harness), ``two_adicity``,
``is_square``, Tonelli-Shanks ``sqrt``, ``roots_of_unity``,
``montgomery_params`` (the limb layout that ``fields/fp.py::MontgomeryFp``
takes its n and R from), ``to_limbs`` / ``from_limbs``, ``random_field`` /
``random_fields`` and the ``Field`` wrapper. The same algorithms, so the
same root is chosen, and the same draws from a ``random.Random``. Two
helpers have no JAX counterpart: ``is_probable_prime`` (Miller-Rabin) and
``next_prime``, which find the synthetic moduli at the ends of the limb
code's domain (n = 1 and n = 63) that the card's field checks run on.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from functools import cached_property

__all__ = [
    "mod", "field_exp", "egcd", "inverse", "sqrt", "is_square", "two_adicity",
    "roots_of_unity", "montgomery_params", "MontgomeryParams", "to_limbs", "from_limbs",
    "Field", "random_field", "random_fields", "is_probable_prime", "next_prime",
]


def mod(x: int, p: int) -> int:
    return x % p


def field_exp(a: int, n: int, p: int) -> int:
    """a^n mod p (n >= 0)."""
    return pow(a % p, n, p)


def egcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended gcd: (g, s, t) with s a + t b = g = gcd(a, b)."""
    old_r, r, old_s, s, old_t, t = a, b, 1, 0, 0, 1
    while r != 0:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def inverse(a: int, p: int) -> int:
    """a^-1 mod p; raises ZeroDivisionError on a == 0 (mod p)."""
    a %= p
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in F_p")
    g, s, _ = egcd(a, p)
    if g != 1:
        raise ZeroDivisionError("not invertible")
    return s % p


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


def roots_of_unity(p: int) -> list[int]:
    """[w, w^2, w^4, ...]: S elements, w a generator of the 2-Sylow subgroup
    (of order 2^S, p - 1 = 2^S t)."""
    S, t = two_adicity(p)
    w = pow(_find_nonsquare(p), t, p)
    out = [w]
    for _ in range(S - 1):
        w = w * w % p
        out.append(w)
    return out


@dataclass(frozen=True)
class MontgomeryParams:
    """Limb layout for a modulus p at w bits a limb."""

    p: int
    w: int  # bits per limb
    n: int  # number of limbs
    K: int  # total bits n w
    R: int  # Montgomery radix 2^K
    R2: int  # R^2 mod p
    R_mod_p: int
    p_inv_neg: int  # -p^-1 mod 2^w
    mask: int  # 2^w - 1

    @property
    def limbs_p(self) -> list[int]:
        return to_limbs(self.p, self.w, self.n)

    @property
    def limbs_2p(self) -> list[int]:
        return to_limbs(2 * self.p, self.w, self.n)


def montgomery_params(p: int, w: int, min_extra_bits: int = 2) -> MontgomeryParams:
    """The limb count n with R = 2^(n w) > 2^min_extra_bits 2p (the fewest
    w-bit limbs that hold bits(p) + 1 + min_extra_bits bits).
    ``MontgomeryFp`` takes min_extra_bits = 4, so R > 32p."""
    n = -(-(p.bit_length() + 1 + min_extra_bits) // w)
    K = n * w
    R = 1 << K
    assert R > (2 * p) << min_extra_bits
    return MontgomeryParams(p=p, w=w, n=n, K=K, R=R, R2=R * R % p, R_mod_p=R % p,
                            p_inv_neg=(-pow(p, -1, 1 << w)) % (1 << w), mask=(1 << w) - 1)


def to_limbs(x: int, w: int, n: int) -> list[int]:
    mask = (1 << w) - 1
    return [(x >> (w * i)) & mask for i in range(n)]


def from_limbs(limbs, w: int) -> int:
    return sum(int(v) << (w * i) for i, v in enumerate(limbs))


def random_field(p: int, rng=None) -> int:
    """Uniform element of [0, p) by rejection, from ``rng.getrandbits``
    (masked to p's bit length, so a draw is rejected less than half the
    time), or from ``secrets`` when rng is None."""
    nbytes = (p.bit_length() + 7) // 8
    while True:
        if rng is not None:
            x = rng.getrandbits(8 * nbytes)
        else:
            x = int.from_bytes(secrets.token_bytes(nbytes), "little")
        x &= (1 << p.bit_length()) - 1
        if x < p:
            return x


def random_fields(p: int, count: int, rng=None) -> list[int]:
    return [random_field(p, rng) for _ in range(count)]


def is_probable_prime(n: int, rounds: int = 32) -> bool:
    """Miller-Rabin with the first ``rounds`` primes as bases (no counterpart
    in the JAX package)."""
    if n < 2:
        return False
    bases = [b for b in range(2, 200) if all(b % d for d in range(2, int(b ** 0.5) + 1))][:rounds]
    for b in bases:
        if n % b == 0:
            return n == b
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for b in bases:
        x = pow(b, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def next_prime(start: int) -> int:
    """The least probable prime >= start (no counterpart in the JAX package)."""
    n = max(start, 2)
    while not is_probable_prime(n):
        n += 1
    return n


class Field:
    """The modulus with its operations (host side only)."""

    def __init__(self, p: int):
        self.p = p

    def mod(self, x):
        return x % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def square(self, a):
        return a * a % self.p

    def neg(self, a):
        return (-a) % self.p

    def inv(self, a):
        return inverse(a, self.p)

    def exp(self, a, n):
        return pow(a % self.p, n, self.p)

    def sqrt(self, a):
        return sqrt(a, self.p)

    def is_square(self, a):
        return is_square(a, self.p)

    def random(self, rng=None):
        return random_field(self.p, rng)

    @cached_property
    def bit_length(self):
        return self.p.bit_length()
