"""Composable random generators: field, fieldx2, fieldx4, biguint, special,
array, record, tuple_, one_of, int_range, and ``invalid`` variants that
sample outside the valid domain (for must-reject checks).

Mirror of ``msm_zprize_tpu/testing/random_gen.py``: a generator is a
callable rng -> value (rng a ``random.Random``), and the same seed gives the
same samples in both packages.
"""

from __future__ import annotations

import random as _random

__all__ = ["Random"]


class Random:
    def __init__(self, sample, invalid=None):
        self._sample = sample
        self._invalid = invalid

    def __call__(self, rng: _random.Random):
        return self._sample(rng)

    @property
    def invalid(self) -> "Random":
        """The generator of out-of-domain values (raises if there is none)."""
        if self._invalid is None:
            raise ValueError("no invalid variant defined for this generator")
        return Random(self._invalid)

    def map(self, f) -> "Random":
        return Random(lambda rng: f(self._sample(rng)))

    @staticmethod
    def constant(v) -> "Random":
        return Random(lambda rng: v)

    @staticmethod
    def field(p: int) -> "Random":
        """Uniform in [0, p); invalid: in [p, 2p)."""
        return Random(lambda rng: rng.randrange(p), invalid=lambda rng: p + rng.randrange(p))

    @staticmethod
    def fieldx2(p: int) -> "Random":
        """Uniform in [0, 2p): the unreduced lazy domain."""
        return Random(lambda rng: rng.randrange(2 * p))

    @staticmethod
    def fieldx4(p: int) -> "Random":
        """Uniform in [0, 4p): sub_positive's output domain."""
        return Random(lambda rng: rng.randrange(4 * p))

    @staticmethod
    def biguint(bits: int) -> "Random":
        return Random(lambda rng: rng.randrange(1 << bits))

    @staticmethod
    def special(p: int) -> "Random":
        """Edge-biased: 0, 1, 2, p - 1, p - 2, p // 2 four times in ten, else
        uniform in [0, p)."""
        edges = [0, 1, 2]

        def sample(rng):
            if rng.random() < 0.4:
                return rng.choice(edges + [p - 1, p - 2, p // 2])
            return rng.randrange(p)

        return Random(sample)

    @staticmethod
    def array(item: "Random", size) -> "Random":
        size_fn = size if callable(size) else (lambda rng: size)
        return Random(lambda rng: [item(rng) for _ in range(size_fn(rng))])

    @staticmethod
    def record(**fields) -> "Random":
        return Random(lambda rng: {k: g(rng) for k, g in fields.items()})

    @staticmethod
    def tuple_(*gens) -> "Random":
        return Random(lambda rng: tuple(g(rng) for g in gens))

    @staticmethod
    def one_of(*gens) -> "Random":
        return Random(lambda rng: rng.choice(gens)(rng))

    @staticmethod
    def int_range(lo: int, hi: int) -> "Random":
        return Random(lambda rng: rng.randrange(lo, hi))
