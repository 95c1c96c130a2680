"""Time-budgeted randomized property checks.

Mirror of ``msm_zprize_tpu/testing/property.py``: a property runs at least
``min_runs`` times, then as many more as fit in the time budget, up to
``max_runs``; a failing input is named in the raised assertion.
``negative=True`` (``test.negative``) requires the property to FAIL on
every sample.
"""

from __future__ import annotations

import random
import time

__all__ = ["test_property"]

MIN_RUNS = 15
MAX_RUNS = 400
BUDGET_S = 0.1


def test_property(*gens, seed: int = 0, min_runs: int = MIN_RUNS, max_runs: int = MAX_RUNS,
                  budget_s: float = BUDGET_S, negative: bool = False):
    """Decorator: run ``fn(*samples)`` on samples drawn from ``gens`` (callables
    rng -> value, ``testing.random_gen.Random``), and return fn."""

    def deco(fn):
        rng = random.Random(seed)
        start = time.perf_counter()
        runs = 0
        while runs < min_runs or (runs < max_runs and time.perf_counter() - start < budget_s):
            sample = [g(rng) for g in gens]
            if negative:
                try:
                    fn(*sample)
                except (AssertionError, ValueError, ZeroDivisionError):
                    pass
                else:
                    raise AssertionError(
                        f"negative property held (expected failure); inputs: {sample!r}")
            else:
                try:
                    fn(*sample)
                except AssertionError as e:
                    raise AssertionError(f"property failed; inputs: {sample!r}") from e
            runs += 1
        return fn

    return deco
