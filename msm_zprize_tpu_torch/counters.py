"""Per-process event counts: kernel launches and engine host syncs.

Each kernel wrapper adds one to its kernel's key where it launches the
kernel (and nowhere else); the engine adds one to ``host_sync`` for every
device-to-host read that steers its control flow, and counts its residual
rounds (``compact_residual_rounds``, ``global_residual_rounds``).
``chip_smoke.py`` resets the counts right before it drives the main path
and reads them right after.
"""

from __future__ import annotations

from collections import Counter

__all__ = ["COUNTS", "reset", "snapshot"]

COUNTS: Counter = Counter()


def reset() -> None:
    COUNTS.clear()


def snapshot() -> dict:
    return dict(COUNTS)
