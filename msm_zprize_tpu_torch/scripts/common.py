"""What the tools share: the curves by name, the device check and timing."""

from __future__ import annotations

import statistics
import time

import torch

from ..curves.params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from ..parallel.api import TwistedEdwards, Weierstrass

__all__ = ["CURVES", "WEIERSTRASS", "make_curve", "device_of", "sync", "wall_ms", "stats"]

CURVES = {"bls12-377": BLS12_377, "bls12-381": BLS12_381, "pallas": PALLAS,
          "ed-on-bls12-377": ED_ON_BLS12_377}
WEIERSTRASS = ("bls12-377", "bls12-381", "pallas")


def make_curve(name: str):
    """The curve module (``Weierstrass`` or ``TwistedEdwards``) of a name."""
    cls = Weierstrass if name in WEIERSTRASS else TwistedEdwards
    return cls.create(CURVES[name])


def device_of(name: str) -> torch.device:
    """The device a tool was asked for; ``cuda`` without a card refuses (no
    tool runs on the CPU unless asked to)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False (pass --device cpu)")
    return device


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, device) -> tuple[float, object]:
    """Host-clock ms of fn() between two synchronisations, and its result."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3, out


def stats(times: list[float]) -> tuple[float, float]:
    """(median, population sigma), as the JAX tools print them."""
    return statistics.median(times), statistics.pstdev(times)
