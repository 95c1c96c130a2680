"""Timing and deferred logging: ``Log`` (tic / toc / span / lines) and
``tic_toc``.

Mirror of ``msm_zprize_tpu/utils/timing.py``. ``toc(value)`` first waits for
the value: for each CUDA device its tensors lie on, the device's current
stream (the stream that produced it), not the whole device; a value on the
CPU is ready. Entries accumulate as data and the caller prints them.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

__all__ = ["Log", "tic_toc", "wait_for"]


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):  # NamedTuples of points included
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def wait_for(value) -> None:
    """Block until the CUDA work that produces ``value`` (a tensor, or lists,
    tuples and dicts of them) has run: its devices' current streams."""
    for device in {t.device for t in _tensors(value) if t.is_cuda}:
        torch.cuda.current_stream(device).synchronize()


class Log:
    def __init__(self, active: bool = True):
        self.active = active
        self.entries: list[tuple[str, float]] = []
        self._stack: list[tuple[str, float]] = []

    def tic(self, label: str):
        if self.active:
            self._stack.append((label, time.perf_counter()))

    def toc(self, value=None):
        """End the innermost tic, after waiting for ``value`` where given;
        returns the seconds."""
        if not self.active:
            return 0.0
        if value is not None:
            wait_for(value)
        label, t0 = self._stack.pop()
        dt = time.perf_counter() - t0
        self.entries.append((label, dt))
        return dt

    @contextmanager
    def span(self, label: str, result_ref=None):
        self.tic(label)
        try:
            yield
        finally:
            self.toc(result_ref)

    def lines(self) -> list[str]:
        return [f"{label}: {dt * 1e3:.2f} ms" for label, dt in self.entries]

    def print(self):
        for line in self.lines():
            print(line)


@contextmanager
def tic_toc(label: str = ""):
    t0 = time.perf_counter()
    yield
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
