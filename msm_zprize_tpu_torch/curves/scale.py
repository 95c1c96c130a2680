"""Double-and-add, shared by both curve forms.

Each curve class passes its own ``add(P, Q, mask=None)``, ``double(P)`` and
``zeros()`` (the identity at the operands' batch shape); the loops do not
know which curve calls them. Both go LSB first and leave out the doubling
after the top bit, whose result nothing reads.
"""

from __future__ import annotations

import torch

__all__ = ["scale_bits", "scale_static"]


def scale_static(k: int, P, add, double, zeros):
    """k * P for a static Python int k: an add where a bit is set, a
    doubling between."""
    R = None
    Q = P
    while k > 0:
        if k & 1:
            R = Q if R is None else add(R, Q)
        k >>= 1
        if k:
            Q = double(Q)
    return zeros() if R is None else R


def scale_bits(bits: torch.Tensor, P, add, double, zeros):
    """k * P over k's per-lane bits (n_bits, *batch) int32, with no early
    exit: every bit is one masked add (pass-through lanes where the bit is
    0) and one doubling of Q."""
    bits = bits.expand((-1,) + tuple(P[0].shape[1:])).contiguous()
    acc = zeros()
    Q = P
    for i, bit in enumerate(bits):
        acc = add(acc, Q, mask=bit)
        if i + 1 < len(bits):
            Q = double(Q)
    return acc
