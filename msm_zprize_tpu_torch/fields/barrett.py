"""Barrett reduction over torch limb tensors.

Mirror of ``msm_zprize_tpu/fields/barrett.py`` (``_shift_right_bits``,
``BarrettReducer``): for a b-bit modulus p, k = b - 1, N = n w (whole limbs,
so the second shift is a limb move) and m = floor(2^(k+N) / p),

    l = ((x >> k) m) >> N      (at most 2 below the exact quotient)
    r = x - l p                 (below 4p)
    while r >= p: r -= p        (three conditional subtractions)

in the same int32 limb arithmetic as the JAX package, so the limbs are
bit-identical. Plain torch ops on the tensors' device: the JAX package has no
kernel for this.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs as L
from .limbs import LimbScheme

__all__ = ["BarrettReducer"]


def _shift_right_bits(x: torch.Tensor, s: int, w: int, n_out: int) -> torch.Tensor:
    """floor(x >> s) of canonical (n, *batch) limbs, s any bit count: the
    low ``n_out`` limbs."""
    n = x.shape[0]
    q, r = divmod(s, w)
    mask = (1 << w) - 1
    zero = torch.zeros_like(x[0])
    out = []
    for i in range(n_out):
        lo = x[i + q] if i + q < n else zero
        if r == 0:
            out.append(lo)
        else:
            hi = x[i + q + 1] if i + q + 1 < n else zero
            out.append(((lo >> r) | (hi << (w - r))) & mask)
    return torch.stack(out, dim=0)


class BarrettReducer:
    """x mod p for x < p 2^(k+1) (any x < p^2 among them), x canonical
    (nx, *batch) limbs with n + 1 <= nx <= 2n."""

    def __init__(self, p: int, w: int = 12):
        self.p = p
        self.w = w
        self.b = p.bit_length()
        self.k = self.b - 1
        self.n = -(-self.b // w)
        self.scheme = LimbScheme(w, self.n)
        self.N = self.n * w
        m = (1 << (self.k + self.N)) // p
        self.n_m = max(-(-m.bit_length() // w), 1)
        self.m_limbs = np.array(LimbScheme(w, self.n_m).to_limbs(m), dtype=np.int32)
        self.p_limbs = np.array(self.scheme.to_limbs(p), dtype=np.int32)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """(n, *batch) canonical limbs of x mod p."""
        w, n = self.w, self.n
        if not n + 1 <= x.shape[0] <= 2 * n:
            raise ValueError(f"Barrett input needs {n + 1}..{2 * n} limbs, got {x.shape[0]}")
        n_hi = -(-(x.shape[0] * w - self.k) // w) + 1
        xhi = _shift_right_bits(x, self.k, w, n_hi)
        l = L.mul_shift_floor(xhi, L.column(self.m_limbs, x), w, n, n + 1)
        r = L.sub_mod_pow2(x, L.mul_low(l, L.column(self.p_limbs, x), w, n + 1), w, n + 1)
        pext = L.column(np.append(self.p_limbs, 0), x)
        for _ in range(3):
            t = L.sub_mod_pow2(r, pext, w, n + 1)
            under = ((t[n] >> (w - 1)) & 1).bool()  # the wrap leaves the top limb's high bit set
            r = torch.where(under, r, t)
        return r[:n]
