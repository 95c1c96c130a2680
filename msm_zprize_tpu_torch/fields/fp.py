"""Vectorized Montgomery field arithmetic over torch int32 limb tensors.

Mirror of ``msm_zprize_tpu/fields/fp.py::MontgomeryFp`` (the JAX conv
path) for the ops the MSM main path uses. Same layout and invariants:

* tensors ``(n, *batch)`` int32, w-bit limbs on axis 0, Montgomery form
  with R = 2^(n*w) (R = 2^384 for BLS12-377);
* outputs have canonical limbs and values in [0, 2p); ``sub_positive``
  returns [0, 4p), still a valid multiply input because R > 16p.

Every op here is plain PyTorch and runs on the device of its inputs, except
``montmul``/``montsquare``, which dispatch through the K1 wrapper
(``fields/cuda_mul.py``): the CUDA kernel for CUDA tensors, the plain
``montmul_plain`` below for CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import limbs as L
from .limbs import DTYPE, LimbScheme

__all__ = ["MontgomeryFp", "make_field"]


_GROUP = 4  # limbs per int64 carry group (48 bits)


def _normalize(cols: torch.Tensor, w: int, relax_rounds: int = 0):
    """Exact carry propagation over the limb axis.

    cols: (m, *batch) integer columns, possibly signed; after
    ``relax_rounds`` parallel split rounds each column must lie within
    2^26 in magnitude (callers pass the rounds their column bound needs:
    one per 12 bits above that). Returns (digits, carry): int32 digits
    canonical in [0, 2^w), and the signed int64 carry out of the top limb.

    Instead of a w-bit carry chain over all m limbs (the JAX conv path's
    ``_scan_carry``), columns are summed into 4-limb int64 groups and the
    chain runs over m/4 groups: far fewer tensor ops for the same exact
    result."""
    m = cols.shape[0]
    mask = (1 << w) - 1
    c = cols.to(torch.int64)
    pad = -m % _GROUP
    if pad:
        c = torch.cat([c, c.new_zeros((pad,) + c.shape[1:])])
    top = c.new_zeros(c.shape[1:])
    for _ in range(relax_rounds):
        hi = c >> w
        c = c & mask
        c[1:] += hi[:-1]
        top = top + hi[-1]
    shifts = torch.arange(0, _GROUP * w, w, device=c.device).reshape((1, _GROUP) + (1,) * (c.dim() - 1))
    groups = (c.reshape((-1, _GROUP) + c.shape[1:]) << shifts).sum(dim=1)
    gmask = (1 << (_GROUP * w)) - 1
    carry = top.new_zeros(top.shape)
    for j in range(groups.shape[0]):
        t = groups[j] + carry
        groups[j] = t & gmask
        carry = t >> (_GROUP * w)
    digits = ((groups.unsqueeze(1) >> shifts) & mask).reshape(c.shape)[:m]
    carry = carry + top
    if pad:  # the padding limbs hold the low part of the carry out of limb m-1
        carry = (groups[-1] >> (w * (_GROUP - pad))) + (carry << (w * pad))
    return digits.to(DTYPE), carry


def _polymul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact int64 product columns of (n, B) x (n, B) -> (2n-1, B). Few
    lanes: one outer product and one index_add (fewest tensor ops); many
    lanes: n shifted row products (least memory traffic)."""
    n, B = x.shape
    x64, y64 = x.to(torch.int64), y.to(torch.int64)
    cols = torch.zeros((2 * n - 1, B), dtype=torch.int64, device=x.device)
    if B <= 256:
        idx = (torch.arange(n, device=x.device)[:, None] + torch.arange(n, device=x.device)[None]).reshape(-1)
        return cols.index_add_(0, idx, (x64[:, None] * y64[None]).reshape(n * n, B))
    for i in range(n):
        cols[i : i + n] += x64[i] * y64
    return cols


def _toeplitz(const: np.ndarray, rows: int) -> np.ndarray:
    """A with A[k, i] = const[k - i]: A @ x gives the low ``rows`` product
    columns of x (n, B) with a constant."""
    n = len(const)
    A = np.zeros((rows, n), dtype=np.float64)
    for i in range(n):
        A[i : i + n, i] = const[: rows - i]
    return A


class MontgomeryFp:
    """Vectorized field F_p in Montgomery form, radix-2^w int32 limbs."""

    def __init__(self, p: int, w: int = 12, min_extra_bits: int = 4):
        # the JAX package's limb count: R = 2^(n*w) > 2^min_extra_bits * 2p
        n = -(-(p.bit_length() + 1 + min_extra_bits) // w)
        if not 2 * n * (1 << (2 * w)) < (1 << 31):
            raise ValueError("column accumulator overflow")
        self.p = p
        self.w = w
        self.n = n
        self.mask = (1 << w) - 1
        self.R = 1 << (n * w)
        if not self.R > 16 * p:
            raise ValueError("need R > 16p for unreduced-input closure")
        self.scheme = LimbScheme(w, n)
        self.p_limbs = np.array(self.scheme.to_limbs(p), dtype=np.int32)
        self.two_p_limbs = np.array(self.scheme.to_limbs(2 * p), dtype=np.int32)
        pn = (-pow(p, -1, self.R)) % self.R  # -p^-1 mod R (3-product reduction)
        self.pn_limbs = np.array(self.scheme.to_limbs(pn), dtype=np.int32)
        self.mont_one = self.R % p
        self.R2 = self.R * self.R % p
        self._toeplitz_cache: dict = {}

    # ---- constants and shapes ---------------------------------------------

    def const(self, value: int, ref: torch.Tensor) -> torch.Tensor:
        """(n, 1, ..) column of ``value``'s limbs, broadcastable against ref."""
        return self.const_limbs(np.array(self.scheme.to_limbs(value), dtype=np.int32), ref)

    def const_limbs(self, limbs: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(limbs, device=ref.device).reshape((self.n,) + (1,) * (ref.dim() - 1))

    def zeros(self, *batch, device) -> torch.Tensor:
        return torch.zeros((self.n,) + tuple(batch), dtype=DTYPE, device=device)

    def ones_mont(self, *batch, device) -> torch.Tensor:
        one = torch.tensor(self.scheme.to_limbs(self.mont_one), dtype=DTYPE, device=device)
        return one.reshape((self.n,) + (1,) * len(batch)).expand((self.n,) + tuple(batch)).contiguous()

    # ---- I/O ----------------------------------------------------------------

    def pack(self, values, montgomery: bool = True) -> np.ndarray:
        if montgomery:
            values = [v * self.R % self.p for v in values]
        return L.pack(values, self.scheme)

    def unpack(self, arr, montgomery: bool = True, reduce: bool = True) -> list[int]:
        out = L.unpack(arr, self.scheme)
        if montgomery:
            r_inv = pow(self.R, -1, self.p)
            return [v * r_inv % self.p for v in out]
        if reduce:
            return [v % self.p for v in out]
        return out

    # ---- add / sub / reduce -------------------------------------------------
    # Each op normalizes its candidate results in ONE batched carry pass
    # (candidates stacked on axis 1) and selects on the carry out.

    def _first_nonneg(self, a, b):
        """Canonical limbs of b where b's value is >= 0, else of a."""
        d, carry = _normalize(torch.stack([a, b], dim=1), self.w)
        return torch.where(carry[1] < 0, d[:, 0], d[:, 1])

    def _sub_const_select(self, s, const_limbs: np.ndarray):
        """s - const where that is >= 0, else s."""
        return self._first_nonneg(s, s - self.const_limbs(const_limbs, s))

    def add(self, x, y):
        """x + y in [0, 2p) for x, y in [0, 2p)."""
        return self._sub_const_select(x + y, self.two_p_limbs)

    def sub(self, x, y):
        """x - y in [0, 2p) for x, y in [0, 2p): on underflow add 2p."""
        d = x - y
        dd, carry = _normalize(torch.stack([d, d + self.const_limbs(self.two_p_limbs, d)], dim=1), self.w)
        return torch.where(carry[0] < 0, dd[:, 1], dd[:, 0])

    def sub_positive(self, x, y):
        """x - y + 2p, branch-free, in [0, 4p)."""
        return _normalize(x - y + self.const_limbs(self.two_p_limbs, x), self.w)[0]

    def neg(self, x):
        """2p - x in [0, 2p] for x in [0, 2p)."""
        return _normalize(self.const_limbs(self.two_p_limbs, x) - x, self.w)[0]

    def cneg(self, x, flag):
        return torch.where(flag.bool(), self.neg(x), x)

    def canon(self, x):
        """Canonical limbs in [0, 2^w), value unchanged (value in [0, R))."""
        return _normalize(x, self.w)[0]

    def reduce(self, x):
        """[0, 2p) -> [0, p)."""
        return self._sub_const_select(x, self.p_limbs)

    def fully_reduce(self, x):
        """[0, 4p) -> [0, p)."""
        return self._sub_const_select(self._sub_const_select(x, self.two_p_limbs), self.p_limbs)

    # ---- predicates -----------------------------------------------------------

    def is_zero(self, x):
        return torch.all(self.fully_reduce(x) == 0, dim=0)

    def is_equal(self, x, y):
        return torch.all(self.fully_reduce(x) == self.fully_reduce(y), dim=0)

    # ---- Montgomery multiply ------------------------------------------------

    def montmul_plain(self, x, y):
        """Plain PyTorch Montgomery product, the twin of the K1 kernel.

        The JAX conv path's non-interleaved 3-product form: T = x*y,
        q = T*(-p^-1) mod R, out = (T + q*p) / R, with the same unique q, so
        the output is the same integer, bit for bit. Inputs (n, *batch)
        broadcastable, limbs in [-1, 2^w], values < 4p; output canonical
        limbs, value < 2p. Products are exact int64 columns."""
        n, w = self.n, self.w
        batch = torch.broadcast_shapes(x.shape[1:], y.shape[1:])
        xf = x.expand((n,) + batch).reshape(n, -1)
        yf = y.expand((n,) + batch).reshape(n, -1)
        T = _polymul(xf, yf)  # (2n-1, B), |columns| <= n * 2^24 < 2^30
        A_pn, A_p = self._const_products(T.device)
        # q = (T mod R) * (-p^-1) mod R. The constant products are float64
        # matmuls, exact because every partial sum is an integer below 2^53
        # (n * 2^30 * 2^12 < 2^48 here); T's low columns need no carrying
        # first, q's columns two relax rounds.
        q, _ = _normalize((A_pn @ T[:n].to(torch.float64)).to(torch.int64), w, 2)
        S = T + (A_p @ q.to(torch.float64)).to(torch.int64)  # T + q*p, divisible by R
        _, carry_low = _normalize(S[:n], w, 1)
        hi = torch.zeros_like(S[:n])
        hi[: n - 1] = S[n:]
        hi[0] += carry_low
        out, _ = _normalize(hi, w, 1)
        return out.reshape((n,) + tuple(batch))

    def _const_products(self, device):
        """Float64 Toeplitz matrices of -p^-1 mod R (low n columns) and of p
        (2n-1 columns), cached per device."""
        if device not in self._toeplitz_cache:
            self._toeplitz_cache[device] = tuple(
                torch.as_tensor(_toeplitz(c, rows), device=device)
                for c, rows in ((self.pn_limbs, self.n), (self.p_limbs, 2 * self.n - 1))
            )
        return self._toeplitz_cache[device]

    def montmul(self, x, y):
        """Montgomery product x*y*R^-1 mod p, output in [0, 2p): the K1
        kernel on CUDA tensors, ``montmul_plain`` on CPU tensors."""
        from .cuda_mul import montmul

        batch = torch.broadcast_shapes(x.shape[1:], y.shape[1:])
        shape = (self.n,) + tuple(batch)
        xf = x.expand(shape).reshape(self.n, -1).contiguous()
        yf = y.expand(shape).reshape(self.n, -1).contiguous()
        return montmul(self, xf, yf).reshape(shape)

    def montsquare(self, x):
        return self.montmul(x, x)

    def to_montgomery(self, x):
        return self.montmul(x, self.const(self.R2, x))

    def from_montgomery(self, x):
        one = torch.zeros_like(x)
        one[0] = 1
        return self.montmul(x, one)


@lru_cache(maxsize=None)
def make_field(p: int, w: int = 12) -> MontgomeryFp:
    return MontgomeryFp(p, w)
