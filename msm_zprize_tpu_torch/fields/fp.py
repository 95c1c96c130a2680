"""Vectorized Montgomery field arithmetic over torch int32 limb tensors.

Mirror of ``msm_zprize_tpu/fields/fp.py::MontgomeryFp`` (the JAX conv
path) for the ops the MSM main paths use. Same layout and invariants:

* tensors ``(n, *batch)`` int32, w-bit limbs on axis 0, Montgomery form
  with R = 2^(n*w) (R = 2^384 for BLS12-377's base field, 2^264 for
  ed-on-bls12-377's);
* outputs have canonical limbs and values in [0, 2p); ``sub_positive``
  returns [0, 4p), still a valid multiply input because R > 16p.

Every op here is plain PyTorch and runs on the device of its inputs, except
``montmul``/``montsquare`` and ``exp_const``, which dispatch through the K1
and K8 wrappers (``fields/cuda_mul.py``): the CUDA kernels for CUDA
tensors, the plain ``montmul_plain`` and ``exp_const_plain`` below for CPU
tensors. ``inverse``, ``batch_inverse``, ``left_shift`` and ``exp_dyn`` (a
runtime exponent: a loop of K1 products, as the JAX package's is a scan of
plain products with no Pallas kernel) are built on those two.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bigint.field import montgomery_params
from . import limbs as L
from .limbs import DTYPE, LimbScheme

__all__ = ["MontgomeryFp", "make_field"]


_GROUP = 4  # limbs per int64 carry group (48 bits)
# CPU lanes up to which montmul_plain and _normalize compute their integers
# with Python ints: there the tensor ops cost more than the arithmetic (a
# product: ~1 ms against ~40 us a lane)
_INT_LANES = 32


def _limbs_value(limbs, w: int) -> int:
    """The integer of one lane's limbs (signed limbs allowed)."""
    v = 0
    for limb in reversed(limbs):
        v = (v << w) + limb
    return v


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
    result. CPU tensors run the same int64 ops in numpy, whose per-op cost
    is a fraction of torch's on the few lanes the CPU paths carry."""
    m = cols.shape[0]
    on_cpu = cols.device.type == "cpu"
    if on_cpu and 0 < cols[0].numel() <= _INT_LANES:
        return _normalize_ints(cols, w)
    mask = (1 << w) - 1
    if on_cpu:
        c = cols.numpy().astype(np.int64)
        zeros = lambda shape: np.zeros(shape, np.int64)
        shifts = np.arange(0, _GROUP * w, w, dtype=np.int64)
    else:
        c = cols.to(torch.int64)
        zeros = c.new_zeros
        shifts = torch.arange(0, _GROUP * w, w, device=c.device)
    pad = -m % _GROUP
    if pad:
        c = (np.concatenate if on_cpu else torch.cat)([c, zeros((pad,) + tuple(c.shape[1:]))])
    top = zeros(c.shape[1:])
    for _ in range(relax_rounds):
        hi = c >> w
        c = c & mask
        c[1:] += hi[:-1]
        top = top + hi[-1]
    shifts = shifts.reshape((1, _GROUP) + (1,) * (c.ndim - 1))
    groups = (c.reshape((-1, _GROUP) + c.shape[1:]) << shifts).sum(axis=1)
    gmask = (1 << (_GROUP * w)) - 1
    carry = zeros(top.shape)
    for j in range(groups.shape[0]):
        t = groups[j] + carry
        groups[j] = t & gmask
        carry = t >> (_GROUP * w)
    digits = ((groups[:, None] >> shifts) & mask).reshape(c.shape)[:m]
    carry = carry + top
    if pad:  # the padding limbs hold the low part of the carry out of limb m-1
        carry = (groups[-1] >> (w * (_GROUP - pad))) + (carry << (w * pad))
    if on_cpu:
        return torch.from_numpy(digits.astype(np.int32)), torch.from_numpy(carry)
    return digits.to(DTYPE), carry


def _normalize_ints(cols: torch.Tensor, w: int):
    """``_normalize`` on few CPU lanes, lane by lane with Python ints: the
    digits of the columns' value mod 2^(w m) and its floor over 2^(w m),
    the same integers as the carry chain's."""
    m, mask = cols.shape[0], (1 << w) - 1
    digits, carries = [], []
    for col in cols.reshape(m, -1).T.tolist():
        v = _limbs_value(col, w)
        carries.append(v >> (w * m))
        digits.append([(v >> (w * i)) & mask for i in range(m)])
    return (torch.tensor(digits, dtype=DTYPE).T.reshape(cols.shape),
            torch.tensor(carries, dtype=torch.int64).reshape(cols.shape[1:]))


def _polymul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact int64 product columns of (n, B) x (n, B) -> (2n-1, B). CPU: n
    shifted row products in numpy (a fraction of torch's per-op cost); few
    CUDA lanes: one outer product and one index_add (fewest tensor ops);
    many: n shifted row products (least memory traffic)."""
    n, B = x.shape
    if x.device.type == "cpu":
        xn, yn = x.numpy().astype(np.int64), y.numpy().astype(np.int64)
        out = np.zeros((2 * n - 1, B), np.int64)
        for i in range(n):
            out[i : i + n] += xn[i] * yn
        return torch.from_numpy(out)
    x64, y64 = x.to(torch.int64), y.to(torch.int64)
    cols = torch.zeros((2 * n - 1, B), dtype=torch.int64, device=x.device)
    if B <= 256:
        idx = (torch.arange(n, device=x.device)[:, None] + torch.arange(n, device=x.device)[None]).reshape(-1)
        return cols.index_add_(0, idx, (x64[:, None] * y64[None]).reshape(n * n, B))
    for i in range(n):
        cols[i : i + n] += x64[i] * y64
    return cols


def _batch_shape(x: torch.Tensor, y: torch.Tensor):
    """The broadcast batch shape of two limb tensors (``torch.broadcast_shapes``
    costs tens of microseconds a call; equal shapes, the common case, skip it)."""
    if x.shape == y.shape:
        return x.shape[1:]
    return torch.broadcast_shapes(x.shape[1:], y.shape[1:])


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
        mp = montgomery_params(p, w, min_extra_bits)
        n = mp.n
        if not 2 * n * (1 << (2 * w)) < (1 << 31):
            raise ValueError("column accumulator overflow")
        self.p = p
        self.w = w
        self.n = n
        self.mask = mp.mask
        self.R = mp.R
        if not self.R > 16 * p:
            raise ValueError("need R > 16p for unreduced-input closure")
        self.scheme = LimbScheme(w, n)
        self.p_limbs = np.array(self.scheme.to_limbs(p), dtype=np.int32)
        self.two_p_limbs = np.array(self.scheme.to_limbs(2 * p), dtype=np.int32)
        pn = self.pn = (-pow(p, -1, self.R)) % self.R  # -p^-1 mod R (3-product reduction)
        self.pn_limbs = np.array(self.scheme.to_limbs(pn), dtype=np.int32)
        self.mont_one = mp.R_mod_p
        self.R2 = mp.R2
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
        limbs, value < 2p. Products are exact int64 columns; on up to
        ``_INT_LANES`` CPU lanes the same integer comes from Python ints
        (``_montmul_ints``)."""
        n, w = self.n, self.w
        batch = _batch_shape(x, y)
        xf = x.expand((n,) + batch).reshape(n, -1)
        yf = y.expand((n,) + batch).reshape(n, -1)
        if xf.device.type == "cpu" and 0 < xf.shape[1] <= _INT_LANES:
            return self._montmul_ints(xf, yf).reshape((n,) + tuple(batch))
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

    def _montmul_ints(self, xf, yf):
        """montmul_plain's integer lane by lane: T = x y, q = T (-p^-1) mod R,
        (T + q p) / R (exact) mod R, the top carry dropped as the limb
        code's normalize drops it; canonical limbs (n, B)."""
        n, w, R = self.n, self.w, self.R
        out = []
        for xl, yl in zip(xf.T.tolist(), yf.T.tolist()):
            t = _limbs_value(xl, w) * _limbs_value(yl, w)
            v = (t + t * self.pn % R * self.p) // R % R
            out.append([(v >> (w * i)) & self.mask for i in range(n)])
        return torch.tensor(out, dtype=DTYPE).T.contiguous()

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

        batch = _batch_shape(x, y)
        shape = (self.n,) + tuple(batch)
        xf = x.expand(shape).reshape(self.n, -1).contiguous()
        yf = y.expand(shape).reshape(self.n, -1).contiguous()
        return montmul(self, xf, yf).reshape(shape)

    def montsquare(self, x):
        return self.montmul(x, x)

    def left_shift(self, x, k: int):
        """x * 2^k, Montgomery form kept: one K1 product by 2^k R mod p."""
        return self.montmul(x, self.const((1 << k) * self.R % self.p, x))

    def to_montgomery(self, x):
        return self.montmul(x, self.const(self.R2, x))

    def from_montgomery(self, x):
        one = torch.zeros_like(x)
        one[0] = 1
        return self.montmul(x, one)

    # ---- exponentiation / inverse -------------------------------------------

    def exp_const(self, x, e: int):
        """x^e for a static exponent, Montgomery form: the K8 kernel on CUDA
        tensors, ``exp_const_plain`` on CPU tensors."""
        from .cuda_mul import exp_const

        shape = x.shape
        return exp_const(self, x.reshape(self.n, -1).contiguous(), e).reshape(shape)

    def exp_const_plain(self, x, e: int):
        """Plain PyTorch x^e, the twin of K8: the JAX package's fixed-window
        square-and-multiply (a 16-entry table, MSB-first 4-bit windows, the
        first window taken from the table without squarings), on
        ``montmul_plain``. Bit-identical to JAX ``exp_const`` off the TPU."""
        window = 4
        one = self.ones_mont(*x.shape[1:], device=x.device)
        if e == 0:
            return one
        n_win = -(-e.bit_length() // window)
        digits = [(e >> (window * i)) & ((1 << window) - 1) for i in range(n_win)][::-1]
        tbl = [one, x]
        for _ in range((1 << window) - 2):
            tbl.append(self.montmul_plain(tbl[-1], x))
        acc = tbl[digits[0]]
        for d in digits[1:]:
            for _ in range(window):
                acc = self.montmul_plain(acc, acc)
            acc = self.montmul_plain(acc, tbl[d])
        return acc

    def exp_dyn(self, x, e: torch.Tensor):
        """x^e for a RUNTIME exponent e: (n_e, *batch) canonical limbs.

        The JAX package's masked square-and-multiply, MSB-first over all
        n_e * w bits with no early exit: each bit is a K1 square, a K1
        product and a select (2 n_e w K1 launches on the card)."""
        acc = self.ones_mont(*torch.broadcast_shapes(x.shape[1:], e.shape[1:]), device=x.device)
        for bit in L.bit_planes(e, self.w).flip(0).bool():  # MSB first
            acc = self.montsquare(acc)
            acc = torch.where(bit, self.montmul(acc, x), acc)
        return acc

    def inverse(self, x):
        """x^-1 via Fermat (x^(p-2)); inverse(0) returns 0 (callers mask)."""
        return self.exp_const(x, self.p - 2)

    def batch_inverse(self, x, rows: int = 8):
        """Batch inversion over the last batch axis, the JAX package's blocked
        design: prefix products down ``rows`` rows, a tree over the column
        totals, ONE Fermat inverse of the grand total (K8 on the card), then
        the unwind of both. All inputs must be nonzero mod p."""
        n = self.n
        if x.dim() != 2:
            return self.batch_inverse(x.reshape(n, -1), rows).reshape(x.shape)
        B = x.shape[1]
        if B <= 4:
            return self.inverse(x)
        rows = max(min(rows, B), 1)
        while B % rows:
            rows -= 1
        cols = B // rows
        xr = x.reshape(n, rows, cols)
        one = self.ones_mont(cols, device=x.device)

        prefixes = []  # prefix products down the rows
        acc = one
        for r in range(rows):
            acc = self.montmul(acc, xr[:, r])
            prefixes.append(acc)

        levels = []  # tree over the column totals, kept for the unwind
        cur = prefixes[-1]
        while cur.shape[-1] > 1:
            width = cur.shape[-1]
            half = width // 2
            merged = self.montmul(cur[:, :half], cur[:, half : 2 * half])
            if width % 2:
                merged = torch.cat([merged, cur[:, -1:]], dim=1)
            levels.append((cur, half, bool(width % 2)))
            cur = merged

        inv = self.inverse(cur)  # (n, 1)
        for level, half, odd in reversed(levels):
            inv_left = self.montmul(inv[:, :half], level[:, half : 2 * half])
            inv_right = self.montmul(inv[:, :half], level[:, :half])
            parts = [inv_left, inv_right] + ([inv[:, half : half + 1]] if odd else [])
            inv = torch.cat(parts, dim=1)

        # unwind the rows: inv(x_r) = inv(P_r) P_{r-1}; inv(P_{r-1}) = inv(P_r) x_r
        out = [None] * rows
        for r in range(rows - 1, -1, -1):
            out[r] = self.montmul(inv, prefixes[r - 1] if r else one)
            inv = self.montmul(inv, xr[:, r])
        return torch.stack(out, dim=1).reshape(n, B)


@lru_cache(maxsize=None)
def make_field(p: int, w: int = 12) -> MontgomeryFp:
    return MontgomeryFp(p, w)
