"""The 51x5 engine: field elements as 5 limbs of 51 bits in int64 or float64.

Mirror of ``msm_zprize_tpu/fields/fma51.py`` (``Fma51Field``,
``make_fma51_field``, ``montmul_fma_model``), the reference's ``src/51x5/``
research track: each limb is an exact small integer (below 2^52, so int64
and float64 storage convert exactly), and the Montgomery product (R = 2^255)
forms every partial product from 26/25-bit halves of both operands, so each
hardware product and column sum stays exact in int64. Plain torch ops on the
tensors' device (int64 is native, no x64 switch): the JAX package runs this
engine outside any Pallas kernel. The ``Fma51Codec`` rows and their kernels
K13/K14 (``fields/codec.py``) are a separate storage of the main path.

Valid for p < 2^255 - 2^206. Below 2^253 values stay lazy in [0, 2p); a
larger p (the Pasta primes) runs strict: canonical inputs and outputs.
"""

from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np
import torch

__all__ = ["Fma51Field", "make_fma51_field", "montmul_fma_model"]

W = 51
N = 5
MASK51 = (1 << 51) - 1
LO = 26
MASKLO = (1 << LO) - 1


def _to_limbs(x: int) -> list[int]:
    return [(x >> (W * i)) & MASK51 for i in range(N)]


class Fma51Field:
    """Batched Montgomery field at radix 2^51, 5 limbs: every op takes and
    returns (5, *batch) int64 tensors; Montgomery form x R mod p, R = 2^255."""

    def __init__(self, p: int):
        if not p < (1 << 255) - (1 << 206):
            raise ValueError("the 51x5 engine needs p < 2^255 - 2^206")
        # lazy [0, 2p) arithmetic needs 4p < R; a larger p runs strict
        self.lazy = p < 1 << 253
        self.p = p
        self.R = 1 << (W * N)
        self.R2 = self.R * self.R % p
        self.mont_one = self.R % p
        self.p_limbs = np.array(_to_limbs(p), dtype=np.int64)
        self.two_p_limbs = np.array(_to_limbs(2 * p), dtype=np.int64)
        self.mu = (-pow(p, -1, 1 << W)) % (1 << W)  # -p^-1 mod 2^51 (CIOS quotient)
        self.p_lo = np.array([int(v) & MASKLO for v in self.p_limbs], dtype=np.int64)
        self.p_hi = np.array([int(v) >> LO for v in self.p_limbs], dtype=np.int64)

    def _col(self, limbs, ref: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(limbs, dtype=np.int64), device=ref.device).reshape(
            (N,) + (1,) * (ref.dim() - 1))

    # ---- I/O ------------------------------------------------------------------

    def pack(self, values, device, montgomery: bool = True, dtype=torch.int64) -> torch.Tensor:
        """Python ints -> (5, len) limbs on ``device``, the device every op
        on them then runs on."""
        if montgomery:
            values = [v * self.R % self.p for v in values]
        arr = np.zeros((N, len(values)), dtype=np.int64)
        for j, v in enumerate(values):
            arr[:, j] = _to_limbs(v)
        return torch.as_tensor(arr, device=device).to(dtype)

    def unpack(self, arr: torch.Tensor, montgomery: bool = True) -> list[int]:
        a = arr.to(torch.int64).cpu().numpy().reshape(N, -1)
        r_inv = pow(self.R, -1, self.p)
        out = []
        for j in range(a.shape[1]):
            v = sum(int(a[i, j]) << (W * i) for i in range(N))
            out.append(v * r_inv % self.p if montgomery else v % self.p)
        return out

    # float64 storage: exact, limbs < 2^51 < 2^53
    def to_f64(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64)

    def from_f64(self, xf: torch.Tensor) -> torch.Tensor:
        return xf.to(torch.int64)

    # ---- add / sub / reduce ---------------------------------------------------

    def _carry(self, cols: torch.Tensor):
        """Signed carry at radix 2^51 over the limb axis; the carry out of
        the top limb is returned, not kept."""
        out = []
        carry = torch.zeros(cols.shape[1:], dtype=torch.int64, device=cols.device)
        for i in range(N):
            t = cols[i] + carry
            out.append(t & MASK51)
            carry = t >> W
        return torch.stack(out), carry

    def _sub_const_select(self, s, const_limbs):
        t, borrow = self._carry(s - self._col(const_limbs, s))
        return torch.where(borrow < 0, s, t)

    def add(self, x, y):
        """Lazy: [0, 2p) in and out. Strict: canonical in and out (x + y <
        2p < 2^256 through the carry out of the top limb)."""
        if self.lazy:
            s, _ = self._carry(x + y)
            return self._sub_const_select(s, self.two_p_limbs)
        s, c1 = self._carry(x + y)
        d, borrow = self._carry(s - self._col(self.p_limbs, s))
        return torch.where((c1 > 0) | (borrow >= 0), d, s)

    def sub(self, x, y):
        t, borrow = self._carry(x - y)
        u, _ = self._carry(t + self._col(self.two_p_limbs if self.lazy else self.p_limbs, t))
        return torch.where(borrow < 0, u, t)

    def reduce(self, x):
        """[0, 2p) -> [0, p)."""
        return self._sub_const_select(x, self.p_limbs)

    def is_equal(self, x, y):
        return torch.all(self.reduce(x) == self.reduce(y), dim=0)

    # ---- Montgomery product ---------------------------------------------------

    def montmul(self, x, y):
        """x y 2^-255 mod p on (5, *batch) int64 limbs, output in [0, 2p)
        (strict: canonical). Interleaved CIOS at radix 2^51; both operands of
        every product are split into 26/25-bit halves (products <= 52 bits),
        recombined at their column offsets; columns stay below 2^57."""
        batch = torch.broadcast_shapes(x.shape[1:], y.shape[1:])
        x = x.expand((N,) + batch)
        y = y.expand((N,) + batch)
        zero = torch.zeros(batch, dtype=torch.int64, device=x.device)
        y_lo = [y[j] & MASKLO for j in range(N)]
        y_hi = [y[j] >> LO for j in range(N)]
        p_lo = [int(v) for v in self.p_lo]
        p_hi = [int(v) for v in self.p_hi]
        mu_lo, mu_hi = self.mu & MASKLO, self.mu >> LO
        low25 = (1 << 25) - 1

        Z = [zero] * (N + 1)
        for i in range(N):
            xi_lo, xi_hi = x[i] & MASKLO, x[i] >> LO
            for j in range(N):  # Z += x_i y
                ll = xi_lo * y_lo[j]
                lh = xi_lo * y_hi[j] + xi_hi * y_lo[j]  # < 2^53
                hh = xi_hi * y_hi[j]
                Z[j] = Z[j] + ll + ((lh & low25) << LO)
                Z[j + 1] = Z[j + 1] + (lh >> 25) + (hh << 1)
            z0 = Z[0] & MASK51  # quotient digit q_i = Z0 mu mod 2^51
            z0_lo, z0_hi = z0 & MASKLO, z0 >> LO
            qi = (z0_lo * mu_lo + (((z0_lo * mu_hi + z0_hi * mu_lo) & low25) << LO)) & MASK51
            qi_lo, qi_hi = qi & MASKLO, qi >> LO
            for j in range(N):  # Z += q_i p
                ll = qi_lo * p_lo[j]
                lh = qi_lo * p_hi[j] + qi_hi * p_lo[j]
                hh = qi_hi * p_hi[j]
                Z[j] = Z[j] + ll + ((lh & low25) << LO)
                Z[j + 1] = Z[j + 1] + (lh >> 25) + (hh << 1)
            carry = Z[0] >> W  # Z0 is now divisible by 2^51: shift down a limb
            Z = [Z[j + 1] if j < N else zero for j in range(N + 1)]
            Z[0] = Z[0] + carry
        out, c1 = self._carry(torch.stack(Z[:N]))
        if not self.lazy:
            # canonical inputs: t = out + c1 2^255 < 2p; take t - p where
            # c1 = 1 or (out - p) does not borrow
            d, borrow = self._carry(out - self._col(self.p_limbs, out))
            out = torch.where((c1 > 0) | (borrow >= 0), d, out)
        return out

    def montsquare(self, x):
        return self.montmul(x, x)

    def to_montgomery(self, x):
        return self.montmul(x, self._col(_to_limbs(self.R2), x))

    def from_montgomery(self, x):
        one = torch.zeros_like(x)
        one[0] = 1
        return self.montmul(x, one)

    def montmul_f64(self, xf, yf):
        """Float64 storage in and out (the reference's layout): exact casts
        around the int64 core."""
        return self.to_f64(self.montmul(self.from_f64(xf), self.from_f64(yf)))


@lru_cache(maxsize=None)
def make_fma51_field(p: int) -> Fma51Field:
    return Fma51Field(p)


# ---- the float64-FMA algebra, as Python ints ------------------------------------
#
# The reference's headline 51x5 product forms exact 102-bit partial products
# with f64 FMA: hi = fma(x, y, 2^103) keeps the high 51 bits in the mantissa,
# lo = fma(x, y, c2 - hi) the low bits exactly, and reading the raw float
# bits as int64 (less constant exponent prefixes, pre-subtracted per column)
# gives both as integers (`src/51x5/fma.ts`, JS model `fma-js.ts:141-193`).
# This model runs that float algebra bit for bit, fma emulated by integer
# round-to-nearest-even: the oracle for an f64-FMA backend.

_C103 = 1 << 103
_C51X3 = 3 << 51
_C2 = _C103 + _C51X3
_C52 = 1 << 52
_MASK64 = (1 << 64) - 1


def _f64_bits(x: float) -> int:
    return int.from_bytes(struct.pack("<d", x), "little")


def _bits_f64(b: int) -> float:
    return struct.unpack("<d", (b & _MASK64).to_bytes(8, "little"))[0]


_HI_PRE = _f64_bits(float(_C103))
_LO_PRE = _f64_bits(float(_C51X3))
_C52N = _f64_bits(float(_C52))
_C51N = _C52N  # c51 == c52 in the reference (common.ts:40-41)


def _fma_rn(a: int, b: int, c: int) -> int:
    """IEEE-754 fma(a, b, c) of integer-valued float64 operands: a b + c
    rounded to the nearest float64, ties to even (returned as an int)."""
    v = a * b + c
    if v == 0:
        return 0
    sign = -1 if v < 0 else 1
    m = abs(v)
    ulp_bits = m.bit_length() - 53
    if ulp_bits <= 0:
        return v
    ulp = 1 << ulp_bits
    base, rem = divmod(m, ulp)
    if rem > ulp // 2 or (rem == ulp // 2 and base & 1):
        base += 1
    if base.bit_length() <= 53:
        return sign * base * (1 << ulp_bits)
    return sign * (base >> 1) * (1 << (ulp_bits + 1))


def _s64(v: int) -> int:
    """v as a signed int64 (stores wrap mod 2^64)."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def montmul_fma_model(p: int, x: int, y: int) -> int:
    """The reference's f64-FMA Montgomery product (``montmulFma``) bit for
    bit: x y 2^-255 mod p, output in [0, 2p)."""
    if not p < (1 << 255) - (1 << 206):
        raise ValueError("the 51x5 engine needs p < 2^255 - 2^206")
    X, Y, PF = _to_limbs(x), _to_limbs(y), _to_limbs(p)
    mu = (-pow(p, -1, 1 << W)) % (1 << W)  # q = Z0 (-p^-1): Z0 + q p == 0 mod 2^51

    lo_count = [1, 2, 3, 4, 5, 4, 3, 2, 1, 0]
    hi_count = [0, 1, 2, 3, 4, 5, 4, 3, 2, 1]
    zi = [_s64(-(2 * (hi_count[i] * _HI_PRE + lo_count[i] * _LO_PRE))) for i in range(10)]
    Z = zi[:5]

    def f2i(f: int) -> int:
        return _s64(_f64_bits(float(f)))

    for i in range(5):
        xi = X[i]
        hi1 = _fma_rn(xi, Y[0], _C103)
        lo1 = _fma_rn(xi, Y[0], _C2 - hi1)
        Z[0] = _s64(Z[0] + f2i(lo1))
        qi = int(_bits_f64(((Z[0] * mu) & MASK51) + _C51N) - _C52)
        hi2 = _fma_rn(qi, PF[0], _C103)
        lo2 = _fma_rn(qi, PF[0], _C2 - hi2)
        carry = f2i(hi1) + f2i(hi2) + (_s64(Z[0] + f2i(lo2)) >> W)
        for j in range(1, 5):
            hi1 = _fma_rn(xi, Y[j], _C103)
            hi2 = _fma_rn(qi, PF[j], _C103)
            lo1 = _fma_rn(xi, Y[j], _C2 - hi1)
            lo2 = _fma_rn(qi, PF[j], _C2 - hi2)
            Z[j - 1] = _s64(Z[j] + carry + f2i(lo1) + f2i(lo2))
            carry = f2i(hi1) + f2i(hi2)
        Z[4] = _s64(zi[5 + i] + carry)
    if Z[4] < 0:
        raise ArithmeticError(f"negative top limb {Z[4]}")

    carry = 0
    out = 0
    for i in range(5):
        limb = int(_bits_f64(((Z[i] + carry) & MASK51) + _C52N) - _C52)
        out |= limb << (W * i)
        carry = Z[i] >> W
    if carry:
        raise ArithmeticError(f"carry {carry}")
    return out
