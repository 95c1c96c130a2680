"""Scalar modules: GLV decomposition and signed-digit windowing, in torch.

Mirror of ``msm_zprize_tpu/fields/scalar.py`` (``SimpleScalar``,
``GlvScalar.decompose``, ``signed_digits``, ``make_glv_scalar``): the same
12-bit limb algorithm in int32, so results are bit-identical to the JAX
package. ``decompose`` + ``signed_digits`` together are the plain twin of
the K2 kernel (``fields/cuda_scalar.py``). Scalars are plain (non-Montgomery)
limb tensors of shape ``(n, *batch)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import limbs as L
from .limbs import DTYPE, LimbScheme

__all__ = ["SimpleScalar", "GlvScalar", "glv_basis", "signed_digits", "make_glv_scalar"]


def glv_basis(q: int, lambda_: int):
    """Short lattice basis of {(a, b): a + b lambda == 0 mod q}, as the JAX
    package's ``bigint/glv.py::glv_params`` finds it: the consecutive pair of
    extended-Euclid rows on (q, lambda) with determinant +-q and the smallest
    largest entry. Returns ((v00, v01), (v10, v11), det, max_bits), max_bits
    bounding the bit length of a Babai-rounded half."""
    rows = [(q, 0)]
    old_r, r, old_t, t = q, lambda_ % q, 0, 1
    rows.append((r, -t))
    while r:
        quo = old_r // r
        old_r, r = r, old_r - quo * r
        old_t, t = t, old_t - quo * t
        rows.append((r, -t))
    pairs = [(a, b) for a, b in zip(rows, rows[1:]) if abs(a[0] * b[1] - a[1] * b[0]) == q]
    v0, v1 = min(pairs, key=lambda ab: max(map(abs, ab[0] + ab[1])))
    det = v0[0] * v1[1] - v0[1] * v1[0]
    bound = max(abs(v0[0]) + abs(v1[0]), abs(v0[1]) + abs(v1[1])) + 1
    return v0, v1, det, bound.bit_length()


class SimpleScalar:
    """Plain scalar codec (non-GLV)."""

    def __init__(self, q: int, w: int = 12):
        self.q = q
        self.w = w
        self.bits = q.bit_length()
        self.n = -(-self.bits // w)
        self.scheme = LimbScheme(w, self.n)

    def pack(self, values) -> np.ndarray:
        return L.pack([v % self.q for v in values], self.scheme)

    def unpack(self, arr) -> list[int]:
        return L.unpack(arr, self.scheme)


class GlvScalar(SimpleScalar):
    """GLV (Babai) decomposition s = (-1)^g0 u0 + lambda (-1)^g1 u1 (mod q).

    Constants, exact integer math at construction (as the JAX class):
    m_i = round(2^K0 * c_i) for the Babai coordinates c0 = v11/det,
    c1 = -v01/det, K0 = (n+1) limbs; basis rows v_ij with static signs.
    """

    def __init__(self, q: int, lambda_: int, w: int = 12):
        super().__init__(q, w)
        (v00, v01), (v10, v11), det, basis_bits = glv_basis(q, lambda_)
        self.lambda_ = lambda_
        self.max_bits = basis_bits + 2  # basis bound + 2 bits rounding slack
        self.n_half = -(-self.max_bits // w)
        self.n_acc = self.n_half + 2  # sign + |s_i| with one spare limb
        self.K0_limbs = self.n + 1
        K0 = self.K0_limbs * w

        def rounded(c_num: int) -> tuple[int, int]:
            m = ((c_num << K0) * 2 + det) // (2 * det)  # round to nearest
            return (1 if m >= 0 else -1), abs(m)

        self.sign_m0, m0 = rounded(v11)
        self.sign_m1, m1 = rounded(-v01)
        n_m = max(-(-m0.bit_length() // w), -(-m1.bit_length() // w), 1)
        self.m0 = np.array(LimbScheme(w, n_m).to_limbs(m0), dtype=np.int32)
        self.m1 = np.array(LimbScheme(w, n_m).to_limbs(m1), dtype=np.int32)
        self.sv = {}
        for name, v in (("v00", v00), ("v01", v01), ("v10", v10), ("v11", v11)):
            nv = max(-(-abs(v).bit_length() // w), 1)
            self.sv[name] = (
                1 if v >= 0 else -1,
                np.array(LimbScheme(w, nv).to_limbs(abs(v)), dtype=np.int32),
            )

    def terms(self):
        """The four (u index, static sign, basis row) products of the
        decomposition: s0 = s - a - b, s1 = -(c + d), each sign folding
        sign(m_i) * sign(v)."""
        return (
            (0, self.sign_m0 * self.sv["v00"][0], "v00"),
            (1, self.sign_m1 * self.sv["v10"][0], "v10"),
            (0, self.sign_m0 * self.sv["v01"][0], "v01"),
            (1, self.sign_m1 * self.sv["v11"][0], "v11"),
        )

    def decompose(self, s: torch.Tensor):
        """s: (n, B) canonical limbs of scalars in [0, q). Returns
        (sign0, u0, sign1, u1): signs (B,) int32 in {0, 1}, u_i (n_half, B)
        canonical limbs, s == (-1)^sign0 u0 + lambda (-1)^sign1 u1 (mod q)."""
        w, n_acc = self.w, self.n_acc
        nb = s.dim() - 1

        def col(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, device=s.device).reshape((-1,) + (1,) * nb)

        u = [
            L.mul_shift_floor(s, col(m), w, self.K0_limbs, self.n_half + 1)
            for m in (self.m0, self.m1)
        ]
        prods = [
            (sg, L.mul_low(u[ui], col(self.sv[name][1]), w, n_acc))
            for ui, sg, name in self.terms()
        ]
        s_acc = L.carry_chain(s, w, n_acc)

        def combine(base, sg, t):  # base - sg * t  (mod 2^(w*n_acc))
            if sg > 0:
                return L.sub_mod_pow2(base, t, w, n_acc)
            return L.add_mod_pow2(base, t, w, n_acc)

        s0 = combine(combine(s_acc, *prods[0]), *prods[1])
        s1 = combine(combine(torch.zeros_like(s_acc), *prods[2]), *prods[3])

        def sign_abs(x):
            top = (x[n_acc - 1] >> (w - 1)) & 1  # two's-complement sign
            absx = torch.where(top.bool(), L.negate_mod_pow2(x, w, n_acc), x)
            return top.to(DTYPE), absx[: self.n_half]

        sign0, a0 = sign_abs(s0)
        sign1, a1 = sign_abs(s1)
        return sign0, a0, sign1, a1

    def unpack_half(self, arr) -> list[int]:
        return L.unpack(arr, LimbScheme(self.w, self.n_half))


def signed_digits(u: torch.Tensor, c: int, n_windows: int, w: int, scalar_sign=None):
    """Signed c-bit digits of canonical limb scalars u (n, B).

    Returns (mags, signs), each (n_windows, B) int32: magnitudes in
    [0, 2^(c-1)], signs in {0, 1}, with u == sum_k (-1)^signs[k] mags[k]
    2^(k*c). ``scalar_sign`` (B,) is XORed into every digit sign; zero
    digits keep sign 0."""
    mags, signs = [], []
    carry = torch.zeros(u.shape[1:], dtype=DTYPE, device=u.device)
    half, full = 1 << (c - 1), 1 << c
    for k in range(n_windows):
        l = L.extract_bits(u, k * c, c, w) + carry
        big = l > half
        carry = big.to(DTYPE)
        mag = torch.where(big, full - l, l)
        sgn = big.to(DTYPE)
        if scalar_sign is not None:
            sgn = sgn ^ scalar_sign
        mags.append(mag)
        signs.append(torch.where(mag == 0, 0, sgn))
    return torch.stack(mags, dim=0), torch.stack(signs, dim=0)


@lru_cache(maxsize=None)
def make_glv_scalar(q: int, lambda_: int, w: int = 12) -> GlvScalar:
    return GlvScalar(q, lambda_, w)
