"""Scalar modules: GLV decomposition and signed-digit windowing, in torch.

Mirror of ``msm_zprize_tpu/fields/scalar.py`` (``SimpleScalar``,
``GlvScalar.decompose``, ``GlvScalarSpecial``, ``GlvScalarSpecialMsm``,
``signed_digits``, ``make_glv_scalar``): the same 12-bit limb algorithm in
int32, so results are bit-identical to the JAX package. ``GlvScalar.decompose``
+ ``signed_digits`` together are the plain twin of the K2 kernel
(``fields/cuda_scalar.py``); the special split by Barrett division has no
kernel in the JAX package and runs as torch ops on the scalars' device.
Scalars are plain (non-Montgomery) limb tensors of shape ``(n, *batch)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bigint.glv import glv_params
from . import limbs as L
from .limbs import DTYPE, LimbScheme

__all__ = [
    "SimpleScalar", "GlvScalar", "GlvScalarSpecial", "GlvScalarSpecialMsm", "glv_basis",
    "signed_digits", "make_glv_scalar",
]


def glv_basis(q: int, lambda_: int):
    """Short lattice basis of {(a, b): a + b lambda == 0 mod q}, from
    ``bigint/glv.py::glv_params`` (the one derivation). Returns ((v00, v01),
    (v10, v11), det, max_bits), max_bits bounding the bit length of a
    Babai-rounded half."""
    g = glv_params(q, lambda_)
    return (g.v00, g.v01), (g.v10, g.v11), g.det, g.max_bits


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
        u = [
            L.mul_shift_floor(s, L.column(m, s), w, self.K0_limbs, self.n_half + 1)
            for m in (self.m0, self.m1)
        ]
        prods = [
            (sg, L.mul_low(u[ui], L.column(self.sv[name][1], s), w, n_acc))
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


def _one(ref: torch.Tensor) -> torch.Tensor:
    """The limbs of 1 in ref's shape."""
    one = torch.zeros_like(ref)
    one[0] = 1
    return one


class GlvScalarSpecial(SimpleScalar):
    """GLV split by Barrett DIVISION for lambda ~ sqrt(q) (BLS12-377/381):

        s1 = floor(s / lambda)  (Barrett: (s m) >> K, m = floor(2^K / lambda),
                                 then two conditional corrections)
        s0 = s - s1 lambda

    so s = s0 + lambda s1 exactly, s0 < lambda. ``decompose_no_msb`` also
    forces s0 < 2^(half_bits - 1) by the flip s0 -> lambda - s0,
    s1 -> s1 + 1 with a sign flag."""

    def __init__(self, q: int, lambda_: int, w: int = 12):
        super().__init__(q, w)
        if abs(2 * lambda_.bit_length() - q.bit_length()) > 3:
            raise ValueError("the special GLV split needs lambda ~ sqrt(q)")
        self.lambda_ = lambda_
        self.half_bits = max(lambda_.bit_length(), q.bit_length() - lambda_.bit_length() + 1)
        self.n_half = -(-self.half_bits // w)
        # m = floor(2^K / lambda), K whole limbs covering bits(q) + w (error <= 2)
        self.K_limbs = -(-(q.bit_length() + w) // w)
        m = (1 << (self.K_limbs * w)) // lambda_
        self.m = np.array(LimbScheme(w, max(-(-m.bit_length() // w), 1)).to_limbs(m), dtype=np.int32)
        # n_half + 1 limbs: the corrections subtract lambda over the
        # (n_half + 1)-limb remainder, limb for limb
        self.l_limbs = np.array(LimbScheme(w, self.n_half + 1).to_limbs(lambda_), dtype=np.int32)

    def decompose(self, s: torch.Tensor):
        """s: (n, B) canonical limbs in [0, q). Returns (u0, u1), canonical
        (n_half, B), with s == u0 + lambda u1 and u0 < lambda."""
        w, n_h = self.w, self.n_half
        lam = L.column(self.l_limbs, s)
        q1 = L.mul_shift_floor(s, L.column(self.m, s), w, self.K_limbs, n_h + 1)
        r = L.sub_mod_pow2(s, L.mul_low(q1, lam, w, n_h + 1), w, n_h + 1)  # r < ~3 lambda
        one = _one(q1)
        for _ in range(2):  # the quotient is at most 2 short
            d = L.sub_mod_pow2(r, lam, w, n_h + 1)
            ge = ((d[n_h] >> (w - 1)) & 1) == 0  # no borrow out of the top: r >= lambda
            r = torch.where(ge, d, r)
            q1 = torch.where(ge, L.add_mod_pow2(q1, one, w, n_h + 1), q1)
        return r[:n_h], q1[:n_h]

    def decompose_no_msb(self, s: torch.Tensor):
        """(sign0, u0, u1) with s == (-1)^sign0 u0 + lambda u1 and
        u0 < 2^(half_bits - 1)."""
        u0, u1 = self.decompose(s)
        w, n_h = self.w, self.n_half
        big = L.extract_bits(u0, self.half_bits - 1, 1, w) != 0
        u0 = torch.where(big, L.sub_mod_pow2(L.column(self.l_limbs, u0), u0, w, n_h), u0)
        u1 = torch.where(big, L.add_mod_pow2(u1, _one(u1), w, n_h), u1)
        return big.to(DTYPE), u0, u1


class GlvScalarSpecialMsm(SimpleScalar):
    """The special split with ``GlvScalar``'s decompose surface (two signed
    halves), so ``msm_batched_affine`` runs a lambda ~ sqrt(q) curve on it:
    s = (-1)^g0 u0 + lambda (-1)^g1 u1 (mod q), u0 < 2^(half_bits - 1)."""

    def __init__(self, q: int, lambda_: int, w: int = 12):
        super().__init__(q, w)
        # divide by the ~sqrt(q) eigenvalue: a curve may store its conjugate
        # q - lambda (BLS12-377 does), then u1's sign flips
        lam_eff = min(lambda_, q - lambda_)
        self._neg1 = lam_eff != lambda_
        self._sp = GlvScalarSpecial(q, lam_eff, w)
        self.lambda_ = lambda_
        self.max_bits = self._sp.half_bits
        self.n_half = self._sp.n_half

    def decompose(self, s: torch.Tensor):
        g0, u0, u1 = self._sp.decompose_no_msb(s)
        g1 = torch.ones_like(g0) if self._neg1 else torch.zeros_like(g0)
        return g0, u0, g1, u1

    def pack_half(self, values) -> np.ndarray:
        return L.pack(list(values), LimbScheme(self.w, self.n_half))

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
