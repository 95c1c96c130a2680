"""Batched short-Weierstrass curve ops (a = 0) over torch limb tensors.

Mirror of ``msm_zprize_tpu/curves/weierstrass.py``: struct-of-limb-arrays
points (each coordinate ``(n, *batch)`` int32, Montgomery form, values
< 2p; affine points carry an infinity flag), masks instead of branches.
The hot curve ops dispatch through the kernel wrappers of
``curves/cuda_curve.py``: the CUDA kernels K3-K7 for CUDA tensors, their
plain twins for CPU tensors; ``batch_add``, ``to_affine`` and the
predicates are field ops (K1 and K8 on CUDA). ``proj_scale_dyn`` and the
subgroup ops are ROADMAP queue 1, item 10.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields.fp import MontgomeryFp, make_field
from . import cuda_curve
from .params import WeierstrassParams

__all__ = ["AffinePoints", "ProjectivePoints", "WeierstrassOps", "select"]


class AffinePoints(NamedTuple):
    """(x, y) plus an infinity flag (1 = infinity). x, y: (n, B); inf: (B,)."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


class ProjectivePoints(NamedTuple):
    """(X, Y, Z); the identity is Z == 0 (canonically (0 : 1 : 0))."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor


def select(mask, a, b):
    """Per-lane select between two point batches of one type: a where mask."""
    return type(a)(*(torch.where(mask, fa, fb) for fa, fb in zip(a, b)))


class WeierstrassOps:
    """Batched curve arithmetic for y^2 = x^3 + b, a = 0."""

    def __init__(self, params: WeierstrassParams, w: int = 12):
        self.params = params
        self.F: MontgomeryFp = make_field(params.modulus, w)
        F = self.F
        self.b_mont = params.b * F.R % params.modulus
        self.b3_mont = 3 * params.b * F.R % params.modulus  # RCB formulas use 3b
        # 3b as a plain integer: multiplied by field additions (small-integer
        # multiplication commutes with the Montgomery form)
        self.b3_small = 3 * params.b
        self.beta_mont = params.beta * F.R % params.modulus if params.beta is not None else None
        self.storage = cuda_curve.Storage(F.n)  # 12-bit Montgomery limbs

    # ---- coordinate storage hooks ----------------------------------------------

    def coord_ones(self, *batch, device):
        return self.F.ones_mont(*batch, device=device)

    def coord_cneg(self, y, flag):
        return self.F.cneg(y, flag)

    # ---- I/O ------------------------------------------------------------------

    def proj_zeros(self, *batch, device) -> ProjectivePoints:
        F = self.F
        return ProjectivePoints(
            F.zeros(*batch, device=device), F.ones_mont(*batch, device=device),
            F.zeros(*batch, device=device),
        )

    def affine_zeros(self, *batch, device) -> AffinePoints:
        F = self.F
        return AffinePoints(F.zeros(*batch, device=device), F.zeros(*batch, device=device),
                            torch.ones(batch, dtype=torch.int32, device=device))

    def pack_affine(self, points, device) -> AffinePoints:
        """List of oracle affine points (None = infinity) -> batch."""
        F = self.F
        xs = [0 if P is None else P[0] for P in points]
        ys = [1 if P is None else P[1] for P in points]
        inf = np.array([1 if P is None else 0 for P in points], dtype=np.int32)
        return AffinePoints(
            torch.as_tensor(F.pack(xs), device=device),
            torch.as_tensor(F.pack(ys), device=device),
            torch.as_tensor(inf, device=device),
        )

    def unpack_affine(self, pts: AffinePoints):
        F = self.F
        inf = pts.inf.tolist()
        return [None if f else (x, y) for x, y, f in zip(F.unpack(pts.x), F.unpack(pts.y), inf)]

    def pack_projective(self, points, device) -> ProjectivePoints:
        """List of oracle (X, Y, Z) int tuples -> batch."""
        F = self.F
        return ProjectivePoints(*(torch.as_tensor(F.pack([P[i] for P in points]), device=device)
                                  for i in range(3)))

    def unpack_projective(self, pts: ProjectivePoints):
        F = self.F
        return list(zip(F.unpack(pts.X), F.unpack(pts.Y), F.unpack(pts.Z)))

    # ---- the hot ops (kernels on CUDA, plain twins on CPU) ---------------------

    def proj_add(self, P: ProjectivePoints, Q: ProjectivePoints, mask=None) -> ProjectivePoints:
        """Complete add (RCB Alg. 7, K4): identity, doubling and cancellation
        all flow through one branch-free formula. With ``mask`` (K4m), lanes
        where mask == 0 return P unchanged."""
        return ProjectivePoints(*cuda_curve.proj_add(self, *P, *Q, mask=mask))

    def proj_double_k(self, P: ProjectivePoints, k: int) -> ProjectivePoints:
        """k chained complete doublings (RCB Alg. 9; valid on the odd-order
        subgroup, the MSM domain) in one launch (K5)."""
        if k <= 0:
            return P
        return ProjectivePoints(*cuda_curve.proj_double_k(self, *P, k))

    def proj_double(self, P: ProjectivePoints) -> ProjectivePoints:
        """One complete doubling (K6)."""
        return ProjectivePoints(*cuda_curve.proj_double(self, *P))

    def proj_add_affine(self, P: ProjectivePoints, Q: AffinePoints) -> ProjectivePoints:
        """Complete mixed add (RCB Alg. 8, K7): 11 muls; the only mask is
        Q = infinity, where P passes unchanged."""
        return ProjectivePoints(*cuda_curve.proj_add_mixed(self, *P, Q.x, Q.y, Q.inf))

    def proj_neg(self, P: ProjectivePoints) -> ProjectivePoints:
        return ProjectivePoints(P.X, self.F.neg(P.Y), P.Z)

    def proj_sub(self, P: ProjectivePoints, Q: ProjectivePoints) -> ProjectivePoints:
        return self.proj_add(P, self.proj_neg(Q))

    def proj_scale_const(self, k: int, P: ProjectivePoints) -> ProjectivePoints:
        """k * P for a static Python int k (double-and-add, K4 and K6)."""
        R = None
        Q = P
        while k > 0:
            if k & 1:
                R = Q if R is None else self.proj_add(R, Q)
            k >>= 1
            if k:
                Q = self.proj_double(Q)
        if R is None:
            return self.proj_zeros(*P.X.shape[1:], device=P.X.device)
        return R

    def aff_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2) -> ProjectivePoints:
        """Complete add of two signed affine slots: operand i is
        ((-1)^s_i * (x_i, y_i)) where v_i, else the identity."""
        return ProjectivePoints(*cuda_curve.aff_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2))

    def endomorphism(self, P: AffinePoints) -> AffinePoints:
        """(x, y) -> (beta x, y); beta * x runs through the K1 montmul."""
        return AffinePoints(self.F.montmul(P.x, self.F.const(self.beta_mont, P.x)), P.y, P.inf)

    # ---- predicates -------------------------------------------------------------

    def proj_eq(self, P: ProjectivePoints, Q: ProjectivePoints):
        """Equality across representatives (cross-multiplied)."""
        F = self.F
        pz, qz = F.is_zero(P.Z), F.is_zero(Q.Z)
        ex = F.is_equal(F.montmul(P.X, Q.Z), F.montmul(Q.X, P.Z))
        ey = F.is_equal(F.montmul(P.Y, Q.Z), F.montmul(Q.Y, P.Z))
        return (pz & qz) | (~(pz ^ qz) & ex & ey)

    def proj_is_on_curve(self, P: ProjectivePoints):
        """Y^2 Z == X^3 + b Z^3 (identity lanes pass)."""
        F = self.F
        X, Y, Z = P
        lhs = F.montmul(F.montsquare(Y), Z)
        b = F.const(self.b_mont, X)
        rhs = F.add(F.montmul(F.montsquare(X), X), F.montmul(F.montmul(b, F.montsquare(Z)), Z))
        return F.is_equal(lhs, rhs) | F.is_zero(Z)

    def affine_is_on_curve(self, P: AffinePoints):
        """y^2 == x^3 + b (infinity lanes pass)."""
        F = self.F
        rhs = F.add(F.montmul(F.montsquare(P.x), P.x), F.const(self.b_mont, P.x))
        return F.is_equal(F.montsquare(P.y), rhs) | P.inf.bool()

    # ---- affine <-> projective ----------------------------------------------------

    def to_affine(self, P: ProjectivePoints) -> AffinePoints:
        """Normalize with one shared batch inversion of Z (K1 and one K8);
        Z == 0 lanes become infinity."""
        F = self.F
        inf = F.is_zero(P.Z)
        zi = F.batch_inverse(torch.where(inf, F.ones_mont(*P.Z.shape[1:], device=P.Z.device), P.Z))
        return AffinePoints(F.montmul(P.X, zi), F.montmul(P.Y, zi), inf.to(torch.int32))

    def from_affine(self, P: AffinePoints) -> ProjectivePoints:
        F = self.F
        one = F.ones_mont(*P.x.shape[1:], device=P.x.device)
        return ProjectivePoints(P.x, P.y, torch.where(P.inf.bool(), torch.zeros_like(one), one))

    # ---- affine ops (the batched-affine MSM) ---------------------------------------

    def affine_neg(self, P: AffinePoints) -> AffinePoints:
        return AffinePoints(P.x, self.F.neg(P.y), P.inf)

    def affine_cneg(self, P: AffinePoints, flag) -> AffinePoints:
        """Conditional negation per lane (sign application for signed digits)."""
        return AffinePoints(P.x, self.F.cneg(P.y, flag), P.inf)

    def batch_add(self, P: AffinePoints, Q: AffinePoints, safe: bool = True,
                  active=None) -> AffinePoints:
        """R_i = P_i + Q_i in affine coordinates with ONE shared batch
        inversion of the slope denominators (K1 and one K8 on the card).

        safe=True handles doubling, cancellation and infinities with masks;
        safe=False assumes x1 != x2 wherever both lanes are finite (the
        msmUnsafe contract). ``active`` (B,) marks the lanes whose content is
        meaningful: every other lane gets denominator 1, because a single
        zero denominator would poison the whole inversion (its output is
        then unspecified)."""
        F = self.F
        x1, y1, x2, y2 = P.x, P.y, Q.x, Q.y
        p_inf, q_inf = P.inf.bool(), Q.inf.bool()
        one = F.ones_mont(*x1.shape[1:], device=x1.device)
        if safe:
            x_eq, y_eq = F.is_equal(x1, x2), F.is_equal(y1, y2)
            finite = ~p_inf & ~q_inf
            is_dbl = x_eq & y_eq & finite
            is_cancel = x_eq & ~y_eq & finite
            denom = torch.where(is_dbl, F.add(y1, y1), F.sub_positive(x2, x1))
            need_inv = ~(p_inf | q_inf | is_cancel)
            if active is not None:
                need_inv = need_inv & active.bool()
            d = F.batch_inverse(torch.where(need_inv, denom, one))
            xx = F.montsquare(x1)
            num = torch.where(is_dbl, F.add(F.add(xx, xx), xx), F.sub_positive(y2, y1))
            m = F.montmul(num, d)
        else:
            invalid = p_inf | q_inf
            if active is not None:
                invalid = invalid | ~active.bool()
            d = F.batch_inverse(torch.where(invalid, one, F.sub_positive(x2, x1)))
            m = F.montmul(F.sub_positive(y2, y1), d)
            is_cancel = torch.zeros_like(p_inf)

        x3 = F.sub(F.sub(F.montsquare(m), x1), x2)
        y3 = F.sub(F.montmul(m, F.sub_positive(x1, x3)), y1)
        out = AffinePoints(x3, y3, torch.zeros_like(P.inf))
        out = select(p_inf, Q, out)
        out = select(q_inf & ~p_inf, P, out)
        inf_lane = is_cancel | (p_inf & q_inf)
        return out._replace(inf=torch.where(inf_lane, 1, out.inf).to(torch.int32))
