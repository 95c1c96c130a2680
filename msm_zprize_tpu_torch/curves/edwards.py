"""Batched twisted-Edwards curve ops (a = -1), extended coordinates, over
torch limb tensors.

Mirror of ``msm_zprize_tpu/curves/edwards.py::EdwardsOps``: points are
struct-of-limb-arrays (each coordinate ``(n, *batch)`` int32, Montgomery
form), the identity is (0, 1, 1, 0), and the strongly unified hwcd-3 add
needs no masks. The curve ops dispatch through the kernel wrappers of
``curves/cuda_edwards.py``: the CUDA kernels K10-K12 for CUDA tensors,
their plain twins for CPU tensors. The scalar multiples (ROADMAP queue 1,
item 10) are double-and-add on those kernels: ``scale_dyn`` takes a runtime
scalar bit by bit (the masked K11 selects, K12 at k = 1 doubles), and
``scale_const``, the subgroup check and cofactor clearing take a static
scalar (K11 where a bit is set, K12 between).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import limbs as L
from ..fields.fp import MontgomeryFp, make_field
from . import cuda_edwards, scale
from .params import EdwardsParams

__all__ = ["ExtPoints", "EdwardsOps"]


class ExtPoints(NamedTuple):
    """Extended coordinates (X, Y, Z, T), each (n, B); x = X/Z, y = Y/Z,
    T = XY/Z."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor


class EdwardsOps:
    """Batched curve arithmetic for -x^2 + y^2 = 1 + d x^2 y^2."""

    def __init__(self, params: EdwardsParams, w: int = 12):
        self.params = params
        self.F: MontgomeryFp = make_field(params.modulus, w)
        p, R = params.modulus, self.F.R
        self.k_mont = 2 * params.d * R % p  # hwcd-3's k = 2d
        self.two_mont = 2 * R % p  # D = 2 Z1 Z2 of the unit-Z level-1 add

    # ---- I/O ------------------------------------------------------------------

    def zeros(self, *batch, device) -> ExtPoints:
        F = self.F
        return ExtPoints(
            F.zeros(*batch, device=device), F.ones_mont(*batch, device=device),
            F.ones_mont(*batch, device=device), F.zeros(*batch, device=device),
        )

    def pack(self, points, device) -> ExtPoints:
        """Oracle extended tuples (X, Y, Z, T) -> batch."""
        F = self.F
        return ExtPoints(*(torch.as_tensor(F.pack([P[i] for P in points]), device=device)
                           for i in range(4)))

    def unpack(self, pts: ExtPoints):
        F = self.F
        return list(zip(*(F.unpack(a) for a in pts)))

    # ---- negation -------------------------------------------------------------

    def neg(self, P: ExtPoints) -> ExtPoints:
        F = self.F
        return ExtPoints(F.neg(P.X), P.Y, P.Z, F.neg(P.T))

    def cneg(self, P: ExtPoints, flag) -> ExtPoints:
        F = self.F
        return ExtPoints(F.cneg(P.X, flag), P.Y, P.Z, F.cneg(P.T, flag))

    # ---- the hot ops (kernels on CUDA, plain twins on CPU) ---------------------

    def add(self, P: ExtPoints, Q: ExtPoints, mask=None) -> ExtPoints:
        """Strongly unified add-2008-hwcd-3, k = 2d (K11): valid for doubling
        and identities. With ``mask``, lanes where mask == 0 return P."""
        return ExtPoints(*cuda_edwards.ed_add(self, *P, *Q, mask=mask))

    def add_mixed(self, P: ExtPoints, Q: ExtPoints) -> ExtPoints:
        """Add of a normalized Q (Z = 1): the full add, as on the TPU (one
        extra product in a fused kernel costs less than a second kernel)."""
        return self.add(P, Q)

    def ed_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2) -> ExtPoints:
        """Fused MSM level-1 op (K10): two signed affine slots (Z = 1, T
        rebuilt) -> extended sum; invalid slots act as the identity."""
        return ExtPoints(*cuda_edwards.ed_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2))

    def double_k(self, P: ExtPoints, k: int) -> ExtPoints:
        """k chained unified doublings in one launch (K12)."""
        if k <= 0:
            return P
        return ExtPoints(*cuda_edwards.ed_double_k(self, *P, k))

    def double(self, P: ExtPoints) -> ExtPoints:
        return self.double_k(P, 1)

    # ---- scalar multiples ---------------------------------------------------------

    def scale_const(self, k: int, P: ExtPoints) -> ExtPoints:
        """k * P for a static Python int k (double-and-add, K11 and K12)."""
        return scale.scale_static(k, P, self.add, self.double, lambda: self._zeros_like(P))

    def scale_dyn(self, k_limbs: torch.Tensor, P: ExtPoints) -> ExtPoints:
        """k * P for a RUNTIME scalar k: (n_k, *batch) canonical limbs, every
        one of its n_k * w bits, with no early exit. Each bit is one masked
        add (the masked K11, whose pass-through lanes are the JAX package's
        select) and one doubling of Q (K12 at k = 1)."""
        return scale.scale_bits(L.bit_planes(k_limbs, self.F.w), P, self.add, self.double,
                                lambda: self._zeros_like(P))

    def _zeros_like(self, P: ExtPoints) -> ExtPoints:
        return self.zeros(*P.X.shape[1:], device=P.X.device)

    def is_in_subgroup(self, P: ExtPoints):
        """order * P == identity, on the device."""
        return self.is_zero(self.scale_const(self.params.order, P))

    def to_subgroup(self, P: ExtPoints) -> ExtPoints:
        """Cofactor clearing: cofactor * P."""
        return self.scale_const(self.params.cofactor, P)

    # ---- predicates -------------------------------------------------------------

    def is_zero(self, P: ExtPoints):
        F = self.F
        return F.is_zero(P.X) & F.is_equal(P.Y, P.Z)

    def eq(self, P: ExtPoints, Q: ExtPoints):
        F = self.F
        ex = F.is_equal(F.montmul(P.X, Q.Z), F.montmul(Q.X, P.Z))
        ey = F.is_equal(F.montmul(P.Y, Q.Z), F.montmul(Q.Y, P.Z))
        return ex & ey

    def is_on_curve(self, P: ExtPoints):
        """-X^2 + Y^2 == Z^2 + d T^2 and T Z == X Y."""
        F = self.F
        d = F.const(self.params.d * F.R % F.p, P.X)
        lhs = F.sub(F.montsquare(P.Y), F.montsquare(P.X))
        rhs = F.add(F.montsquare(P.Z), F.montmul(d, F.montsquare(P.T)))
        return F.is_equal(lhs, rhs) & F.is_equal(F.montmul(P.T, P.Z), F.montmul(P.X, P.Y))

    # ---- normalization ----------------------------------------------------------

    def batch_normalize(self, P: ExtPoints) -> ExtPoints:
        """Scale to Z = 1 with one shared batch inversion (K1 and one K8)."""
        F = self.F
        zi = F.batch_inverse(P.Z)
        one = F.ones_mont(*P.Z.shape[1:], device=P.Z.device)
        return ExtPoints(F.montmul(P.X, zi), F.montmul(P.Y, zi), one, F.montmul(P.T, zi))
