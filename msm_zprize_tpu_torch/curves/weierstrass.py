"""Batched short-Weierstrass curve ops (a = 0) over torch limb tensors.

Mirror of ``msm_zprize_tpu/curves/weierstrass.py`` for the MSM main path:
struct-of-limb-arrays points (each coordinate ``(n, *batch)`` int32,
Montgomery form, values < 2p), masks instead of branches. The hot curve
ops dispatch through the kernel wrappers of ``curves/cuda_curve.py``: the
CUDA kernels K3-K5 for CUDA tensors, their plain twins for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields.fp import MontgomeryFp, make_field
from . import cuda_curve
from .params import WeierstrassParams

__all__ = ["AffinePoints", "ProjectivePoints", "WeierstrassOps"]


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


class WeierstrassOps:
    """Batched curve arithmetic for y^2 = x^3 + b, a = 0."""

    def __init__(self, params: WeierstrassParams, w: int = 12):
        self.params = params
        self.F: MontgomeryFp = make_field(params.modulus, w)
        F = self.F
        self.b3_mont = 3 * params.b * F.R % params.modulus  # RCB formulas use 3b
        # 3b as a plain integer: multiplied by field additions (small-integer
        # multiplication commutes with the Montgomery form)
        self.b3_small = 3 * params.b
        self.beta_mont = params.beta * F.R % params.modulus if params.beta is not None else None

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

    def unpack_projective(self, pts: ProjectivePoints):
        F = self.F
        return list(zip(F.unpack(pts.X), F.unpack(pts.Y), F.unpack(pts.Z)))

    # ---- the hot ops (kernels on CUDA, plain twins on CPU) ---------------------

    def proj_add(self, P: ProjectivePoints, Q: ProjectivePoints) -> ProjectivePoints:
        """Complete add (RCB Alg. 7): identity, doubling and cancellation
        all flow through one branch-free formula."""
        return ProjectivePoints(*cuda_curve.proj_add(self, *P, *Q))

    def proj_double_k(self, P: ProjectivePoints, k: int) -> ProjectivePoints:
        """k chained complete doublings (RCB Alg. 9; valid on the odd-order
        subgroup, the MSM domain)."""
        if k <= 0:
            return P
        return ProjectivePoints(*cuda_curve.proj_double_k(self, *P, k))

    def proj_double(self, P: ProjectivePoints) -> ProjectivePoints:
        """One complete doubling: the K5 chain with k = 1 (the TPU package's
        single-doubling kernel is not ported)."""
        return self.proj_double_k(P, 1)

    def aff_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2) -> ProjectivePoints:
        """Complete add of two signed affine slots: operand i is
        ((-1)^s_i * (x_i, y_i)) where v_i, else the identity."""
        return ProjectivePoints(*cuda_curve.aff_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2))

    def endomorphism(self, P: AffinePoints) -> AffinePoints:
        """(x, y) -> (beta x, y); beta * x runs through the K1 montmul."""
        return AffinePoints(self.F.montmul(P.x, self.F.const(self.beta_mont, P.x)), P.y, P.inf)
