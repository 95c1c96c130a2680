"""Top-level curve API: ``Weierstrass`` for the MSM main path.

Mirror of ``msm_zprize_tpu/parallel/api.py::Weierstrass`` (create, int I/O,
padding, msm, msm_unsafe, msm_bigint, random_scalars). Tensors live on the
device the caller names; ``msm`` runs on the device of its inputs and
defaults to ``mode="projective"``, the one mode ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.params import WeierstrassParams
from ..curves.weierstrass import AffinePoints, ProjectivePoints, WeierstrassOps
from ..fields.limbs import random_uniform_limbs
from ..fields.scalar import make_glv_scalar
from ..msm.batched_affine import msm_batched_affine

__all__ = ["Weierstrass"]


class Weierstrass:
    """Curve module for a short-Weierstrass curve with a GLV endomorphism."""

    _instances: dict = {}

    def __init__(self, params: WeierstrassParams, w: int = 12):
        self.params = params
        self.ops = WeierstrassOps(params, w)
        self.scalar = make_glv_scalar(params.order, params.lambda_, w)
        self.label = params.label

    @classmethod
    def create(cls, params: WeierstrassParams, w: int = 12) -> "Weierstrass":
        key = (params.label, w)
        if key not in cls._instances:
            cls._instances[key] = cls(params, w)
        return cls._instances[key]

    # ---- I/O ----------------------------------------------------------------

    def scalars_from_ints(self, scalars, device) -> torch.Tensor:
        return torch.as_tensor(self.scalar.pack(scalars), device=device)

    def points_from_ints(self, points, device) -> AffinePoints:
        """points: list of (x, y) int tuples, or None for infinity."""
        return self.ops.pack_affine(points, device)

    def result_to_int(self, res: ProjectivePoints):
        """Projective result -> affine (x, y) int tuple, or None."""
        [(X, Y, Z)] = self.ops.unpack_projective(res)
        p = self.params.modulus
        if Z % p == 0:
            return None
        zi = pow(Z, -1, p)
        return X * zi % p, Y * zi % p

    # ---- MSM ----------------------------------------------------------------

    def _pad(self, scalars, points: AffinePoints):
        """Pad N up to a power of two (>= 8); padding points are infinity
        with zero scalars (no contribution)."""
        N = points.x.shape[-1]
        target = 8
        while target < N:
            target *= 2
        if target == N:
            return scalars, points
        pad = target - N
        pad2 = lambda a, value=0: torch.nn.functional.pad(a, (0, pad), value=value)
        return pad2(scalars), AffinePoints(pad2(points.x), pad2(points.y), pad2(points.inf, 1))

    def msm(self, scalars, points: AffinePoints, c: int | None = None,
            mode: str = "projective") -> ProjectivePoints:
        """Safe MSM (duplicate points allowed): scalars (n, N) limbs, points
        an affine batch of N, on one device."""
        scalars, points = self._pad(scalars, points)
        return msm_batched_affine(self.ops, self.scalar, scalars, points, c, mode=mode)

    def msm_unsafe(self, scalars, points: AffinePoints, c: int | None = None,
                   mode: str = "projective") -> ProjectivePoints:
        """The msmUnsafe entry point. Projective adds are complete, so it
        is the safe path."""
        return self.msm(scalars, points, c, mode)

    def msm_bigint(self, scalars, points, device, c: int | None = None):
        """Python ints in, affine int point out."""
        s = self.scalars_from_ints(scalars, device)
        p = self.points_from_ints(points, device)
        return self.result_to_int(self.msm(s, p, c))

    def random_scalars(self, N: int, seed: int = 0, device="cpu") -> torch.Tensor:
        """Uniform scalars in [0, q): the same limbs as the JAX package's
        ``random_scalars`` for the same seed."""
        rng = np.random.default_rng(seed)
        limbs = random_uniform_limbs(rng, self.params.order, N, self.scalar.scheme)
        return torch.as_tensor(limbs, device=device)
