"""Top-level curve API: ``Weierstrass`` and ``TwistedEdwards``.

Mirror of ``msm_zprize_tpu/parallel/api.py::Weierstrass`` and
``TwistedEdwards`` (create, int I/O, padding, msm, msm_unsafe, msm_bigint,
random_scalars). Every entry point that makes tensors puts them on the card
(``device="cuda"``) unless the caller names another device, such as
``"cpu"`` for the plain PyTorch twins; ``msm`` runs on the device of its
inputs. The ported modes are ``"projective"`` (Weierstrass) and
``"padded"`` (twisted Edwards). ``random_points_fast`` is ROADMAP queue 1,
item 7.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.edwards import EdwardsOps, ExtPoints
from ..curves.params import EdwardsParams, WeierstrassParams
from ..curves.weierstrass import AffinePoints, ProjectivePoints, WeierstrassOps
from ..fields.limbs import random_uniform_limbs
from ..fields.scalar import SimpleScalar, make_glv_scalar
from ..msm.basic import msm_basic_edwards
from ..msm.batched_affine import msm_batched_affine

__all__ = ["Weierstrass", "TwistedEdwards"]

DEVICE = "cuda"


def _random_scalars(q: int, scalar, N: int, seed: int, device) -> torch.Tensor:
    """Uniform scalars in [0, q): the same limbs as the JAX package's
    ``random_scalars`` for the same seed."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(random_uniform_limbs(rng, q, N, scalar.scheme), device=device)


def _pad_target(N: int) -> int:
    """N padded up to a power of two, at least 8."""
    target = 8
    while target < N:
        target *= 2
    return target


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

    def scalars_from_ints(self, scalars, device=DEVICE) -> torch.Tensor:
        return torch.as_tensor(self.scalar.pack(scalars), device=device)

    def points_from_ints(self, points, device=DEVICE) -> AffinePoints:
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
        pad = _pad_target(N) - N
        if not pad:
            return scalars, points
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

    def msm_bigint(self, scalars, points, device=DEVICE, c: int | None = None):
        """Python ints in, affine int point out."""
        s = self.scalars_from_ints(scalars, device)
        p = self.points_from_ints(points, device)
        return self.result_to_int(self.msm(s, p, c))

    def random_scalars(self, N: int, seed: int = 0, device=DEVICE) -> torch.Tensor:
        """Uniform scalars in [0, q): the JAX package's limbs for the seed."""
        return _random_scalars(self.params.order, self.scalar, N, seed, device)


class TwistedEdwards:
    """Curve module for a twisted-Edwards curve (a = -1)."""

    _instances: dict = {}

    def __init__(self, params: EdwardsParams, w: int = 12):
        self.params = params
        self.ops = EdwardsOps(params, w)
        self.scalar = SimpleScalar(params.order, w)
        self.label = params.label

    @classmethod
    def create(cls, params: EdwardsParams, w: int = 12) -> "TwistedEdwards":
        key = (params.label, w)
        if key not in cls._instances:
            cls._instances[key] = cls(params, w)
        return cls._instances[key]

    # ---- I/O ----------------------------------------------------------------

    def scalars_from_ints(self, scalars, device=DEVICE) -> torch.Tensor:
        return torch.as_tensor(self.scalar.pack(scalars), device=device)

    def points_from_ints(self, points, device=DEVICE) -> ExtPoints:
        """points: list of affine (x, y) int tuples ((0, 1) is the identity)."""
        p = self.params.modulus
        ext = [(x % p, y % p, 1, x * y % p) for x, y in points]
        return self.ops.pack(ext, device)

    def result_to_int(self, res: ExtPoints):
        """Extended result -> affine (x, y) int tuple."""
        [(X, Y, Z, _)] = self.ops.unpack(res)
        p = self.params.modulus
        zi = pow(Z, -1, p)
        return X * zi % p, Y * zi % p

    # ---- MSM ----------------------------------------------------------------

    def _pad(self, scalars, points: ExtPoints):
        """Pad N up to a power of two (>= 8); padding points are the identity
        (0, 1, 1, 0) with zero scalars."""
        N = points.X.shape[-1]
        pad = _pad_target(N) - N
        if not pad:
            return scalars, points
        zero = self.ops.zeros(pad, device=points.X.device)
        scalars = torch.nn.functional.pad(scalars, (0, pad))
        return scalars, ExtPoints(*(torch.cat([a, z], dim=-1) for a, z in zip(points, zero)))

    def msm(self, scalars, points: ExtPoints, c: int | None = None,
            mode: str = "padded") -> ExtPoints:
        """MSM (duplicate points allowed): scalars (n, N) limbs, points an
        extended batch of N, on one device."""
        scalars, points = self._pad(scalars, points)
        return msm_basic_edwards(self.ops, scalars, points, self.scalar.bits, c, mode=mode)

    def msm_unsafe(self, scalars, points: ExtPoints, c: int | None = None,
                   mode: str = "padded") -> ExtPoints:
        """The msmUnsafe entry point: the unified add is complete, so it is
        the safe path."""
        return self.msm(scalars, points, c, mode)

    def msm_bigint(self, scalars, points, device=DEVICE, c: int | None = None):
        """Python ints in, affine int point out."""
        s = self.scalars_from_ints(scalars, device)
        p = self.points_from_ints(points, device)
        return self.result_to_int(self.msm(s, p, c))

    def random_scalars(self, N: int, seed: int = 0, device=DEVICE) -> torch.Tensor:
        """Uniform scalars in [0, q): the JAX package's limbs for the seed."""
        return _random_scalars(self.params.order, self.scalar, N, seed, device)
