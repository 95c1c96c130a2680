"""Short-Weierstrass curve ops (a = 0) over row-codec coordinate storage.

Mirror of ``msm_zprize_tpu/curves/weierstrass51.py``: points live in a row
codec (``fields/codec.py``) end to end through the MSM, each coordinate a
``(codec.rows, *batch)`` int32 tensor of a Montgomery-form value below 2p.
The curve ops are the kernels of ``curves/cuda_curve.py`` on that storage
(K14: K3-K7 decoding rows at their loads and encoding at their stores) and
the endomorphism is K13; the glue (``coord_cneg``, ``from_native``,
``to_native``) is torch ops through digit planes, as it is XLA ops in JAX.
CUDA tensors launch the kernels or raise; CPU tensors take the plain twins.

Exactly the surface the projective pipeline of ``msm/batched_affine.py``
calls on its curve ops, so ``Weierstrass.msm(..., mode="packed")`` runs the
projective MSM on ``PackedCodec`` storage (13 rows on BLS12-377 and
BLS12-381, 9 on Pallas) and ``mode="fma51"`` on 10 ``Fma51Codec`` pair
rows. The ``Fma51Codec`` layout takes only p < 2^255 - 2^206: of the
curves supported, Pallas.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.codec import Fma51Codec, PackedCodec
from ..fields.cuda_codec import montmul_rows
from ..fields.fp import MontgomeryFp, make_field
from . import cuda_curve
from .params import WeierstrassParams
from .weierstrass import AffinePoints, ProjectivePoints

__all__ = ["Fma51WeierstrassOps", "PackedWeierstrassOps"]


class Fma51WeierstrassOps:
    """Curve ops with row-codec coordinate storage; the default codec is the
    51x5 pair layout (``Fma51Codec``), ``PackedWeierstrassOps`` the dense
    31-bit rows."""

    def __init__(self, params: WeierstrassParams, w: int = 12, codec=None):
        p = params.modulus
        self.params = params
        self.codec = Fma51Codec(p) if codec is None else codec
        self.storage = cuda_curve.Storage.of_codec(self.codec)  # K14's entries
        self.F: MontgomeryFp = make_field(p, w)
        F = self.F
        self.p = p
        self.b3_mont = 3 * params.b * F.R % p
        self.b3_small = 3 * params.b  # as WeierstrassOps: field additions
        self.beta_mont = params.beta * F.R % p if params.beta is not None else None
        self._one_rows = self.codec.pack([F.mont_one])  # (rows, 1)
        self._beta_rows = self.codec.pack([self.beta_mont]) if self.beta_mont is not None else None

    def _column(self, rows: np.ndarray, batch, device) -> torch.Tensor:
        r = self.codec.rows
        col = torch.as_tensor(rows, device=device).reshape((r,) + (1,) * len(batch))
        return col.expand((r,) + tuple(batch)).contiguous()

    # ---- representation hooks (the contract of WeierstrassOps) ------------

    def coord_ones(self, *batch, device):
        return self._column(self._one_rows, batch, device)

    def coord_cneg(self, y, flag):
        """Conditional negation on rows, through digit planes: 2p - y where
        flag, y unchanged where y == 0 (2p would be one past the [0, 2p)
        storage contract)."""
        F = self.F
        d = self.codec.to_digits(F, y)
        negp = self.codec.from_digits(F, F.neg(d), 2 * self.p - 1)
        is_zero = (d == 0).all(dim=0)
        return torch.where(flag.bool() & ~is_zero, negp, y)

    def proj_zeros(self, *batch, device) -> ProjectivePoints:
        """(0 : 1 : 0), the identity, on every lane."""
        z = torch.zeros((self.codec.rows,) + tuple(batch), dtype=torch.int32, device=device)
        return ProjectivePoints(z, self.coord_ones(*batch, device=device), z.clone())

    # ---- native-layout interop ------------------------------------------------

    def from_native(self, digits, vmax: int | None = None):
        """(n, *batch) digit planes (value <= vmax, default 2p - 1) -> rows."""
        return self.codec.from_digits(self.F, digits, vmax)

    def to_native(self, rows):
        """(rows, *batch) rows -> (n, *batch) canonical digit planes."""
        return self.codec.to_digits(self.F, rows)

    # ---- curve ops (K14 on CUDA, plain twins on CPU) ---------------------------

    def proj_add(self, P: ProjectivePoints, Q: ProjectivePoints, mask=None) -> ProjectivePoints:
        return ProjectivePoints(*cuda_curve.proj_add(self, *P, *Q, mask=mask))

    def proj_double(self, P: ProjectivePoints) -> ProjectivePoints:
        return ProjectivePoints(*cuda_curve.proj_double(self, *P))

    def proj_double_k(self, P: ProjectivePoints, k: int) -> ProjectivePoints:
        if k <= 0:
            return P
        return ProjectivePoints(*cuda_curve.proj_double_k(self, *P, k))

    def proj_add_affine(self, P: ProjectivePoints, Q: AffinePoints) -> ProjectivePoints:
        return ProjectivePoints(*cuda_curve.proj_add_mixed(self, *P, Q.x, Q.y, Q.inf))

    def aff_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2) -> ProjectivePoints:
        return ProjectivePoints(*cuda_curve.aff_pair_add(self, x1, y1, s1, v1, x2, y2, s2, v2))

    def endomorphism(self, P: AffinePoints) -> AffinePoints:
        """(x, y) -> (beta x, y): one Montgomery product by the constant on
        the rows (K13)."""
        x = P.x.reshape(self.codec.rows, -1)
        beta = self._column(self._beta_rows, x.shape[1:], x.device)
        bx = montmul_rows(self.F, self.codec, x.contiguous(), beta)
        return AffinePoints(bx.reshape(P.x.shape), P.y, P.inf)

    # ---- I/O ----------------------------------------------------------------------

    def pack_affine(self, points, device) -> AffinePoints:
        """Oracle affine points (None = infinity) -> a row batch (Montgomery
        form, canonical [0, p))."""
        F = self.F
        xs = [0 if P is None else P[0] * F.R % self.p for P in points]
        ys = [1 if P is None else P[1] * F.R % self.p for P in points]
        inf = np.array([1 if P is None else 0 for P in points], dtype=np.int32)
        return AffinePoints(*(torch.as_tensor(a, device=device)
                              for a in (self.codec.pack(xs), self.codec.pack(ys), inf)))

    def unpack_projective(self, pts: ProjectivePoints):
        r_inv = pow(self.F.R, -1, self.p)

        def un(a):
            return [v * r_inv % self.p for v in self.codec.unpack(a)]

        return list(zip(un(pts.X), un(pts.Y), un(pts.Z)))


class PackedWeierstrassOps(Fma51WeierstrassOps):
    """Curve ops over dense 31-bit rows (``PackedCodec``), valid for every
    field size: 13 rows per BLS12-377 coordinate against 32 digit planes,
    so every gather and tree transfer of the MSM engine moves ~2.5x fewer
    bytes for the same arithmetic."""

    def __init__(self, params: WeierstrassParams, w: int = 12):
        super().__init__(params, w, codec=PackedCodec(params.modulus))
