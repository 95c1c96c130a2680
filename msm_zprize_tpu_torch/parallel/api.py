"""Top-level curve API: ``Weierstrass`` and ``TwistedEdwards``.

Mirror of ``msm_zprize_tpu/parallel/api.py::Weierstrass`` and
``TwistedEdwards`` (create, int I/O, padding, msm, msm_unsafe,
msm_projective, msm_bigint, random_scalars, random_points_fast). Every
entry point that makes tensors puts them on the card (``device="cuda"``)
unless the caller names another device, such as ``"cpu"`` for the plain
PyTorch twins; ``msm`` runs on the device of its inputs. Modes: Weierstrass
``"projective"`` (the default), ``"affine"``, ``"halving"`` and the codec
storage mode ``"packed"`` (``"fma51"`` where p < 2^255 - 2^206); twisted
Edwards ``"padded"`` (the default) and ``"basic"``. ``msm`` and
``msm_unsafe`` take ``mesh=`` (``parallel/mesh.py``: one process a rank,
each passing the same inputs) to shard the MSM over a device mesh.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..bigint.edwards import EdwardsCurve
from ..bigint.weierstrass import AffineCurve
from ..curves.edwards import EdwardsOps, ExtPoints
from ..curves.params import EdwardsParams, WeierstrassParams
from ..curves.weierstrass import AffinePoints, ProjectivePoints, WeierstrassOps
from ..curves.weierstrass51 import Fma51WeierstrassOps, PackedWeierstrassOps
from ..fields.codec import FMA51_BOUND
from ..fields.bytes_codec import random_uniform_limbs
from ..fields.scalar import SimpleScalar, make_glv_scalar
from ..msm.basic import msm_basic_edwards, msm_basic_projective
from ..msm.batched_affine import msm_batched_affine
from . import mesh as mesh_mod

__all__ = ["Weierstrass", "TwistedEdwards"]

DEVICE = "cuda"
CODEC_MODES = ("fma51", "packed")


def _random_scalars(q: int, scalar, N: int, seed: int, device) -> torch.Tensor:
    """Uniform scalars in [0, q): the same limbs as the JAX package's
    ``random_scalars`` for the same seed."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(random_uniform_limbs(rng, q, N, scalar.scheme), device=device)


def _table_and_picks(oracle, N: int, seed: int, entropy_bits: int, c: int):
    """The host half of ``random_points_fast``: K = ceil(entropy_bits / c)
    random bases (drawn as the JAX package draws them, from
    ``random.Random(seed ^ 0x9E3779B9)``), row k = [0, B_k, 2 B_k, ...,
    (2^c - 1) B_k], and the (K, N) pick of each output point in each row
    from a ``torch.Generator`` seeded with ``seed``."""
    rng = random.Random(seed ^ 0x9E3779B9)
    K, Lt = -(-entropy_bits // c), 1 << c
    rows = []
    for _ in range(K):
        base = oracle.random(rng)
        row = [oracle.zero]
        for _ in range(1, Lt):
            row.append(oracle.add(row[-1], base))
        rows.append(row)
    picks = torch.randint(0, Lt, (K, N), generator=torch.Generator().manual_seed(seed),
                          dtype=torch.int64)
    return rows, picks


def _gather_picks(table, picks):
    """Each table leaf (.., K * 2^c) gathered at the flat picks -> (.., K, N),
    one index vector for all leaves."""
    K, N = picks.shape
    Lt = table[0].shape[-1] // K
    flat = (picks + torch.arange(K)[:, None] * Lt).reshape(-1).to(table[0].device)
    return [a.index_select(-1, flat).reshape(a.shape[:-1] + (K, N)) for a in table]


def _pad_target(N: int, multiple: int = 1) -> int:
    """N padded up to a power of two, at least 8, then up to a multiple of
    ``multiple`` (the mesh size). For a power-of-two ``multiple`` this is the
    JAX package's target; for others (3, 6, ...) the JAX loop, which doubles
    until the target divides by it, never ends."""
    target = 8
    while target < N:
        target *= 2
    return -(-target // multiple) * multiple


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


class Weierstrass:
    """Curve module for a short-Weierstrass curve with a GLV endomorphism."""

    _instances: dict = {}

    def __init__(self, params: WeierstrassParams, w: int = 12):
        self.params = params
        self.ops = WeierstrassOps(params, w)
        self.scalar = make_glv_scalar(params.order, params.lambda_, w)
        self.simple_scalar = SimpleScalar(params.order, w)
        self.oracle = AffineCurve(params)
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

    def _pad(self, scalars, points: AffinePoints, multiple: int = 1):
        """Pad N up to a power of two (>= 8), then to a multiple of
        ``multiple``; padding points are infinity with zero scalars (no
        contribution)."""
        N = points.x.shape[-1]
        pad = _pad_target(N, multiple) - N
        if not pad:
            return scalars, points
        pad2 = lambda a, value=0: torch.nn.functional.pad(a, (0, pad), value=value)
        return pad2(scalars), AffinePoints(pad2(points.x), pad2(points.y), pad2(points.inf, 1))

    @property
    def ops51(self) -> Fma51WeierstrassOps:
        """Curve ops on 51x5 pair-row storage (``Fma51Codec``): only for
        p < 2^255 - 2^206."""
        if getattr(self, "_ops51", None) is None:
            if self.params.modulus >= FMA51_BOUND:
                raise ValueError(
                    f"mode='fma51' needs p < 2^255 - 2^206 (the 51x5 layout's 255-bit ceiling); "
                    f"{self.label}'s p has {self.params.modulus.bit_length()} bits. Of the curves "
                    "supported, only Pallas fits it; use mode='packed' for any p"
                )
            self._ops51 = Fma51WeierstrassOps(self.params)
        return self._ops51

    @property
    def ops_packed(self) -> PackedWeierstrassOps:
        """Curve ops on dense 31-bit-row storage (``PackedCodec``, any p):
        the engine's gathers and trees move ~2.5x fewer bytes."""
        if getattr(self, "_ops_packed", None) is None:
            self._ops_packed = PackedWeierstrassOps(self.params)
        return self._ops_packed

    def _codec_ops(self, mode: str):
        return self.ops51 if mode == "fma51" else self.ops_packed

    def _msm(self, scalars, points: AffinePoints, c, safe: bool, mode: str,
             mesh) -> ProjectivePoints:
        scalars, points = self._pad(scalars, points, _mesh_size(mesh))

        def run(W, pts, mode):
            if mesh is None:
                return msm_batched_affine(W, self.scalar, scalars, pts, c, safe=safe, mode=mode)
            return mesh_mod.msm_batched_affine_sharded(W, self.scalar, mesh, scalars, pts, c,
                                                       safe=safe, mode=mode)

        if mode not in CODEC_MODES:
            return run(self.ops, points, mode)
        # the codec modes: the projective pipeline with coordinates in the
        # codec's rows, converted on the way in and out
        Wc = self._codec_ops(mode)
        pts = AffinePoints(Wc.from_native(points.x), Wc.from_native(points.y), points.inf)
        return ProjectivePoints(*(Wc.to_native(a) for a in run(Wc, pts, "projective")))

    def msm(self, scalars, points: AffinePoints, c: int | None = None,
            mode: str = "projective", mesh=None) -> ProjectivePoints:
        """Safe MSM (duplicate points allowed): scalars (n, N) limbs, points
        an affine batch of N, on one device. mode: "projective" (the
        default), "affine" (batched-affine adds), "halving", or a codec
        storage mode, "packed" or "fma51" (the projective pipeline on row
        storage). The result is in the native layout in every mode.

        With ``mesh`` (``parallel.mesh.make_mesh`` / ``make_mesh2``), every
        rank passes the same inputs, N is padded to a multiple of the mesh
        size, and each rank returns the whole result; on a mesh
        ``"halving"`` takes the affine mode's accumulation, as in the JAX
        package."""
        return self._msm(scalars, points, c, True, mode, mesh)

    def msm_unsafe(self, scalars, points: AffinePoints, c: int | None = None,
                   mode: str = "projective", mesh=None) -> ProjectivePoints:
        """The msmUnsafe entry point: assumes all effective points distinct,
        which only the affine mode exploits (its adds then skip the doubling
        and cancellation masks); the complete adds of the other modes make
        it the safe path. ``mesh`` as in ``msm``."""
        return self._msm(scalars, points, c, False, mode, mesh)

    def msm_projective(self, scalars, points: ProjectivePoints,
                       c: int | None = None) -> ProjectivePoints:
        """MSM on projective inputs (no GLV, the halving engine on complete
        adds): scalars (n, N) limbs, points a projective batch of N."""
        return msm_basic_projective(self.ops, scalars, points, self.simple_scalar.bits, c)

    def msm_bigint(self, scalars, points, device=DEVICE, c: int | None = None):
        """Python ints in, affine int point out."""
        s = self.scalars_from_ints(scalars, device)
        p = self.points_from_ints(points, device)
        return self.result_to_int(self.msm(s, p, c))

    def random_scalars(self, N: int, seed: int = 0, device=DEVICE) -> torch.Tensor:
        """Uniform scalars in [0, q): the JAX package's limbs for the seed."""
        return _random_scalars(self.params.order, self.scalar, N, seed, device)

    def random_points_table(self, N: int, seed: int = 0, entropy_bits: int = 64, c: int = 8):
        """The host half of ``random_points_fast``: (rows, picks), output
        point i being the sum over k of rows[k][picks[k, i]] (affine int
        tuples, None = infinity)."""
        return _table_and_picks(self.oracle, N, seed, entropy_bits, c)

    def random_points_fast(self, N: int, seed: int = 0, entropy_bits: int = 64, c: int = 8,
                           device=DEVICE) -> AffinePoints:
        """Fast non-hiding random points in the prime-order subgroup: each is
        the sum of one pick from each of K = ceil(entropy_bits / c) tables of
        2^c multiples of a random base. The tables are built on the host
        (``random_points_table``); the device does one gather per
        coordinate, K - 1 mixed adds (K7) and one batch normalization
        (``to_affine``: K1 and one K8).

        The bases equal the JAX package's for the same seed; the picks come
        from a ``torch.Generator``, not JAX's threefry stream, so the points
        differ from the JAX package's."""
        return self.points_from_table(*self.random_points_table(N, seed, entropy_bits, c), device)

    def points_from_table(self, rows, picks, device=DEVICE) -> AffinePoints:
        """``random_points_fast``'s device half: point i is the sum over k of
        rows[k][picks[k, i]] (one gather, K - 1 K7, ``to_affine``)."""
        W = self.ops
        x, y, inf = _gather_picks(W.pack_affine([P for row in rows for P in row], device), picks)
        acc = W.from_affine(AffinePoints(x[:, 0], y[:, 0], inf[0]))
        for k in range(1, picks.shape[0]):
            acc = W.proj_add_affine(acc, AffinePoints(x[:, k], y[:, k], inf[k]))
        return W.to_affine(acc)


class TwistedEdwards:
    """Curve module for a twisted-Edwards curve (a = -1)."""

    _instances: dict = {}

    def __init__(self, params: EdwardsParams, w: int = 12):
        self.params = params
        self.ops = EdwardsOps(params, w)
        self.scalar = SimpleScalar(params.order, w)
        self.oracle = EdwardsCurve(params)
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

    def _pad(self, scalars, points: ExtPoints, multiple: int = 1):
        """Pad N up to a power of two (>= 8), then to a multiple of
        ``multiple``; padding points are the identity (0, 1, 1, 0) with zero
        scalars."""
        N = points.X.shape[-1]
        pad = _pad_target(N, multiple) - N
        if not pad:
            return scalars, points
        zero = self.ops.zeros(pad, device=points.X.device)
        scalars = torch.nn.functional.pad(scalars, (0, pad))
        return scalars, ExtPoints(*(torch.cat([a, z], dim=-1) for a, z in zip(points, zero)))

    def msm(self, scalars, points: ExtPoints, c: int | None = None,
            mode: str = "padded", mesh=None) -> ExtPoints:
        """MSM (duplicate points allowed): scalars (n, N) limbs, points an
        extended batch of N, on one device. mode: "padded" (the default) or
        "basic" (the halving engine). ``mesh`` as in ``Weierstrass.msm``."""
        scalars, points = self._pad(scalars, points, _mesh_size(mesh))
        if mesh is not None:
            return mesh_mod.msm_edwards_sharded(self.ops, mesh, scalars, points,
                                                self.scalar.bits, c, mode=mode)
        return msm_basic_edwards(self.ops, scalars, points, self.scalar.bits, c, mode=mode)

    def msm_unsafe(self, scalars, points: ExtPoints, c: int | None = None,
                   mode: str = "padded", mesh=None) -> ExtPoints:
        """The msmUnsafe entry point: the unified add is complete, so it is
        the safe path."""
        return self.msm(scalars, points, c, mode, mesh)

    def msm_bigint(self, scalars, points, device=DEVICE, c: int | None = None):
        """Python ints in, affine int point out."""
        s = self.scalars_from_ints(scalars, device)
        p = self.points_from_ints(points, device)
        return self.result_to_int(self.msm(s, p, c))

    def random_scalars(self, N: int, seed: int = 0, device=DEVICE) -> torch.Tensor:
        """Uniform scalars in [0, q): the JAX package's limbs for the seed."""
        return _random_scalars(self.params.order, self.scalar, N, seed, device)

    def random_points_table(self, N: int, seed: int = 0, entropy_bits: int = 64, c: int = 8):
        """The host half of ``random_points_fast``: (rows, picks), output
        point i being the sum over k of rows[k][picks[k, i]] (extended int
        tuples)."""
        return _table_and_picks(self.oracle, N, seed, entropy_bits, c)

    def random_points_fast(self, N: int, seed: int = 0, entropy_bits: int = 64, c: int = 8,
                           device=DEVICE) -> ExtPoints:
        """Fast non-hiding random points in the prime-order subgroup, as
        ``Weierstrass.random_points_fast``: host tables, then on the device
        one gather per coordinate, K - 1 unified adds (K11) and
        ``batch_normalize`` (K1 and one K8). The bases equal the JAX
        package's for the same seed; the picks come from a
        ``torch.Generator``, so the points differ from the JAX package's."""
        return self.points_from_table(*self.random_points_table(N, seed, entropy_bits, c), device)

    def points_from_table(self, rows, picks, device=DEVICE) -> ExtPoints:
        """``random_points_fast``'s device half: point i is the sum over k of
        rows[k][picks[k, i]] (one gather, K - 1 K11, ``batch_normalize``)."""
        E = self.ops
        picked = _gather_picks(E.pack([P for row in rows for P in row], device), picks)
        acc = ExtPoints(*(a[:, 0] for a in picked))
        for k in range(1, picks.shape[0]):
            acc = E.add(acc, ExtPoints(*(a[:, k] for a in picked)))
        return E.batch_normalize(acc)
