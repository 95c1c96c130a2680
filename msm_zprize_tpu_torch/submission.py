"""ZPrize-style entry point: ``compute_msm(points, scalars)``.

Mirror of ``msm_zprize_tpu/submission.py`` (the reference's submission
shims, ``scripts/zprize23/submission.ts``, ``submission-bls377.ts``):

* points as affine int pairs ``(x, y)``, pairs of little-endian bytes, or
  ``None`` (infinity); scalars as ints, little-endian bytes, or a (N, nbytes)
  uint8 array;
* repeated points choose the safe MSM (the reference's same-point check),
  distinct ones ``msm_unsafe``; ``mode=`` is passed through;
* the result is an affine int pair, or ``None`` for infinity.

Tensors go to ``device`` ("cuda" unless the caller asks for "cpu"). With
``mesh=`` (``parallel.mesh``; every rank calls with the same inputs) the MSM
is sharded over the mesh's ranks, and every rank returns the result.
"""

from __future__ import annotations

import functools

import numpy as np

from .curves.params import BLS12_377, WeierstrassParams
from .fields.bytes_codec import bytes_to_ints
from .parallel.api import DEVICE, Weierstrass

__all__ = ["compute_msm", "make_compute_msm"]


def _to_int_scalars(scalars) -> list[int]:
    if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint8:
        return bytes_to_ints(scalars)
    if len(scalars) and isinstance(scalars[0], (bytes, bytearray)):
        return [int.from_bytes(s, "little") for s in scalars]
    return [int(s) for s in scalars]


def _to_int_points(points) -> list:
    out = []
    for P in points:
        if P is None:
            out.append(None)
        elif isinstance(P, (tuple, list)):
            x, y = P
            if isinstance(x, (bytes, bytearray)):
                x, y = int.from_bytes(x, "little"), int.from_bytes(y, "little")
            out.append((int(x), int(y)))
        else:
            raise TypeError(f"unsupported point encoding: {type(P)}")
    return out


def _pick_msm(curve, pts: list):
    """The same-point check: repeated finite points choose the safe msm (the
    projective modes are complete either way; the affine mode's unsafe adds
    need distinct points)."""
    finite = [q for q in pts if q is not None]
    return curve.msm if len(set(finite)) != len(finite) else curve.msm_unsafe


@functools.cache
def make_compute_msm(params: WeierstrassParams = BLS12_377, mesh=None, device=DEVICE):
    """A compute_msm closure for one curve (and an optional device mesh),
    its tensors on ``device``."""
    curve = Weierstrass.create(params)

    def compute_msm(points, scalars, mode: str = "projective"):
        if len(points) != len(scalars):
            raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
        if len(points) == 0:
            return None
        pts = _to_int_points(points)
        s = curve.scalars_from_ints(_to_int_scalars(scalars), device)
        p = curve.points_from_ints(pts, device)
        return curve.result_to_int(_pick_msm(curve, pts)(s, p, mode=mode, mesh=mesh))

    return compute_msm


def compute_msm(points, scalars, mode: str = "projective", device=DEVICE, mesh=None):
    """BLS12-377 MSM of int or byte inputs -> an affine int pair or None."""
    return make_compute_msm(BLS12_377, mesh, device)(points, scalars, mode)
