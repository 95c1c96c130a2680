"""Carry inputs made by the JAX package over to the port.

The two packages share one layout ((n, B) int32 limbs, w = 12, Montgomery
coordinates; or (rows, B) int32 rows of a row codec), so this is a checked
copy: arrays arrive as numpy (callers pass ``np.asarray(jax_array)``), their
dtype, shape and limb or row range are verified, and they land on the
requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.edwards import ExtPoints
from ..curves.weierstrass import AffinePoints, ProjectivePoints

__all__ = [
    "affine_from_jax", "affine_rows_from_jax", "proj_from_jax", "ext_from_jax", "scalars_from_jax",
]


def _limbs(arr, n: int, w: int, name: str) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype != np.int32 or a.ndim != 2 or a.shape[0] != n:
        raise ValueError(f"{name}: expected int32 ({n}, B), got {a.dtype} {a.shape}")
    if a.size and (a.min() < -1 or a.max() > (1 << w)):
        raise ValueError(f"{name}: limbs outside [-1, 2^{w}]")
    return a


def _points(xs, ys, inf, device) -> AffinePoints:
    fl = np.asarray(inf)
    if fl.dtype != np.int32 or fl.shape != (xs.shape[1],) or ys.shape != xs.shape:
        raise ValueError(f"inconsistent point leaves: x {xs.shape}, y {ys.shape}, inf {fl.dtype} {fl.shape}")
    if not np.isin(fl, (0, 1)).all():
        raise ValueError("inf flags must be 0 or 1")
    return AffinePoints(*(torch.as_tensor(np.array(a), device=device) for a in (xs, ys, fl)))


def affine_from_jax(x, y, inf, field, device) -> AffinePoints:
    """JAX ``AffinePoints`` leaves (as numpy) -> the port's AffinePoints."""
    return _points(_limbs(x, field.n, field.w, "x"), _limbs(y, field.n, field.w, "y"), inf, device)


def _rows(arr, codec, name: str) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype != np.int32 or a.ndim != 2 or a.shape[0] != codec.rows:
        raise ValueError(f"{name}: expected int32 ({codec.rows}, B), got {a.dtype} {a.shape}")
    widths = np.array(codec.widths, dtype=np.int64)[:, None]
    if a.size and ((a < 0).any() or (a >= (1 << widths)).any()):
        raise ValueError(f"{name}: rows outside [0, 2^width) of {type(codec).__name__}")
    return a


def affine_rows_from_jax(x, y, inf, codec, device) -> AffinePoints:
    """JAX ``AffinePoints`` leaves on row-codec storage (as numpy; the
    ``weierstrass51`` ops' ``pack_affine``) -> the port's AffinePoints."""
    return _points(_rows(x, codec, "x"), _rows(y, codec, "y"), inf, device)


def _coords(arrs, names: str, field, device) -> list[torch.Tensor]:
    """Coordinate leaves of one shape, checked, on the device."""
    leaves = [_limbs(a, field.n, field.w, name) for a, name in zip(arrs, names)]
    if len({a.shape for a in leaves}) != 1:
        raise ValueError(f"inconsistent point leaves: {[a.shape for a in leaves]}")
    return [torch.as_tensor(np.array(a), device=device) for a in leaves]


def proj_from_jax(X, Y, Z, field, device) -> ProjectivePoints:
    """JAX ``ProjectivePoints`` leaves (as numpy) -> the port's ProjectivePoints."""
    return ProjectivePoints(*_coords((X, Y, Z), "XYZ", field, device))


def ext_from_jax(X, Y, Z, T, field, device) -> ExtPoints:
    """JAX ``ExtPoints`` leaves (as numpy) -> the port's ExtPoints."""
    return ExtPoints(*_coords((X, Y, Z, T), "XYZT", field, device))


def scalars_from_jax(arr, scalar, device) -> torch.Tensor:
    """JAX scalar limbs (as numpy) -> the port's scalar tensor."""
    s = _limbs(arr, scalar.n, scalar.w, "scalars")
    if s.size and s.max() >= (1 << scalar.w):
        raise ValueError("scalar limbs must be canonical")
    return torch.as_tensor(np.array(s), device=device)
