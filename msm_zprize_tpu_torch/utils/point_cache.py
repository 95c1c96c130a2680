"""Benchmark input points: a legacy npz cache, read if valid, else
regenerated.

Mirror of ``msm_zprize_tpu/utils/point_cache.py``: ``cached_random_points
(curve, N, seed)`` loads ``.bench_cache/pts_<label>_<N>_<seed>.npz`` (the
directory ``MSM_TPU_POINT_CACHE`` names, else ``.bench_cache/`` at the
repository root) only if a head slice of it lies on the curve by the port's
bigint oracle (``bigint/``'s ``is_on_curve``); otherwise, or where the file
cannot be read, it draws ``curve.random_points_fast(N, seed)``. Like the JAX
package, it writes no new cache.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

__all__ = ["cached_random_points", "CACHE_DIR"]

CACHE_DIR = os.environ.get(
    "MSM_TPU_POINT_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".bench_cache"),
)


def _valid_head(curve, pt_type, leaves) -> bool:
    """Whether the first 8 points of the file's arrays lie on the curve."""
    from ..curves.weierstrass import AffinePoints

    head = pt_type(*(torch.as_tensor(a[..., :8]) for a in leaves))
    if pt_type is AffinePoints:
        return all(curve.oracle.is_on_curve(p) for p in curve.ops.unpack_affine(head))
    return all(curve.oracle.is_on_curve(p) for p in curve.ops.unpack(head))


def cached_random_points(curve, N: int, seed: int, device="cuda"):
    """Deterministic benchmark points for (curve, N, seed) on ``device``:
    AffinePoints for a Weierstrass curve, ExtPoints for an Edwards one."""
    from ..curves.edwards import ExtPoints
    from ..curves.weierstrass import AffinePoints

    path = os.path.join(CACHE_DIR, f"pts_{curve.label}_{N}_{seed}.npz")
    pt_type = AffinePoints if hasattr(curve.ops, "affine_is_on_curve") else ExtPoints
    if os.path.exists(path):
        try:
            with np.load(path) as data:
                leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
            if len(leaves) == len(pt_type._fields) and _valid_head(curve, pt_type, leaves):
                return pt_type(*(torch.as_tensor(a, device=device) for a in leaves))
        except (OSError, ValueError, KeyError, IndexError, TypeError, RuntimeError,
                zipfile.BadZipFile):
            pass  # an unreadable or stale file: regenerate
    return curve.random_points_fast(N, seed=seed, device=device)
