"""Shared MSM machinery: window sizing, bucket sort and bucket counts.

Mirror of ``msm_zprize_tpu/msm/common.py`` for the padded engine. The
window table is the JAX package's, kept for parity in the first slice;
counts are a scatter-add histogram (the JAX compare-reduce formulation is a
TPU workaround).
"""

from __future__ import annotations

import torch

__all__ = ["window_size", "default_windows", "sort_by_bucket", "bucket_counts"]


def window_size(curve_kind: str, log_n: int) -> int:
    """Window size c per curve type and log2(point count) (the JAX table)."""
    if curve_kind == "batched-affine":
        table = {8: 6, 10: 8, 12: 10, 14: 11, 16: 12, 18: 13, 20: 13, 22: 14}
    else:
        table = {8: 6, 10: 7, 12: 9, 14: 10, 16: 11, 18: 12, 20: 12, 22: 13}
    if log_n <= 8:
        return 6
    for k in sorted(table):
        if log_n <= k:
            return table[k]
    return table[max(table)]


def default_windows(scalar_bits: int, c: int) -> int:
    """Number of c-bit signed windows covering scalar_bits (+1 carry bit)."""
    return -(-(scalar_bits + 1) // c)


def sort_by_bucket(ids: torch.Tensor, payload: torch.Tensor):
    """Sort bucket-id rows (K, B), carrying a per-point payload along.
    Returns (sorted payload, sorted_ids). Unstable: bucket contents may pair
    in any order, which curve addition does not care about."""
    sorted_ids, perm = torch.sort(ids, dim=1)
    return torch.gather(payload, 1, perm), sorted_ids


def bucket_counts(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Per-row histogram of ids in [0, n_buckets] -> (K, n_buckets + 1) int32."""
    K = ids.shape[0]
    n_out = n_buckets + 1
    counts = torch.zeros((K, n_out), dtype=torch.int32, device=ids.device)
    return counts.scatter_add_(1, ids.long(), torch.ones_like(ids, dtype=torch.int32))
