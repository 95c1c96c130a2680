"""Shared MSM machinery: window sizing, bucket sort, bucket counts and the
halving engine's pair layout.

Mirror of ``msm_zprize_tpu/msm/common.py``. The window table is the JAX
package's, kept for parity; counts are a scatter-add histogram (the JAX
compare-reduce formulation is a TPU workaround). ``halving_layout`` derives
each halving level's pair positions from the bucket counts with run-length
fills (scatter-min/max, then a cumulative min/max along the row), as the
JAX package does, so the layouts are bit-identical.
"""

from __future__ import annotations

import torch

__all__ = ["window_size", "default_windows", "sort_by_bucket", "bucket_counts", "halving_layout"]

I32 = torch.int32
INT32_MAX = 2**31 - 1


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


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=I32)


def _fill_runs(vals, starts, width: int, kind: str):
    """Run-length fill: output slot s of row k gets vals[k, b] where b is the
    bucket owning slot s, b = max{l : starts[k, l] <= s}.

    Scatters vals at their run starts and completes the row with a
    cumulative min ("min") or max ("max"); valid when vals are
    non-increasing ("min") or non-decreasing ("max") in l, so that the
    owner's value is the extremum among colliding run starts (an empty run
    shares its start with its successor)."""
    K = vals.shape[0]
    pos = torch.clamp(starts, max=width - 1).long()
    fill, reduce = (INT32_MAX, "amin") if kind == "min" else (-1, "amax")
    vals = torch.where(starts < width, vals, fill)
    grid = torch.full((K, width), fill, dtype=I32, device=vals.device)
    grid.scatter_reduce_(1, pos, vals, reduce, include_self=True)
    return (torch.cummin if kind == "min" else torch.cummax)(grid, dim=1).values


def halving_layout(counts, width: int, cur_width: int):
    """Pair positions for one compacted halving level.

    counts: (K, L) per-bucket element counts over the current level's packed
    rows (bucket b occupies [cur_off[b], cur_off[b] + counts[b])); width:
    static output width (>= max sum of ceil(counts / 2)); cur_width: the
    current level's width. Slot s of the next level holds the pair sum of
    current positions (pos0, pos0 + 1) of its owning bucket:

        pos0[s] = cur_off[b] + 2 (s - next_off[b]) = 2 s + adj[b],
                  adj = cur_off - 2 next_off        (non-increasing: min-fill)
        partner = pos0 + 1 < end[b], end = cur_off + counts
                                                    (non-decreasing: max-fill)

    Returns (pos0, has_partner, valid, next_counts), (K, width) each but
    next_counts (K, L); int32 positions, bool masks."""
    next_counts = (counts + 1) >> 1  # ceil(c / 2)
    next_off = _cumsum(next_counts) - next_counts
    cur_off = _cumsum(counts) - counts
    totals = next_off[:, -1] + next_counts[:, -1]
    slots = torch.arange(width, dtype=I32, device=counts.device)[None, :]
    adj = _fill_runs(cur_off - 2 * next_off, next_off, width, "min")
    end = _fill_runs(cur_off + counts, next_off, width, "max")
    pos0 = 2 * slots + adj
    valid = slots < totals[:, None]
    has_partner = (pos0 + 1 < end) & valid
    return torch.clamp(pos0, 0, cur_width - 1), has_partner, valid, next_counts
