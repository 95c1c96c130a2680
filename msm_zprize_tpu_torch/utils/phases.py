"""Per-stage MSM profiling and analytic Montgomery-product counts.

Mirror of ``msm_zprize_tpu/utils/phases.py`` (``PhaseRow``,
``profile_msm``, ``print_phase_table``) for the projective pipeline of a
Weierstrass curve, and the stage timing that ``profile_msm.py`` prints for
both curve families (``stage_times``). Each stage runs on its own between
two synchronisations and is timed by a CUDA event pair on the card (the
host clock on the CPU), the median of ``reps`` runs after one untimed:

* prep: ``glv_prep`` (GLV split and signed digits, K2; beta x, K1), or the
  Edwards ``edwards_prep``;
* accumulation, its prep included (``accumulate_glv_projective``, or the
  padded Edwards accumulation);
* the log-depth bucket reduction (``engine.reduce_buckets_log``);
* Horner (``engine.horner``).

The product counts are the JAX module's, formula for formula: the engine's
static shapes give the Montgomery products each phase issues. The JAX
prefix-jit and its RPC subtraction are TPU workarounds and are not ported:
the stages here are separate calls.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from typing import NamedTuple

import torch

from ..msm import basic, batched_affine, engine
from ..msm.common import default_windows, window_size

__all__ = ["PhaseRow", "profile_msm", "print_phase_table", "stage_times", "timed_ms", "mul_counts"]


class PhaseRow(NamedTuple):
    label: str
    ms: float
    mmuls: float  # analytic Montgomery products, millions

    @property
    def ns_per_mul(self) -> float:
        return self.ms * 1e6 / (self.mmuls * 1e6) if self.mmuls else 0.0


def timed_ms(fn, device, reps: int = 10):
    """Median ms of fn() between two synchronisations over ``reps`` runs
    after one untimed, and its last result: CUDA events on a CUDA device,
    the host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    times, out = [], None
    for _ in range(reps + 1):
        if cuda:
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:]), out


def stage_times(cv, scalars, points, c: int, reps: int = 10) -> dict:
    """Stage times in ms of one MSM of curve ``cv`` (a ``Weierstrass``, the
    projective pipeline, or a ``TwistedEdwards``, the padded one) at window
    c: prep, accumulation (prep included), bucket reduction, Horner."""
    device = scalars.device
    if hasattr(cv.ops, "affine_is_on_curve"):
        prep = lambda: batched_affine.glv_prep(cv.ops, cv.scalar, scalars, points, c)
        acc = lambda: batched_affine.accumulate_glv_projective(cv.ops, cv.scalar, scalars, points, c)
        ops = batched_affine._ProjAcc(cv.ops, device)
    else:
        bits = cv.scalar.bits
        prep = lambda: basic.edwards_prep(cv.ops, scalars, points, bits, c)
        acc = lambda: basic.accumulate_edwards_padded(cv.ops, scalars, points, bits, c)
        ops = basic._EdAcc(cv.ops, device)
    out = {"prep": timed_ms(prep, device, reps)[0]}
    out["accumulation (prep included)"], sums = timed_ms(acc, device, reps)
    c0 = max((c - 1) // 2, 1)
    out["bucket reduction"], per_window = timed_ms(
        lambda: engine.reduce_buckets_log(sums, c0, ops), device, reps)
    out["horner"], _ = timed_ms(lambda: engine.horner(per_window, c, ops.add, ops.double_k),
                                device, reps)
    return out


def mul_counts(N: int, max_bits: int, c: int) -> dict:
    """The JAX module's analytic Montgomery products (millions) of the
    projective pipeline at N points, scalar halves of ``max_bits`` bits and
    window c: prep, accumulation, reduction plus Horner."""
    K = default_windows(max_bits, c)
    L = 1 << (c - 1)
    M = engine.slot_count(2 * N, L)
    slots = M * K * L
    m_l1 = 9 * (slots // 2) / 1e6  # the unit-Z level-1 kernel
    m_tree = 12 * (slots // 2 - K * L) / 1e6  # the tree's other levels
    m_acc_add = 12 * K * L / 1e6  # the round accumulator's add
    m_fold = 12 * (L // 2) * K * math.ceil(math.log2(max(L, 2))) / 1e6
    c0 = max((c - 1) // 2, 1)
    block = 1 << c0
    D = L // block
    m_reduce = (12 + 12) * block * K * D / 1e6 + 12 * (D + 2 * c0) * K / 1e6
    m_horner = (K - 1) * (8 * c + 12) / 1e6
    return {"prep": N / 1e6, "accumulation": m_l1 + m_tree + m_acc_add + m_fold,
            "finalize": m_reduce + m_horner}


def profile_msm(curve, scalars, points, c: int | None = None, reps: int = 3) -> list[PhaseRow]:
    """Stage-time the projective pipeline of a Weierstrass ``curve`` on the
    scalars' device: rows prep, bucket accumulation, reduce + Horner and
    their total, each with its analytic product count."""
    N = points.x.shape[-1]
    if c is None:
        c = window_size("batched-affine", max(N.bit_length() - 1, 1))
    t = stage_times(curve, scalars, points, c, reps)
    m = mul_counts(N, curve.scalar.max_bits, c)
    t_acc = max(t["accumulation (prep included)"] - t["prep"], 0.0)
    t_fin = t["bucket reduction"] + t["horner"]
    return [
        PhaseRow("prep (decompose+endo+digits)", t["prep"], m["prep"]),
        PhaseRow("bucket accumulation", t_acc, m["accumulation"]),
        PhaseRow("reduce + horner", t_fin, m["finalize"]),
        PhaseRow("TOTAL (stage-timed)", t["prep"] + t_acc + t_fin, sum(m.values())),
    ]


def print_phase_table(rows: list[PhaseRow], n_points: int, out=None):
    out = out or sys.stderr
    out.write(f"{'phase':34s} {'ms':>9s} {'Mmul':>8s} {'ns/mul':>8s}\n")
    for r in rows:
        out.write(f"{r.label:34s} {r.ms:9.3f} {r.mmuls:8.2f} {r.ns_per_mul:8.2f}\n")
    total = rows[-1]
    out.write(f"{'':34s} {total.ms / n_points * 1e6:.0f} ns/point over {n_points} points\n")
