"""Run and time one MSM of the port: the twin of the JAX package's
``scripts/run_msm.py``.

    python3 -m msm_zprize_tpu_torch.scripts.run_msm <curve> <logN> [--device cuda|cpu]
        [--mode M] [--c C] [--runs R] [--warmup W] [--evaluate] [--verbose]
        [--amortize R] [--devices D] [--points random|logs]

curve: bls12-377 | bls12-381 | pallas | ed-on-bls12-377. Fixed points
(``utils/point_cache.py``: a valid legacy npz, else ``random_points_fast``
with seed 1; or, with ``--points logs``, points of known discrete logs made
the same way on the device, ``testing/points.py::table_points_with_logs``)
and fresh scalars a run (``random_scalars`` with seed = the run); W warmups, then the median +- sigma of R timed runs, each
between two synchronisations, and the peak device memory. The result is
held against the bigint Pippenger oracle (``bigint/msm.py``) for logN < 14
or with ``--evaluate``, and, with ``--points logs``, against the known-log
sum at any logN. ``--verbose`` prints the phase table (``utils/phases.py``;
Weierstrass, projective). ``--amortize R`` also times R MSMs issued back to
back on R scalar sets with one synchronisation at the end, divided by R
(the JAX tool's ``lax.scan`` dispatch). ``--devices D`` runs the sharded MSM
on D ranks (``parallel/launch.spawn``, one process a rank: NCCL with a card
a rank, gloo on the CPU), as ``scaling_bench`` does.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..bigint.edwards import EdwardsCurve
from ..bigint.msm import msm as msm_oracle
from ..bigint.weierstrass import ProjectiveCurve
from ..testing.points import table_points_with_logs
from ..utils.point_cache import cached_random_points
from .common import CURVES, WEIERSTRASS, device_of, make_curve, stats, sync, wall_ms

__all__ = ["main", "oracle_result"]


def oracle_result(curve, scalars, points):
    """The bigint Pippenger result of an MSM's device inputs, affine ints."""
    scs = curve.scalar.unpack(scalars)
    if hasattr(curve.ops, "affine_is_on_curve"):
        C = ProjectiveCurve(curve.params)
        pts = [C.from_affine(p) for p in curve.ops.unpack_affine(points)]
    else:
        C = EdwardsCurve(curve.params)
        pts = curve.ops.unpack(points)
    return C.to_affine(msm_oracle(C, scs, pts, curve.scalar.bits))


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("curve", choices=list(CURVES))
    ap.add_argument("logN", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=1, help="mesh size (1: no mesh)")
    ap.add_argument("--mode", default=None,
                    choices=["affine", "projective", "halving", "fma51", "packed", "padded", "basic"])
    ap.add_argument("--c", type=int, default=None, help="window size override")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--evaluate", action="store_true", help="always cross-check the oracle")
    ap.add_argument("--amortize", type=int, default=0, metavar="R")
    ap.add_argument("--verbose", action="store_true", help="the phase table (Weierstrass)")
    ap.add_argument("--points", default="random", choices=["random", "logs"])
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    if args.devices > 1:
        from .scaling_bench import run_mesh

        return run_mesh(args.curve, args.logN, [args.devices], device.type, runs=args.runs,
                        warmup=args.warmup, mode=args.mode, c=args.c)[0]
    curve = make_curve(args.curve)
    N = 1 << args.logN
    kwargs = {"c": args.c} if args.mode is None else {"c": args.c, "mode": args.mode}
    print(f"[{args.curve}] N=2^{args.logN}, device={device}", file=sys.stderr)
    expected = None
    if args.points == "logs":
        points, expected = table_points_with_logs(curve, N, 1, device)
    else:
        points = cached_random_points(curve, N, seed=1, device=device)
    sync(device)
    sets = [curve.random_scalars(N, seed=run, device=device) for run in range(args.warmup + args.runs)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times, result = [], None
    for run, scalars in enumerate(sets):
        dt, result = wall_ms(lambda: curve.msm(scalars, points, **kwargs), device)
        if run >= args.warmup:
            times.append(dt)
        print(f"  run {run}: {dt:.3f} ms", file=sys.stderr, flush=True)
    med, std = stats(times)
    out = {"curve": args.curve, "logN": args.logN, "median_ms": med, "std_ms": std,
           "runs_ms": times, "result": curve.result_to_int(result),
           "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None}
    print(f"msm {args.curve} 2^{args.logN}: {med:.3f} +- {std:.3f} ms ({med / N * 1e6:.0f} ns/point)"
          + (f"; peak device memory {out['peak_bytes'] / 2**30:.2f} GiB" if out["peak_bytes"] else ""))

    if args.amortize:
        R = args.amortize
        stacks = [[curve.random_scalars(N, seed=1000 + r * R + i, device=device) for i in range(R)]
                  for r in range(args.warmup + args.runs)]
        amor = []
        for r, stack in enumerate(stacks):
            dt, _ = wall_ms(lambda: [curve.msm(s, points, **kwargs) for s in stack], device)
            if r >= args.warmup:
                amor.append(dt / R)
        out["amortized_ms"], out["amortized_std_ms"] = stats(amor)
        print(f"msm {args.curve} 2^{args.logN} amortized ({R} back to back, one sync): "
              f"{out['amortized_ms']:.3f} +- {out['amortized_std_ms']:.3f} ms/msm")

    if args.verbose and args.curve in WEIERSTRASS:
        from ..utils.phases import print_phase_table, profile_msm

        rows = profile_msm(curve, sets[0], points, c=args.c)
        print_phase_table(rows, N)
        out["phases"] = [(r.label, r.ms, r.mmuls) for r in rows]

    last = sets[-1]
    if expected is not None:
        if out["result"] != expected(last):
            raise AssertionError("MSM mismatch vs the known-discrete-log sum")
        out["checked"] = ["known logs"]
        print("known-discrete-log check: OK", file=sys.stderr)
    if args.evaluate or args.logN < 14:
        if out["result"] != oracle_result(curve, last, points):
            raise AssertionError("MSM mismatch vs the bigint oracle")
        out.setdefault("checked", []).append("bigint oracle")
        print("oracle cross-check: OK", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
