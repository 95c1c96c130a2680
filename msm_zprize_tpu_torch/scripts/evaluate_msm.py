"""The window sweep: the MSM timed at window sizes c around the table's
(``msm/common.py::window_size``), the twin of the JAX package's
``scripts/evaluate_msm.py``.

    python3 -m msm_zprize_tpu_torch.scripts.evaluate_msm [curve] [logN]
        [--cmin C] [--cmax C] [--runs R] [--device cuda|cpu]

Fixed points (``random_points_fast``, seed 1) and fresh scalars a round
(seeds 10, 11, ...). The c values run in turns: two untimed rounds over
every c, then R timed rounds, ascending and descending in alternation, so
that a drift of the host or the card over the sweep falls on every c alike;
each run lies between two synchronisations. It prints each c's median and
sigma, marks the table's, and the best. It only records: the table (tuned
on the TPU) is left as it is.
"""

from __future__ import annotations

import argparse
import sys

from ..msm.common import window_size
from .common import CURVES, WEIERSTRASS, device_of, make_curve, stats, wall_ms

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("curve", nargs="?", default="bls12-377", choices=list(CURVES))
    ap.add_argument("logN", nargs="?", type=int, default=14)
    ap.add_argument("--cmin", type=int, default=None)
    ap.add_argument("--cmax", type=int, default=None)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    curve = make_curve(args.curve)
    N = 1 << args.logN
    c_default = window_size("batched-affine" if args.curve in WEIERSTRASS else "edwards", args.logN)
    cmin = args.cmin or max(4, c_default - 2)
    cmax = args.cmax or c_default + 2
    points = curve.random_points_fast(N, seed=1, device=device)
    sets = [curve.random_scalars(N, seed=10 + r, device=device) for r in range(args.runs + 1)]
    cs = list(range(cmin, cmax + 1))
    for _warm in range(2):  # untimed: each c's allocations and first launches
        for c in cs:
            first, _ = wall_ms(lambda: curve.msm(sets[0], points, c=c), device)
            print(f"[c={c}] untimed run {first:.1f} ms", file=sys.stderr)
    times = {c: [] for c in cs}
    for r, scalars in enumerate(sets[1:]):
        for c in cs if r % 2 == 0 else cs[::-1]:
            times[c].append(wall_ms(lambda: curve.msm(scalars, points, c=c), device)[0])
    table = {c: stats(times[c]) for c in cs}
    for c in cs:
        star = " *default" if c == c_default else ""
        print(f"c={c:2d}: {table[c][0]:9.3f} ms (sigma {table[c][1]:.3f}){star}", flush=True)
    best = min(table, key=lambda c: table[c][0])
    print(f"best: c={best} ({table[best][0]:.3f} ms); the table's c={c_default}")
    return {"curve": args.curve, "logN": args.logN, "default": c_default, "best": best,
            "table": table}


if __name__ == "__main__":
    main()
