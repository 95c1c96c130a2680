"""The sharded MSM's time against the mesh size: the twin of the JAX
package's ``scripts/scaling_bench.py``.

    python3 -m msm_zprize_tpu_torch.scripts.scaling_bench [curve] [logN]
        [--devices 1,2,4] [--backend nccl|gloo] [--device cuda|cpu] [--runs R]

For each mesh size d, d rank processes (``parallel/launch.spawn``) each run
``msm_unsafe(mode="projective", mesh=make_mesh())`` (the Edwards ``msm`` on
ed-on-bls12-377) on the same points (``random_points_fast``, seed 1) and
fresh scalars a run: one untimed run, then the median of R, each between two
synchronisations; rank 0's median against d = 1's gives the speedup and the
efficiency. Then the largest mesh's MSM of 2 d host points at c = 6 is held
against the bigint oracle. Backends: NCCL takes one card a rank (the
default on the card); ``--backend gloo`` runs every rank on the CPU, or on
``cuda:0`` with ``--device cuda`` (ranks sharing one card, as
``chip_smoke.py`` phase 17 does).
"""

from __future__ import annotations

import argparse
import random

from ..bigint.msm import msm as msm_oracle
from ..bigint.weierstrass import ProjectiveCurve
from ..bigint.edwards import EdwardsCurve
from ..parallel.launch import spawn
from ..parallel.mesh import make_mesh
from ..testing.mesh_ranks import foreign_modules
from .common import CURVES, WEIERSTRASS, device_of, make_curve, stats, wall_ms

__all__ = ["main", "run_mesh"]


def _rank_msm(rank, world, device, spec):
    """One rank of a mesh run (``spec``: curve, logN, runs, warmup, mode, c,
    check): its median and runs, and the oracle check's verdict."""
    curve = make_curve(spec["curve"])
    N = 1 << spec["logN"]
    mesh = make_mesh(device=device.type)
    weier = spec["curve"] in WEIERSTRASS
    kwargs = {"c": spec["c"], "mesh": mesh}
    if spec["mode"] or weier:
        kwargs["mode"] = spec["mode"] or "projective"
    points = curve.random_points_fast(N, seed=1, device=device)
    sets = [curve.random_scalars(N, seed=3 + r, device=device)
            for r in range(spec["warmup"] + spec["runs"])]
    times = []
    for r, s in enumerate(sets):
        dt, res = wall_ms(lambda: curve.msm_unsafe(s, points, **kwargs), device)
        if r >= spec["warmup"]:
            times.append(dt)
    out = {"rank": rank, "world": world, "times_ms": times, "result": curve.result_to_int(res),
           "foreign": foreign_modules()}
    if spec["check"]:
        rng = random.Random(5)
        n_small = 2 * world
        pts = [curve.oracle.random(rng) for _ in range(n_small)]
        scs = [rng.randrange(curve.params.order) for _ in range(n_small)]
        got = curve.result_to_int(curve.msm(curve.scalars_from_ints(scs, device),
                                            curve.points_from_ints(pts, device), c=6, mesh=mesh))
        if weier:
            C = ProjectiveCurve(curve.params)
            want = C.to_affine(msm_oracle(C, scs, [C.from_affine(p) for p in pts], curve.scalar.bits))
        else:
            C = EdwardsCurve(curve.params)
            want = C.to_affine(msm_oracle(C, scs, pts, curve.scalar.bits))
        out["oracle_ok"] = got == want
    return out


def run_mesh(curve: str, logN: int, sizes, device: str, backend=None, runs: int = 3,
             warmup: int = 1, mode=None, c=None, check: bool = False) -> list[dict]:
    """Rank 0's numbers of the sharded MSM on each mesh size in ``sizes``
    (the oracle check on the last where ``check``), with the speedup and
    efficiency against the first size."""
    rows, base = [], None
    for i, d in enumerate(sizes):
        spec = dict(curve=curve, logN=logN, runs=runs, warmup=warmup, mode=mode, c=c,
                    check=check and i == len(sizes) - 1)
        ranks = spawn(_rank_msm, d, device=device, backend=backend, args=(spec,))
        if any(r["foreign"] for r in ranks):
            raise AssertionError(f"a rank imported JAX: {[r['foreign'] for r in ranks]}")
        if len({repr(r["result"]) for r in ranks}) != 1:
            raise AssertionError(f"d={d}: the ranks disagree on the result")
        med, std = stats(ranks[0]["times_ms"])
        base = base or (med, sizes[0])
        row = {"devices": d, "backend": backend or ("nccl" if device == "cuda" else "gloo"),
               "median_ms": med, "std_ms": std, "speedup": base[0] / med,
               "efficiency": base[0] * base[1] / (med * d), "result": ranks[0]["result"]}
        if spec["check"]:
            if not all(r["oracle_ok"] for r in ranks):
                raise AssertionError("sharded MSM mismatch vs the bigint oracle")
            row["oracle_ok"] = True
        print(f"devices={d:2d} ({row['backend']}): {med:9.3f} +- {std:.3f} ms   "
              f"speedup={row['speedup']:5.2f}x efficiency={row['efficiency'] * 100:5.1f}%", flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("curve", nargs="?", default="bls12-377", choices=list(CURVES))
    ap.add_argument("logN", nargs="?", type=int, default=13)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"])
    ap.add_argument("--devices", default=None, help="comma list of mesh sizes (default 1, 2, 4, ..)")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    if args.devices:
        sizes = [int(s) for s in args.devices.split(",")]
    else:
        import torch

        most = torch.cuda.device_count() if device.type == "cuda" and args.backend != "gloo" else 4
        sizes = [1 << k for k in range(most.bit_length())]
    print(f"# scaling: {args.curve} 2^{args.logN}, device {device.type}, sizes {sizes}", flush=True)
    rows = run_mesh(args.curve, args.logN, sizes, device.type, args.backend, runs=args.runs,
                    check=True)
    print("oracle cross-check (largest mesh): OK", flush=True)
    return rows


if __name__ == "__main__":
    main()
