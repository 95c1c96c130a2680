"""Profile one MSM path of the port on the card.

    python3 -m msm_zprize_tpu_torch.profile_msm [--curve CURVE] [--log-n 16] [--path PATH]

CURVE is ``ed-on-bls12-377`` (the default), ``bls12-377``, ``bls12-381`` or
``pallas``, or a curve of the wide-field tests (``testing/wide_curves.py``):
``bn462`` (n = 39 limbs, a shape and a scalar module made on demand) or
``ed25519`` (the 9-word shape made on demand). PATH is the curve's default MSM mode (``projective`` or
``padded``, the default), another mode (Weierstrass ``affine``, ``unsafe``,
``halving``, ``packed`` (PackedCodec row storage), ``fma51`` (Pallas on
Fma51Codec pair rows); Edwards ``basic``), ``msm_projective`` (Weierstrass,
the same points with random Z) or
``random_points`` (``random_points_fast``, host table included). Prints,
each number beside the card's name and power limit as ``nvidia-smi``
reports them:

* the path's host-clock time (median +- sigma of 20 runs after 5 warmups,
  fresh scalars, each ending in ``torch.cuda.synchronize()``);
* the device-busy share over 3 profiled runs: the union of the kernel
  intervals ``torch.profiler`` records on the card over the wall time of
  the window, and the device time per run by kernel (launches, total);
* for the default modes, stage times, each stage synchronised before and
  after and timed by CUDA events (median of 10; ``utils/phases.py``): prep (digits, and the Edwards normalization or the
  GLV endomorphism), accumulation (its prep included), bucket reduction,
  Horner;
* the serial chains: the device time per launch of K8 (the Fermat
  inverse on one lane) and of the K5 / K12 doubling chains, from the same
  trace;
* the curve kernels (K3-K7, their K14 variants, and the Edwards K10-K12)
  launch by launch: for each kernel and width (and K5's or K12's k), the
  launches per run, their device time and their bound
  (``testing/bounds.py``: bytes over 3.35 TB/s or multiply-adds over the
  card's integer rate, whichever is larger), and the sums per run. The
  widths are those ``cuda_curve.LAUNCH_LOG`` logs
  during the profiled runs, matched to the trace's curve kernels in launch
  order.

Needs a CUDA device; refuses to run without one.
"""

from __future__ import annotations

import argparse
import random
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from . import _build
from .counters import COUNTS
from .curves import cuda_curve
from .curves.params import ED_ON_BLS12_377, WEIERSTRASS_CURVES
from .curves.weierstrass import ProjectivePoints
from .msm.common import window_size
from .parallel.api import TwistedEdwards, Weierstrass
from .testing import bounds
from .testing.wide_curves import BN462, ED25519
from .utils import phases

__all__ = ["main"]

WEIERSTRASS = {**WEIERSTRASS_CURVES, BN462.label: BN462}
EDWARDS = {ED_ON_BLS12_377.label: ED_ON_BLS12_377, ED25519.label: ED25519}


def _stages(label, cv, scalars, points, log_n):
    """CUDA-event stage times of one MSM (``utils/phases.py::stage_times``):
    prep, accumulation (prep included), reduction, Horner."""
    c = window_size("batched-affine" if label in WEIERSTRASS else "edwards", log_n)
    return phases.stage_times(cv, scalars, points, c)


def _curve_table(head, kernels, launches, runs) -> None:
    """Per curve kernel and width: launches, device time and bound per run,
    from ``cuda_curve.LAUNCH_LOG``'s records matched to the trace's curve
    kernels in launch order."""
    events = sorted((e for e in kernels if "msm::wei::" in e.name or "msm::ed::" in e.name),
                    key=lambda e: e.time_range.start)
    if len(events) != len(launches):
        raise AssertionError(f"{head}: {len(events)} curve kernels in the trace against "
                             f"{len(launches)} logged launches")
    rate = bounds.imad_per_s(torch)
    rows = defaultdict(lambda: [0, 0.0, 0.0])  # (key, width, k) -> launches, device ms, bound ms
    for e, (name, width, k, n, F, flags) in zip(events, launches):
        # K4m: lanes with the mask set; K7: lanes whose affine operand is finite
        computing = None if flags is None else int(
            flags.ne(0).sum() if name.endswith(cuda_curve.K4M) else flags.eq(0).sum())
        fn, nw, _ = _build.shape_layout(_build.field_shape(F))
        mm = bounds.mont_imads(nw, 12 * fn % 32 > 0, 12 * fn // 32)
        nbytes, imads = bounds.curve_work(name, n, mm, width, k, computing)
        row = rows[(name, width, k)]
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) / 1e3
        row[2] += bounds.bound_ms(nbytes, imads, rate)[0]
    totals = defaultdict(lambda: [0, 0.0, 0.0])
    for (name, width, k), (count, dev, bnd) in sorted(rows.items(), key=lambda kv: (kv[0][0], -kv[0][1])):
        tot = totals[name]
        tot[0] += count
        tot[1] += dev
        tot[2] += bnd
        print(f"    {name} W={width}{f' k={k}' if k else ''}: {count // runs} launches, device "
              f"{dev / runs:.4f} ms, bound {bnd / runs:.4f} ms per run")
    print(f"[curve kernels] {head}: per run " + "; ".join(
        f"{name} {count // runs} launches, device {dev / runs:.3f} ms, bound {bnd / runs:.3f} ms"
        for name, (count, dev, bnd) in sorted(totals.items())))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--curve", default="ed-on-bls12-377", choices=[*EDWARDS, *WEIERSTRASS])
    ap.add_argument("--log-n", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--path", default=None, choices=[
        "projective", "affine", "unsafe", "halving", "packed", "fma51", "msm_projective", "padded",
        "basic", "random_points"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_msm: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    N = 1 << args.log_n
    if args.curve in WEIERSTRASS:
        cv = Weierstrass.create(WEIERSTRASS[args.curve])
    else:
        cv = TwistedEdwards.create(EDWARDS[args.curve])
    points = cv.random_points_fast(N, seed=args.seed, device=dev)  # made on the card: any N
    batches = [cv.random_scalars(N, seed=args.seed + 1 + i, device=dev) for i in range(25)]
    default = "projective" if args.curve in WEIERSTRASS else "padded"
    path = args.path or default
    if path == "unsafe":
        run = lambda s: cv.msm_unsafe(s, points, mode="affine")
    elif path == "msm_projective":
        F = cv.ops.F
        rng = random.Random(args.seed)
        z = torch.as_tensor(F.pack([rng.randrange(1, F.p) for _ in range(N)]), device=dev)
        proj = ProjectivePoints(F.montmul(points.x, z), F.montmul(points.y, z), z)
        run = lambda s: cv.msm_projective(s, proj)
    elif path == "random_points":
        run = lambda s: cv.random_points_fast(N, seed=args.seed, device=dev)
    else:
        run = lambda s: cv.msm(s, points, mode=path)
    head = f"{args.curve} {path} 2^{args.log_n} on {card}"

    times = []
    for i, s in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(s)
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"[msm] {head}: {statistics.median(times):.3f} +- {statistics.stdev(times):.3f} ms "
          f"(median +- sigma of {len(times)} runs after 5 warmups); runs "
          f"{[round(t, 2) for t in times]}")

    runs = 3
    COUNTS.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    cuda_curve.LAUNCH_LOG = launches = []
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for s in batches[:runs]:
                run(s)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cuda_curve.LAUNCH_LOG = None
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernel intervals
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = defaultdict(list)
    for e in kernels:
        by_name[e.name.split("(")[0][:60]].append(e.time_range.end - e.time_range.start)
    print(f"[busy] {head}: device busy {busy_us / 1e3 / runs:.3f} ms per run of "
          f"{wall_ms / runs:.3f} ms wall under the profiler: busy share "
          f"{busy_us / 1e3 / wall_ms:.3f}; launches per run of the port's kernels "
          f"{ {k: v // runs for k, v in COUNTS.items() if k.startswith('k')} }; host syncs "
          f"{COUNTS.get('host_sync', 0) // runs}; {len(kernels) // runs} device kernels in all")
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:14]:
        print(f"    {sum(durs) / 1e3 / runs:9.3f} ms per run  {len(durs) // runs:4d} launches  "
              f"max {max(durs) / 1e3:.4f} ms  {name}")
    _curve_table(head, kernels, launches, runs)
    if path != default:
        return

    walls = _stages(args.curve, cv, batches[0], points, args.log_n)
    print(f"[stages] {head}: " + "; ".join(f"{k} {v:.3f} ms" for k, v in walls.items())
          + " (each synchronised, CUDA events, median of 10)")
    chains = {k: sorted(v) for k, v in by_name.items()
              if "exp_warp_kernel" in k or "exp_thread_kernel" in k or "double_k" in k}
    print(f"[serial] {head}: one-launch device times of the chained kernels (ms): "
          + "; ".join(f"{k} min {v[0] / 1e3:.4f} median {statistics.median(v) / 1e3:.4f} "
                      f"max {v[-1] / 1e3:.4f}" for k, v in sorted(chains.items())))


if __name__ == "__main__":
    main()
