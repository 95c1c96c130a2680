#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's BLS12-377 MSM end to end on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is
non-zero and no result line is printed):

1. device: the card's name and power limit, and the kernel build
   (``nvcc`` into ``build/``, with the ptxas register and spill lines);
2. every kernel of the main path against its plain PyTorch twin on the
   card, at the shapes the 2^16 MSM gives it (K2 bit-exact, the others
   exact mod p), with the CUDA-event time per call of both;
3. the MSM at N = 8 and its edge cases against two host oracles
   (double-and-add per point, and the known discrete logs);
4. the 2^16 MSM against its known-discrete-log result, with the launch
   count of every kernel in that run (each must be > 0);
5. 5 warmups and 10 timed 2^16 MSMs with fresh scalars: median +- sigma.

The second-to-last line is the kernel table as JSON, the last the result.
Nothing of JAX or of the JAX package is imported: the port stands alone.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

LOG_N = 16
SEED = 2026
WARMUP, RUNS = 5, 10
REPS, PLAIN_REPS = 20, 3  # back-to-back calls per timing: kernel, plain twin


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _cuda_ms(torch, fn, reps=REPS) -> float:
    """CUDA-event time of one fn() call in ms: one event pair around reps
    back-to-back calls, after one untimed call. Where the host takes longer
    to enqueue a call than the card to run it, this is the host's time."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    from msm_zprize_tpu_torch import _build, counters
    from msm_zprize_tpu_torch.curves import cuda_curve
    from msm_zprize_tpu_torch.curves.params import BLS12_377
    from msm_zprize_tpu_torch.fields import cuda_mul, cuda_scalar
    from msm_zprize_tpu_torch.msm.common import default_windows, window_size
    from msm_zprize_tpu_torch.msm.engine import slot_count
    from msm_zprize_tpu_torch.parallel.api import Weierstrass
    from msm_zprize_tpu_torch.testing.points import expected_msm, naive_msm, points_with_logs

    if "jax" in sys.modules or "msm_zprize_tpu" in sys.modules:
        raise AssertionError("the port must import nothing of JAX or the JAX package")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = _card()

    # ---- 1. device and build --------------------------------------------------
    print(card)  # name, power limit: as nvidia-smi reports them
    t0 = time.perf_counter()
    _, info = _build.library()
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel build {info.seconds:.1f} s (nvcc), load {time.perf_counter() - t0:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")

    curve = Weierstrass.create(BLS12_377)
    W, F, S = curve.ops, curve.ops.F, curve.scalar
    N = 1 << LOG_N
    c = window_size("batched-affine", LOG_N)
    K, L = default_windows(S.max_bits, c), 1 << (c - 1)
    M = slot_count(2 * N, L)
    lanes1 = (M // 2) * K * L  # level-1 pairs of the main round
    rng = np.random.default_rng(SEED)

    def field_elems(width):
        """Random Montgomery-form elements < 2^376 < p, on the card."""
        limbs = rng.integers(0, 1 << 12, size=(F.n, width), dtype=np.int32)
        limbs[-1] &= 0xF
        return torch.as_tensor(limbs, device=dev)

    def flags(width):
        return torch.as_tensor(rng.integers(0, 2, size=width, dtype=np.int32), device=dev)

    def mod_p_err(got, want):
        """Max |difference| of the limbs of the fully reduced values."""
        errs = [(F.fully_reduce(g).long() - F.fully_reduce(w).long()).abs().max().item()
                for g, w in zip(got, want)]
        return max(errs)

    # ---- 2. kernels vs plain twins at slice shapes ----------------------------
    table = []

    def kernel_row(name, kid, source, replaces, err, ms, plain_ms, shape):
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain twin at {shape}: max err {err}")
        print(f"[2 kernel] {kid} {name} {shape}: equal to plain twin (max err {err}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        table.append(dict(name=name, id=kid, route="cuda", source=source, replaces=replaces,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=shape))

    x, y = field_elems(N), field_elems(N)
    got = cuda_mul.montmul(F, x, y)
    want = F.montmul_plain(x, y)
    kernel_row("montmul", "K1", "msm_zprize_tpu_torch/csrc/montmul.cu",
               "msm_zprize_tpu/fields/pallas_mul.py:167", mod_p_err([got], [want]),
               _cuda_ms(torch, lambda: cuda_mul.montmul(F, x, y)),
               _cuda_ms(torch, lambda: F.montmul_plain(x, y), PLAIN_REPS), f"(32, {N})")

    scal = curve.random_scalars(N, seed=SEED, device=dev)
    gm, gs = cuda_scalar.glv_digits(S, scal, c, K)
    wm, ws = cuda_scalar.glv_digits_plain(S, scal, c, K)
    if not (torch.equal(gm, wm) and torch.equal(gs, ws)):
        raise AssertionError("K2 glv_digits is not bit-identical to its plain twin")
    err = max((gm - wm).abs().max().item(), (gs - ws).abs().max().item())
    kernel_row("glv_digits", "K2", "msm_zprize_tpu_torch/csrc/glv_digits.cu",
               "msm_zprize_tpu/fields/pallas_scalar.py:279", err,
               _cuda_ms(torch, lambda: cuda_scalar.glv_digits(S, scal, c, K)),
               _cuda_ms(torch, lambda: cuda_scalar.glv_digits_plain(S, scal, c, K), PLAIN_REPS),
               f"N={N}, c={c}, K={K}")

    a3 = [field_elems(lanes1), field_elems(lanes1), flags(lanes1), flags(lanes1),
          field_elems(lanes1), field_elems(lanes1), flags(lanes1), flags(lanes1)]
    err = mod_p_err(cuda_curve.aff_pair_add(W, *a3), cuda_curve.aff_pair_add_plain(W, *a3))
    kernel_row("aff_pair_add", "K3", "msm_zprize_tpu_torch/csrc/curve.cu",
               "msm_zprize_tpu/curves/pallas_curve.py:372", err,
               _cuda_ms(torch, lambda: cuda_curve.aff_pair_add(W, *a3)),
               _cuda_ms(torch, lambda: cuda_curve.aff_pair_add_plain(W, *a3), PLAIN_REPS),
               f"W={lanes1}")
    del a3

    for width in (lanes1 // 2, 1):
        a4 = [field_elems(width) for _ in range(6)]
        err = mod_p_err(cuda_curve.proj_add(W, *a4), cuda_curve.proj_add_plain(W, *a4))
        kernel_row("proj_add", "K4", "msm_zprize_tpu_torch/csrc/curve.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:382", err,
                   _cuda_ms(torch, lambda: cuda_curve.proj_add(W, *a4)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_add_plain(W, *a4), PLAIN_REPS),
                   f"W={width}")
    del a4

    c0 = max((c - 1) // 2, 1)
    for width, k in ((K, c0), (1, c)):
        a5 = [field_elems(width) for _ in range(3)]
        err = mod_p_err(cuda_curve.proj_double_k(W, *a5, k), cuda_curve.proj_double_k_plain(W, *a5, k))
        kernel_row("proj_double_k", "K5", "msm_zprize_tpu_torch/csrc/curve.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:324", err,
                   _cuda_ms(torch, lambda: cuda_curve.proj_double_k(W, *a5, k)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_double_k_plain(W, *a5, k), PLAIN_REPS),
                   f"W={width}, k={k}")
    torch.cuda.synchronize()

    # ---- 3. small MSMs against two host oracles ---------------------------------
    # each case: scalars, indices into 8 known-log points, and the expected
    # result twice: by double-and-add per point, and from the discrete logs
    orng = random.Random(7)
    q = BLS12_377.order
    pts, logs = points_with_logs(BLS12_377, 8, seed=SEED + 2)
    cases = {
        "N=8": ([orng.randrange(q) for _ in range(8)], list(range(8))),
        "duplicates": ([5, 11], [0, 0]),
        "cancellation": ([3, q - 3], [1, 1]),
        "zero scalars": ([0, 0, 0], [0, 1, 2]),
        "single point": ([987654321], [2]),
    }
    bad = []
    for name, (scs, idx) in cases.items():
        got = curve.msm_bigint(scs, [pts[i] for i in idx], dev)
        want = naive_msm(BLS12_377, scs, [pts[i] for i in idx])
        if not got == want == expected_msm(BLS12_377, scs, [logs[i] for i in idx]):
            bad.append(name)
    if bad:
        raise AssertionError(f"small MSMs disagree with the host oracles: {bad}")
    print(f"[3 oracle] N=8 MSM and edge cases ({', '.join(cases)}) equal both host oracles "
          "(double-and-add per point; known discrete logs)")

    # ---- 4. the 2^16 MSM against its known discrete logs -----------------------
    t0 = time.perf_counter()
    pts_n, logs = points_with_logs(BLS12_377, N, seed=SEED)
    points = curve.points_from_ints(pts_n, dev)
    setup_s = time.perf_counter() - t0
    scal = curve.random_scalars(N, seed=SEED + 1, device=dev)
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    res = curve.msm(scal, points)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = counters.snapshot()
    got = curve.result_to_int(res)
    want = expected_msm(BLS12_377, S.unpack(scal.cpu()), logs)
    if got != want:
        raise AssertionError("2^16 MSM disagrees with the known-discrete-log result")
    launches = {k: v for k, v in counts.items() if k.startswith("k")}
    for row in table:
        key = {"K1": cuda_mul.KERNEL, "K2": cuda_scalar.KERNEL, "K3": cuda_curve.K3,
               "K4": cuda_curve.K4, "K5": cuda_curve.K5}[row["id"]]
        row["launches"] = counts.get(key, 0)
        if row["launches"] == 0:
            raise AssertionError(f"{row['id']} {row['name']} was not launched by the MSM")
    print(f"[4 msm 2^{LOG_N}] result equals (sum s_i a_i mod q) G; c={c} K={K} L={L} M={M}; "
          f"first run {first_ms:.1f} ms; launches {launches}; host syncs {counts.get('host_sync', 0)}; "
          f"input set-up {setup_s:.1f} s")

    # ---- 5. timing: fresh scalars per run --------------------------------------
    batches = [curve.random_scalars(N, seed=SEED + 100 + i, device=dev) for i in range(WARMUP + RUNS)]
    torch.cuda.synchronize()
    times = []
    for i, s in enumerate(batches):
        t0 = time.perf_counter()
        curve.msm(s, points)
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
    med, sd = statistics.median(times), statistics.stdev(times)
    print(f"[5 timing] BLS12-377 MSM 2^{LOG_N}: {med:.2f} +- {sd:.2f} ms "
          f"(median +- sigma of {RUNS} runs after {WARMUP} warmups, fresh scalars) on {card}; "
          f"runs {[round(t, 2) for t in times]}")

    # one entry per kernel: its main-path shape's times, its worst error
    kernels = {}
    for row in table:
        entry = kernels.setdefault(row["id"], {
            k: row[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
        })
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
    kernels = list(kernels.values())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
