#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two MSM paths end to end on one GPU: the
BLS12-377 projective MSM and the ed-on-bls12-377 twisted-Edwards MSM.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is
non-zero and no result line is printed):

1. device: the card's name and power limit, and the kernel build
   (one ``nvcc`` per source into ``build/``, with the ptxas register and
   spill lines);
2. every kernel of both paths against its plain PyTorch twin on the card,
   at the shapes the 2^16 MSMs give it (K2 and K9 bit-exact, the others
   exact mod p), with the CUDA-event time per call of both and the bound:
   the least time the card could take for the same work;
3. BLS12-377: the MSM at N = 8 and its edge cases against two host oracles
   (double-and-add per point, and the known discrete logs);
4. BLS12-377: the 2^16 MSM against its known-discrete-log result, with the
   launch count of every kernel in that run (each of its path must be > 0);
5. BLS12-377: 5 warmups and 10 timed 2^16 MSMs with fresh scalars;
6-8. the same three phases for ed-on-bls12-377 (``TwistedEdwards.msm``).

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

# The bound's two rates (NVIDIA H100 SXM): device memory 3.35 TB/s (data
# sheet); 32-bit integer multiply-adds, 64 results per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), times the SM count and the card's maximum SM clock, both read
# in the run.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64


def _smi(query: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
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


def mont_imads(nw: int, tail: bool) -> int:
    """32-bit multiply-adds of one CIOS product over nw words: nw^2 products
    a_j b_i and nw^2 products m p_j, each 32x32->64 counted as two (low and
    high half), nw quotient digits m; the tail round one more row of m p_j
    and its digit. Additions, carries and selects are not counted, so a
    bound built on this is a lower bound."""
    return 4 * nw * nw + nw + (2 * nw + 1 if tail else 0)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    from msm_zprize_tpu_torch import _build, counters
    from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
    from msm_zprize_tpu_torch.curves.params import BLS12_377, ED_ON_BLS12_377
    from msm_zprize_tpu_torch.fields import cuda_mul, cuda_scalar
    from msm_zprize_tpu_torch.fields.scalar import signed_digits
    from msm_zprize_tpu_torch.msm.common import default_windows, window_size
    from msm_zprize_tpu_torch.msm.engine import slot_count
    from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
    from msm_zprize_tpu_torch.testing.points import (
        ed_expected_msm, ed_naive_msm, ed_points_with_logs, expected_msm, naive_msm,
        points_with_logs,
    )

    if "jax" in sys.modules or "msm_zprize_tpu" in sys.modules:
        raise AssertionError("the port must import nothing of JAX or the JAX package")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = _smi("name,power.limit")
    imad_per_s = (IMAD_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
                  * float(_smi("clocks.max.sm").split()[0]) * 1e6)  # "1980 MHz"

    # ---- 1. device and build --------------------------------------------------
    print(card)  # name, power limit: as nvidia-smi reports them
    t0 = time.perf_counter()
    _, info = _build.library()
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel build {info.seconds:.1f} s (nvcc), load {time.perf_counter() - t0:.1f} s | "
          f"bound rates: {HBM_BYTES_PER_S / 1e12:.2f} TB/s, {imad_per_s / 1e12:.2f} T IMAD/s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")

    curve = Weierstrass.create(BLS12_377)
    W, F, S = curve.ops, curve.ops.F, curve.scalar
    ed = TwistedEdwards.create(ED_ON_BLS12_377)
    E, FE, SE = ed.ops, ed.ops.F, ed.scalar
    N = 1 << LOG_N
    c = window_size("batched-affine", LOG_N)
    K, L = default_windows(S.max_bits, c), 1 << (c - 1)
    M = slot_count(2 * N, L)
    lanes1 = (M // 2) * K * L  # level-1 pairs of the main round
    ce = window_size("edwards", LOG_N)
    Ke, Le = default_windows(SE.bits, ce), 1 << (ce - 1)
    Me = slot_count(N, Le)
    lanes1e = (Me // 2) * Ke * Le
    rng = np.random.default_rng(SEED)

    def field_elems(G, width):
        """Random Montgomery-form elements below 2^(bits(p) - 1) < p, on the card."""
        top = (G.p.bit_length() - 1) - 12 * (G.n - 1)
        limbs = rng.integers(0, 1 << 12, size=(G.n, width), dtype=np.int32)
        limbs[-1] &= (1 << max(top, 0)) - 1
        return torch.as_tensor(limbs, device=dev)

    def flags(width):
        return torch.as_tensor(rng.integers(0, 2, size=width, dtype=np.int32), device=dev)

    def mod_p_err(G, got, want):
        """Max |difference| of the limbs of the fully reduced values."""
        return max((G.fully_reduce(g).long() - G.fully_reduce(w).long()).abs().max().item()
                   for g, w in zip(got, want))

    # ---- 2. kernels vs plain twins at slice shapes ----------------------------
    table = []

    def kernel_row(key, name, kid, source, replaces, err, ms, plain_ms, shape, nbytes, imads):
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain twin at {shape}: max err {err}")
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / imad_per_s * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        print(f"[2 kernel] {kid} {name} {shape}: equal to plain twin (max err {err}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
        table.append(dict(key=key, name=name, id=kid, route="cuda", source=source,
                          replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=shape))

    mm12, mm8 = mont_imads(12, False), mont_imads(8, True)
    src = "msm_zprize_tpu_torch/csrc/"

    # BLS12-377 path
    x, y = field_elems(F, N), field_elems(F, N)
    kernel_row("k1_bls", "montmul", "K1", src + "montmul.cu",
               "msm_zprize_tpu/fields/pallas_mul.py:167",
               mod_p_err(F, [cuda_mul.montmul(F, x, y)], [F.montmul_plain(x, y)]),
               _cuda_ms(torch, lambda: cuda_mul.montmul(F, x, y)),
               _cuda_ms(torch, lambda: F.montmul_plain(x, y), PLAIN_REPS), f"(32, {N})",
               3 * 32 * 4 * N, mm12 * N)

    scal = curve.random_scalars(N, seed=SEED, device=dev)
    gm, gs = cuda_scalar.glv_digits(S, scal, c, K)
    wm, ws = cuda_scalar.glv_digits_plain(S, scal, c, K)
    if not (torch.equal(gm, wm) and torch.equal(gs, ws)):
        raise AssertionError("K2 glv_digits is not bit-identical to its plain twin")
    k2_muls = 2 * S.n * len(S.m0) + 4 * sum(
        1 for i in range(S.n_half + 1) for j in range(S.n_half) if i + j < S.n_acc)
    kernel_row("k2", "glv_digits", "K2", src + "glv_digits.cu",
               "msm_zprize_tpu/fields/pallas_scalar.py:279",
               max((gm - wm).abs().max().item(), (gs - ws).abs().max().item()),
               _cuda_ms(torch, lambda: cuda_scalar.glv_digits(S, scal, c, K)),
               _cuda_ms(torch, lambda: cuda_scalar.glv_digits_plain(S, scal, c, K), PLAIN_REPS),
               f"N={N}, c={c}, K={K}", (S.n + 4 * K) * 4 * N, k2_muls * N)

    a3 = [field_elems(F, lanes1), field_elems(F, lanes1), flags(lanes1), flags(lanes1),
          field_elems(F, lanes1), field_elems(F, lanes1), flags(lanes1), flags(lanes1)]
    kernel_row("k3", "aff_pair_add", "K3", src + "curve.cu",
               "msm_zprize_tpu/curves/pallas_curve.py:372",
               mod_p_err(F, cuda_curve.aff_pair_add(W, *a3), cuda_curve.aff_pair_add_plain(W, *a3)),
               _cuda_ms(torch, lambda: cuda_curve.aff_pair_add(W, *a3)),
               _cuda_ms(torch, lambda: cuda_curve.aff_pair_add_plain(W, *a3), PLAIN_REPS),
               f"W={lanes1}", (7 * 32 + 4) * 4 * lanes1, 9 * mm12 * lanes1)
    del a3

    for width in (lanes1 // 2, 1):
        a4 = [field_elems(F, width) for _ in range(6)]
        kernel_row("k4", "proj_add", "K4", src + "curve.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:382",
                   mod_p_err(F, cuda_curve.proj_add(W, *a4), cuda_curve.proj_add_plain(W, *a4)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_add(W, *a4)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_add_plain(W, *a4), PLAIN_REPS),
                   f"W={width}", 9 * 32 * 4 * width, 12 * mm12 * width)
    del a4

    c0 = max((c - 1) // 2, 1)
    for width, k in ((K, c0), (1, c)):
        a5 = [field_elems(F, width) for _ in range(3)]
        kernel_row("k5", "proj_double_k", "K5", src + "curve.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:324",
                   mod_p_err(F, cuda_curve.proj_double_k(W, *a5, k),
                             cuda_curve.proj_double_k_plain(W, *a5, k)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_double_k(W, *a5, k)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_double_k_plain(W, *a5, k), PLAIN_REPS),
                   f"W={width}, k={k}", 6 * 32 * 4 * width, 8 * k * mm12 * width)
    del a5

    # ed-on-bls12-377 path (n = 22, R = 2^264)
    n22 = FE.n
    x, y = field_elems(FE, N), field_elems(FE, N)
    kernel_row("k1_ed", "montmul_n22", "K1", src + "montmul.cu",
               "msm_zprize_tpu/fields/pallas_mul.py:167",
               mod_p_err(FE, [cuda_mul.montmul(FE, x, y)], [FE.montmul_plain(x, y)]),
               _cuda_ms(torch, lambda: cuda_mul.montmul(FE, x, y)),
               _cuda_ms(torch, lambda: FE.montmul_plain(x, y), PLAIN_REPS), f"({n22}, {N})",
               3 * n22 * 4 * N, mm8 * N)

    e = FE.p - 2  # batch_inverse's one Fermat inverse, on one lane
    x1 = field_elems(FE, 1)
    kernel_row("k8", "exp_const", "K8", src + "montmul.cu",
               "msm_zprize_tpu/fields/pallas_mul.py:237",
               mod_p_err(FE, [cuda_mul.exp_const(FE, x1, e)], [FE.exp_const_plain(x1, e)]),
               _cuda_ms(torch, lambda: cuda_mul.exp_const(FE, x1, e)),
               _cuda_ms(torch, lambda: FE.exp_const_plain(x1, e), PLAIN_REPS),
               f"({n22}, 1), e = p - 2", 2 * n22 * 4,
               (e.bit_length() + bin(e).count("1")) * mm8)

    scal = ed.random_scalars(N, seed=SEED, device=dev)
    gm, gs = cuda_scalar.simple_digits(scal, ce, Ke)
    wm, ws = signed_digits(scal, ce, Ke, 12)
    if not (torch.equal(gm, wm) and torch.equal(gs, ws)):
        raise AssertionError("K9 simple_digits is not bit-identical to its plain twin")
    kernel_row("k9", "simple_digits", "K9", src + "glv_digits.cu",
               "msm_zprize_tpu/fields/pallas_scalar.py:239",
               max((gm - wm).abs().max().item(), (gs - ws).abs().max().item()),
               _cuda_ms(torch, lambda: cuda_scalar.simple_digits(scal, ce, Ke)),
               _cuda_ms(torch, lambda: signed_digits(scal, ce, Ke, 12), PLAIN_REPS),
               f"N={N}, c={ce}, K={Ke}", (SE.n + 2 * Ke) * 4 * N, 0)

    a10 = [field_elems(FE, lanes1e), field_elems(FE, lanes1e), flags(lanes1e), flags(lanes1e),
           field_elems(FE, lanes1e), field_elems(FE, lanes1e), flags(lanes1e), flags(lanes1e)]
    kernel_row("k10", "ed_pair_add", "K10", src + "edwards.cu",
               "msm_zprize_tpu/curves/pallas_curve.py:449",
               mod_p_err(FE, cuda_edwards.ed_pair_add(E, *a10), cuda_edwards.ed_pair_add_plain(E, *a10)),
               _cuda_ms(torch, lambda: cuda_edwards.ed_pair_add(E, *a10)),
               _cuda_ms(torch, lambda: cuda_edwards.ed_pair_add_plain(E, *a10), PLAIN_REPS),
               f"W={lanes1e}", (8 * n22 + 4) * 4 * lanes1e, 10 * mm8 * lanes1e)
    del a10

    for width, masked in ((lanes1e // 2, False), (lanes1e // 2, True), (1, False)):
        a11 = [field_elems(FE, width) for _ in range(8)]
        mask = {"mask": flags(width)} if masked else {}
        kernel_row("k11", "ed_add", "K11", src + "edwards.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:500",
                   mod_p_err(FE, cuda_edwards.ed_add(E, *a11, **mask),
                             cuda_edwards.ed_add_plain(E, *a11, **mask)),
                   _cuda_ms(torch, lambda: cuda_edwards.ed_add(E, *a11, **mask)),
                   _cuda_ms(torch, lambda: cuda_edwards.ed_add_plain(E, *a11, **mask), PLAIN_REPS),
                   f"W={width}{', masked' if masked else ''}",
                   (12 * n22 + masked) * 4 * width, 9 * mm8 * width)
    del a11

    c0e = max((ce - 1) // 2, 1)
    for width, k in ((Ke, c0e), (1, ce)):
        a12 = [field_elems(FE, width) for _ in range(4)]
        kernel_row("k12", "ed_double_k", "K12", src + "edwards.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:494",
                   mod_p_err(FE, cuda_edwards.ed_double_k(E, *a12, k),
                             cuda_edwards.ed_double_k_plain(E, *a12, k)),
                   _cuda_ms(torch, lambda: cuda_edwards.ed_double_k(E, *a12, k)),
                   _cuda_ms(torch, lambda: cuda_edwards.ed_double_k_plain(E, *a12, k), PLAIN_REPS),
                   f"W={width}, k={k}", 8 * n22 * 4 * width, 9 * k * mm8 * width)
    del a12
    torch.cuda.synchronize()

    # ---- 3-8. each curve: small MSMs, the 2^16 MSM, timing -----------------------
    # the counter key of each table row, per path
    path_keys = {
        "bls12-377": {"k1_bls": cuda_mul.KERNEL, "k2": cuda_scalar.KERNEL, "k3": cuda_curve.K3,
                      "k4": cuda_curve.K4, "k5": cuda_curve.K5},
        "ed-on-bls12-377": {"k1_ed": cuda_mul.KERNEL, "k8": cuda_mul.K8, "k9": cuda_scalar.K9,
                            "k10": cuda_edwards.K10, "k11": cuda_edwards.K11,
                            "k12": cuda_edwards.K12},
    }
    curves = (
        ("bls12-377", 3, curve, BLS12_377, points_with_logs, expected_msm, naive_msm),
        ("ed-on-bls12-377", 6, ed, ED_ON_BLS12_377, ed_points_with_logs, ed_expected_msm,
         ed_naive_msm),
    )
    for label, phase, cv, params, with_logs, expected, naive in curves:
        # each case: scalars, indices into 8 known-log points, and the expected
        # result twice: by double-and-add per point, and from the discrete logs
        orng = random.Random(7)
        q = params.order
        pts, logs = with_logs(params, 8, seed=SEED + 2)
        cases = {
            "N=8": ([orng.randrange(q) for _ in range(8)], list(range(8))),
            "duplicates": ([5, 11], [0, 0]),
            "cancellation": ([3, q - 3], [1, 1]),
            "zero scalars": ([0, 0, 0], [0, 1, 2]),
            "single point": ([987654321], [2]),
        }
        bad = []
        for name, (scs, idx) in cases.items():
            got = cv.msm_bigint(scs, [pts[i] for i in idx], dev)
            want = naive(params, scs, [pts[i] for i in idx])
            if not got == want == expected(params, scs, [logs[i] for i in idx]):
                bad.append(name)
        if bad:
            raise AssertionError(f"{label}: small MSMs disagree with the host oracles: {bad}")
        print(f"[{phase} oracle] {label}: N=8 MSM and edge cases ({', '.join(cases)}) equal both "
              "host oracles (double-and-add per point; known discrete logs)")

        t0 = time.perf_counter()
        pts_n, logs = with_logs(params, N, seed=SEED)
        points = cv.points_from_ints(pts_n, dev)
        setup_s = time.perf_counter() - t0
        scal = cv.random_scalars(N, seed=SEED + 1, device=dev)
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        res = cv.msm(scal, points)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = counters.snapshot()
        if cv.result_to_int(res) != expected(params, cv.scalar.unpack(scal.cpu()), logs):
            raise AssertionError(f"{label}: 2^{LOG_N} MSM disagrees with the known-discrete-log result")
        for row in table:
            key = path_keys[label].get(row["key"])
            if key is not None:
                row["launches"] = counts.get(key, 0)
                if row["launches"] == 0:
                    raise AssertionError(f"{row['id']} {row['name']} was not launched by the {label} MSM")
        launches = {k: v for k, v in counts.items() if k.startswith("k")}
        print(f"[{phase + 1} msm 2^{LOG_N}] {label}: result equals (sum s_i a_i mod q) G; "
              f"first run {first_ms:.1f} ms; launches {launches}; host syncs "
              f"{counts.get('host_sync', 0)}; input set-up {setup_s:.1f} s")

        batches = [cv.random_scalars(N, seed=SEED + 100 + i, device=dev) for i in range(WARMUP + RUNS)]
        torch.cuda.synchronize()
        times = []
        for i, s in enumerate(batches):
            t0 = time.perf_counter()
            cv.msm(s, points)
            torch.cuda.synchronize()
            if i >= WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
        med, sd = statistics.median(times), statistics.stdev(times)
        print(f"[{phase + 2} timing] {label} MSM 2^{LOG_N}: {med:.2f} +- {sd:.2f} ms "
              f"(median +- sigma of {RUNS} runs after {WARMUP} warmups, fresh scalars) on {card}; "
              f"runs {[round(t, 2) for t in times]}")

    # one entry per kernel and path: its main-path shape's numbers (the first
    # row, the widest), its worst error
    kernels = {}
    for row in table:
        entry = kernels.setdefault(row["key"], {
            k: row[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        })
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
