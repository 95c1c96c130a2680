#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MSM paths end to end on one GPU: the
BLS12-377 MSM in its four modes (the codec storage mode "packed" among
them) and on projective inputs, the ed-on-bls12-377 twisted-Edwards MSM in
its two modes, the device generator of random points, and ``compute_msm``.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is
non-zero and no result line is printed):

1. device: the card's name and power limit, and the kernel build
   (one ``nvcc`` per source into ``build/``, with the ptxas register and
   spill lines);
2. every kernel of every path against its plain PyTorch twin on the card,
   at the shapes the 2^16 MSMs give it (K2 and K9 bit-exact, the others
   exact mod p, the pass-through lanes of K4m and K7 bit for bit), with the
   CUDA-event time per call of both and the bound: the least time the card
   could take for the same work;
3. BLS12-377: the MSM at N = 8 and its edge cases against two host oracles
   (double-and-add per point, and the known discrete logs);
4. BLS12-377: the 2^16 MSM against its known-discrete-log result, with the
   launch count of every kernel in that run (each of its path must be > 0);
5. BLS12-377: 5 warmups and 10 timed 2^16 MSMs with fresh scalars;
6-8. the same three phases for ed-on-bls12-377 (``TwistedEdwards.msm``);
9. BLS12-377 at 2^16 in the other modes: ``msm(mode="affine")``,
   ``msm_unsafe(mode="affine")``, ``msm(mode="halving")`` and
   ``msm_projective`` on the same points with random Z, each against the
   known-discrete-log result with its launch counts, then 2 warmups and 5
   timed runs;
10. ed-on-bls12-377 at 2^16 with ``msm(mode="basic")``, the same way;
11. ``random_points_fast`` at 2^16 on both curves: every lane on the curve
    (checked on the card), 256 sampled lanes equal to the host sums of
    their table picks and in the prime-order subgroup (BLS12-377: q P = 0
    on the card), and the two modes' MSMs over the points agree; timing;
12. BLS12-377 at 2^16 on the codec storage mode: ``msm(mode="packed")`` and
    ``msm_unsafe(mode="packed")`` on the points of phase 4 (coordinates in
    13 rows of 31 bits; K13 and the K14 variants of K3-K5, no K1), each
    against the known-discrete-log result with its launch counts, 2 warmups
    and 5 timed runs beside the default mode's; then ``compute_msm`` on int
    inputs, without and with a duplicated point, against the host oracle.

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
MODE_WARMUP, MODE_RUNS = 2, 5  # the modes of phases 9-11
SAMPLE = 256  # lanes of random_points_fast checked on the host
SMALL = 4096  # width of the K14 variants that no codec-mode path runs
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
    from msm_zprize_tpu_torch.curves.weierstrass import AffinePoints, ProjectivePoints
    from msm_zprize_tpu_torch.fields import cuda_codec, cuda_mul, cuda_scalar
    from msm_zprize_tpu_torch.fields.codec import Fma51Codec
    from msm_zprize_tpu_torch.fields.scalar import signed_digits
    from msm_zprize_tpu_torch.msm.common import default_windows, window_size
    from msm_zprize_tpu_torch.msm.engine import slot_count
    from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
    from msm_zprize_tpu_torch.submission import compute_msm
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
    halving1 = K * ((2 * N + L) // 2 + 1)  # level 1 of the halving engine
    c0 = max((c - 1) // 2, 1)
    reduce_w = K * (L >> c0)  # the affine reduction's mixed adds: K x D lanes
    rng = np.random.default_rng(SEED)

    def field_elems(G, width):
        """Random Montgomery-form elements below 2^(bits(p) - 1) < p, on the card."""
        top = (G.p.bit_length() - 1) - 12 * (G.n - 1)
        limbs = rng.integers(0, 1 << 12, size=(G.n, width), dtype=np.int32)
        limbs[-1] &= (1 << max(top, 0)) - 1
        return torch.as_tensor(limbs, device=dev)

    def flags(width):
        return torch.as_tensor(rng.integers(0, 2, size=width, dtype=np.int32), device=dev)

    def raw_err(got, want):
        """Max |difference| of the stored limbs (bit-exact pass-through)."""
        return max((g.long() - w.long()).abs().max().item() if g.numel() else 0
                   for g, w in zip(got, want))

    def mod_p_err(G, got, want):
        """Max |difference| of the limbs of the fully reduced values."""
        return max((G.fully_reduce(g).long() - G.fully_reduce(w).long()).abs().max().item()
                   for g, w in zip(got, want))

    def rows_err(G, codec, got, want):
        """mod_p_err of codec rows, through their digit planes; every output
        must also hold a value below 2p."""
        dig = [codec.to_digits(G, g) for g in got]
        if not all(torch.equal(G._sub_const_select(d, G.two_p_limbs), d) for d in dig):
            raise AssertionError(f"{type(codec).__name__} output at or above 2p")
        return mod_p_err(G, dig, [codec.to_digits(G, w) for w in want])

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
                          replaces=replaces, launches=None, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, shape=shape))

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

    # K4m at the halving engine's first level; its masked-off lanes are P1
    a4 = [field_elems(F, halving1) for _ in range(6)]
    m4 = flags(halving1)
    got, want = cuda_curve.proj_add(W, *a4, mask=m4), cuda_curve.proj_add_plain(W, *a4, mask=m4)
    off = m4 == 0
    err = max(mod_p_err(F, got, want), raw_err([g[:, off] for g in got], [a[:, off] for a in a4[:3]]))
    kernel_row("k4m", "proj_add_masked", "K4m", src + "curve.cu",
               "msm_zprize_tpu/curves/pallas_curve.py:382", err,
               _cuda_ms(torch, lambda: cuda_curve.proj_add(W, *a4, mask=m4)),
               _cuda_ms(torch, lambda: cuda_curve.proj_add_plain(W, *a4, mask=m4), PLAIN_REPS),
               f"W={halving1}, masked", (9 * 32 + 1) * 4 * halving1,
               12 * mm12 * int(m4.sum().item()))
    del a4, got, want

    # K6 at the subgroup check's width (phase 11)
    a6 = [field_elems(F, SAMPLE) for _ in range(3)]
    kernel_row("k6", "proj_double", "K6", src + "curve.cu",
               "msm_zprize_tpu/curves/pallas_curve.py:394",
               mod_p_err(F, cuda_curve.proj_double(W, *a6), cuda_curve.proj_double_plain(W, *a6)),
               _cuda_ms(torch, lambda: cuda_curve.proj_double(W, *a6)),
               _cuda_ms(torch, lambda: cuda_curve.proj_double_plain(W, *a6), PLAIN_REPS),
               f"W={SAMPLE}", 6 * 32 * 4 * SAMPLE, 8 * mm12 * SAMPLE)

    # K7 at the affine reduction's width and at random_points_fast's; lanes
    # with an infinite affine operand are P1
    for width in (reduce_w, N):
        a7 = [field_elems(F, width) for _ in range(5)]
        i7 = flags(width)
        got, want = (cuda_curve.proj_add_mixed(W, *a7, i7),
                     cuda_curve.proj_add_mixed_plain(W, *a7, i7))
        on = i7 == 1
        err = max(mod_p_err(F, got, want), raw_err([g[:, on] for g in got], [a[:, on] for a in a7[:3]]))
        kernel_row("k7", "proj_add_mixed", "K7", src + "curve.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:397", err,
                   _cuda_ms(torch, lambda: cuda_curve.proj_add_mixed(W, *a7, i7)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_add_mixed_plain(W, *a7, i7), PLAIN_REPS),
                   f"W={width}", (8 * 32 + 1) * 4 * width, 11 * mm12 * int((~on).sum().item()))
    del a7, got, want

    # K8 on the 32-limb field: batch_inverse's one Fermat inverse (affine mode,
    # to_affine)
    e32 = F.p - 2
    x1 = field_elems(F, 1)
    kernel_row("k8_bls", "exp_const_n32", "K8", src + "montmul.cu",
               "msm_zprize_tpu/fields/pallas_mul.py:237",
               mod_p_err(F, [cuda_mul.exp_const(F, x1, e32)], [F.exp_const_plain(x1, e32)]),
               _cuda_ms(torch, lambda: cuda_mul.exp_const(F, x1, e32)),
               _cuda_ms(torch, lambda: F.exp_const_plain(x1, e32), PLAIN_REPS),
               f"(32, 1), e = p - 2", 2 * 32 * 4, (e32.bit_length() + bin(e32).count("1")) * mm12)

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

    # codec storage: K13 on PackedCodec (n = 32, beta * x of the packed MSM)
    # and Fma51Codec (n = 22); K14 = K3-K7 on 13-row PackedCodec storage
    Wp = curve.ops_packed
    pc, r13 = Wp.codec, Wp.codec.rows
    fc51 = Fma51Codec(FE.p)
    for key, G, codec, mm in (("k13", F, pc, mm12), ("k13_fma51", FE, fc51, mm8)):
        x, y = codec.from_digits(G, field_elems(G, N)), codec.from_digits(G, field_elems(G, N))
        kernel_row(key, f"montmul_rows_{type(codec).__name__}", "K13", src + "montmul.cu",
                   "msm_zprize_tpu/fields/fma51_pallas.py:302",
                   rows_err(G, codec, [cuda_codec.montmul_rows(G, codec, x, y)],
                            [cuda_codec.montmul_rows_plain(G, codec, x, y)]),
                   _cuda_ms(torch, lambda: cuda_codec.montmul_rows(G, codec, x, y)),
                   _cuda_ms(torch, lambda: cuda_codec.montmul_rows_plain(G, codec, x, y), PLAIN_REPS),
                   f"({codec.rows}, {N}), n = {G.n}", 3 * codec.rows * 4 * N, mm * N)
    del x, y

    def prow(width):
        return pc.from_digits(F, field_elems(F, width))

    k14 = "msm_zprize_tpu/curves/pallas_curve.py:149"
    a3 = [prow(lanes1), prow(lanes1), flags(lanes1), flags(lanes1),
          prow(lanes1), prow(lanes1), flags(lanes1), flags(lanes1)]
    kernel_row("k14_k3", "aff_pair_add_packed", "K14-K3", src + "curve_codec.cu", k14,
               rows_err(F, pc, cuda_curve.aff_pair_add(Wp, *a3), cuda_curve.aff_pair_add_plain(Wp, *a3)),
               _cuda_ms(torch, lambda: cuda_curve.aff_pair_add(Wp, *a3)),
               _cuda_ms(torch, lambda: cuda_curve.aff_pair_add_plain(Wp, *a3), PLAIN_REPS),
               f"W={lanes1}, {r13} rows", (7 * r13 + 4) * 4 * lanes1, 9 * mm12 * lanes1)
    del a3
    a4 = [prow(lanes1 // 2) for _ in range(6)]
    kernel_row("k14_k4", "proj_add_packed", "K14-K4", src + "curve_codec.cu", k14,
               rows_err(F, pc, cuda_curve.proj_add(Wp, *a4), cuda_curve.proj_add_plain(Wp, *a4)),
               _cuda_ms(torch, lambda: cuda_curve.proj_add(Wp, *a4)),
               _cuda_ms(torch, lambda: cuda_curve.proj_add_plain(Wp, *a4), PLAIN_REPS),
               f"W={lanes1 // 2}, {r13} rows", 9 * r13 * 4 * (lanes1 // 2), 12 * mm12 * (lanes1 // 2))
    del a4
    for width, k in ((K, c0), (1, c)):
        a5 = [prow(width) for _ in range(3)]
        kernel_row("k14_k5", "proj_double_k_packed", "K14-K5", src + "curve_codec.cu", k14,
                   rows_err(F, pc, cuda_curve.proj_double_k(Wp, *a5, k),
                            cuda_curve.proj_double_k_plain(Wp, *a5, k)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_double_k(Wp, *a5, k)),
                   _cuda_ms(torch, lambda: cuda_curve.proj_double_k_plain(Wp, *a5, k), PLAIN_REPS),
                   f"W={width}, k={k}, {r13} rows", 6 * r13 * 4 * width, 8 * k * mm12 * width)
    # the K14 variants on no path of the codec modes (those run only the
    # projective pipeline), at small widths; pass-through lanes bit for bit
    a4 = [prow(SMALL) for _ in range(6)]
    m4 = flags(SMALL)
    got, want = cuda_curve.proj_add(Wp, *a4, mask=m4), cuda_curve.proj_add_plain(Wp, *a4, mask=m4)
    off = m4 == 0
    kernel_row("k14_k4m", "proj_add_masked_packed", "K14-K4m", src + "curve_codec.cu", k14,
               max(rows_err(F, pc, got, want),
                   raw_err([g[:, off] for g in got], [a[:, off] for a in a4[:3]])),
               _cuda_ms(torch, lambda: cuda_curve.proj_add(Wp, *a4, mask=m4)),
               _cuda_ms(torch, lambda: cuda_curve.proj_add_plain(Wp, *a4, mask=m4), PLAIN_REPS),
               f"W={SMALL}, masked, {r13} rows", (9 * r13 + 1) * 4 * SMALL,
               12 * mm12 * int(m4.sum().item()))
    kernel_row("k14_k6", "proj_double_packed", "K14-K6", src + "curve_codec.cu", k14,
               rows_err(F, pc, cuda_curve.proj_double(Wp, *a4[:3]),
                        cuda_curve.proj_double_plain(Wp, *a4[:3])),
               _cuda_ms(torch, lambda: cuda_curve.proj_double(Wp, *a4[:3])),
               _cuda_ms(torch, lambda: cuda_curve.proj_double_plain(Wp, *a4[:3]), PLAIN_REPS),
               f"W={SMALL}, {r13} rows", 6 * r13 * 4 * SMALL, 8 * mm12 * SMALL)
    got, want = (cuda_curve.proj_add_mixed(Wp, *a4[:5], m4),
                 cuda_curve.proj_add_mixed_plain(Wp, *a4[:5], m4))
    on = m4 == 1
    kernel_row("k14_k7", "proj_add_mixed_packed", "K14-K7", src + "curve_codec.cu", k14,
               max(rows_err(F, pc, got, want),
                   raw_err([g[:, on] for g in got], [a[:, on] for a in a4[:3]])),
               _cuda_ms(torch, lambda: cuda_curve.proj_add_mixed(Wp, *a4[:5], m4)),
               _cuda_ms(torch, lambda: cuda_curve.proj_add_mixed_plain(Wp, *a4[:5], m4), PLAIN_REPS),
               f"W={SMALL}, {r13} rows", (8 * r13 + 1) * 4 * SMALL,
               11 * mm12 * int((~on).sum().item()))
    del a4, got, want
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
    known = {}  # label -> (points on the card, discrete logs) of the 2^16 MSMs
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
        known[label] = (points, logs)
        if label == "bls12-377":
            known_ints = (pts_n, logs)
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

    # ---- 9-10. the other modes at 2^16 ---------------------------------------------
    def launches_of(counts, keys, what):
        """The run's launches of each kernel of its path; none may be 0."""
        got = {k: counts.get(k, 0) for k in keys}
        missing = [k for k, v in got.items() if v == 0]
        if missing:
            raise AssertionError(f"{what}: kernels of the path were not launched: {missing}")
        return got

    def drive(what, run, keys, check, absent=()):
        """One run with the counts set to 0 just before it and read just
        after, its check (and no launch of the kernels in ``absent``), then
        MODE_WARMUP + MODE_RUNS timed runs of the same inputs. Returns the
        first run's launches of the kernels in ``keys`` and ``absent``."""
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = counters.snapshot()
        check(out)
        launches = launches_of(counts, keys, what)
        stray = {k: counts[k] for k in absent if counts.get(k, 0)}
        if stray:
            raise AssertionError(f"{what}: launched kernels that are off its path: {stray}")
        launches.update({k: counts.get(k, 0) for k in absent})
        times = []
        for i in range(MODE_WARMUP + MODE_RUNS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i >= MODE_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
        total = sum(v for k, v in counts.items() if k.startswith("k"))
        print(f"    {what}: first run {first_ms:.1f} ms; {statistics.median(times):.2f} +- "
              f"{statistics.stdev(times):.2f} ms (median +- sigma of {MODE_RUNS} runs after "
              f"{MODE_WARMUP} warmups) on {card}; runs {[round(t, 2) for t in times]}; launches "
              f"{launches} ({total} kernel launches in all); host syncs {counts.get('host_sync', 0)}")
        return launches

    points, logs = known["bls12-377"]
    scal = curve.random_scalars(N, seed=SEED + 1, device=dev)
    want = expected_msm(BLS12_377, curve.scalar.unpack(scal.cpu()), logs)

    def equals_known(what, cv, want_):
        def check(res):
            if cv.result_to_int(res) != want_:
                raise AssertionError(f"{what} disagrees with the known-discrete-log result")
        return check

    z = field_elems(F, N)  # random Z (< 2^376 < p, nonzero with overwhelming odds)
    proj = ProjectivePoints(F.montmul(points.x, z), F.montmul(points.y, z), z)
    glv = (cuda_mul.KERNEL, cuda_scalar.KERNEL)
    finals = (cuda_curve.K4, cuda_curve.K5)
    print(f"[9 modes 2^{LOG_N}] bls12-377: each result equals (sum s_i a_i mod q) G")
    mode_launches = {}
    for what, run, keys in (
        ("msm(mode='affine')", lambda: curve.msm(scal, points, mode="affine"),
         glv + (cuda_mul.K8, cuda_curve.K7) + finals),
        ("msm_unsafe(mode='affine')", lambda: curve.msm_unsafe(scal, points, mode="affine"),
         glv + (cuda_mul.K8, cuda_curve.K7) + finals),
        ("msm(mode='halving')", lambda: curve.msm(scal, points, mode="halving"),
         glv + (cuda_curve.K4M,) + finals),
        ("msm_projective (random Z)", lambda: curve.msm_projective(scal, proj),
         (cuda_scalar.K9,) + finals),
    ):
        mode_launches[what] = drive(f"bls12-377 {what}", run, keys,
                                    equals_known(f"bls12-377 {what}", curve, want))
    del proj

    points_e, logs_e = known["ed-on-bls12-377"]
    scal_e = ed.random_scalars(N, seed=SEED + 1, device=dev)
    want_e = ed_expected_msm(ED_ON_BLS12_377, ed.scalar.unpack(scal_e.cpu()), logs_e)
    print(f"[10 modes 2^{LOG_N}] ed-on-bls12-377: the result equals (sum s_i a_i mod q) G")
    drive("ed-on-bls12-377 msm(mode='basic')", lambda: ed.msm(scal_e, points_e, mode="basic"),
          (cuda_scalar.K9, cuda_edwards.K11, cuda_edwards.K12),
          equals_known("ed-on-bls12-377 msm(mode='basic')", ed, want_e))

    # ---- 11. random_points_fast -------------------------------------------------------
    print(f"[11 random points 2^{LOG_N}] random_points_fast on both curves")
    sample = torch.as_tensor(np.sort(rng.choice(N, SAMPLE, replace=False)))
    for label, cv, keys in (
        ("bls12-377", curve, (cuda_curve.K7, cuda_mul.KERNEL, cuda_mul.K8)),
        ("ed-on-bls12-377", ed, (cuda_edwards.K11, cuda_mul.KERNEL, cuda_mul.K8)),
    ):
        is_w = cv is curve
        rows, picks = cv.random_points_table(N, seed=SEED)

        def check(pts, cv=cv, rows=rows, picks=picks, is_w=is_w, label=label):
            O = cv.oracle
            on = cv.ops.affine_is_on_curve(pts) if is_w else cv.ops.is_on_curve(pts)
            if not bool(on.all()):
                raise AssertionError(f"{label}: random_points_fast lanes off the curve")
            sub = type(pts)(*(a.index_select(-1, sample.to(dev)) for a in pts))
            host = []
            for i in sample.tolist():
                acc = O.zero
                for k, row in enumerate(rows):
                    acc = O.add(acc, row[int(picks[k, i])])
                host.append(acc)
            if is_w:
                ok = cv.ops.unpack_affine(sub) == host
            else:
                got = cv.ops.unpack(sub)
                ok = all((X * pow(Z, -1, O.p) % O.p, Y * pow(Z, -1, O.p) % O.p) == O.to_affine(h)
                         for (X, Y, Z, _), h in zip(got, host))
            if not ok:
                raise AssertionError(f"{label}: random_points_fast lanes differ from the host sums")

        launches = drive(f"{label} random_points_fast({N})",
                         lambda cv=cv: cv.random_points_fast(N, seed=SEED, device=dev), keys, check)
        pts = cv.random_points_fast(N, seed=SEED, device=dev)
        s2 = cv.random_scalars(N, seed=SEED + 2, device=dev)
        a, b = (("affine", "projective") if is_w else ("basic", "padded"))
        if cv.result_to_int(cv.msm(s2, pts, mode=a)) != cv.result_to_int(cv.msm(s2, pts, mode=b)):
            raise AssertionError(f"{label}: the {a} and {b} MSMs over random points disagree")
        msg = f"the {a}- and {b}-mode MSMs over them agree"
        if is_w:
            mode_launches["random_points_fast"] = launches
            # q P == 0 on the card for the sampled lanes: 252 K6 doublings
            sub = AffinePoints(*(t.index_select(-1, sample.to(dev)) for t in pts))
            counters.reset()
            qP = W.proj_scale_const(BLS12_377.order, W.from_affine(sub))
            torch.cuda.synchronize()
            mode_launches["subgroup check"] = launches_of(
                counters.snapshot(), (cuda_curve.K6, cuda_curve.K4), "subgroup check")
            if not bool(F.is_zero(qP.Z).all()):
                raise AssertionError("random_points_fast lanes outside the prime-order subgroup")
            msg += (f"; q P = 0 for the {SAMPLE} sampled lanes (launches "
                    f"{mode_launches['subgroup check']})")
        print(f"    {label}: every lane on the curve (on the card), {SAMPLE} sampled lanes equal "
              f"the host sums of their picks; {msg}")

    # ---- 12. the codec storage mode ------------------------------------------------
    print(f"[12 packed 2^{LOG_N}] bls12-377 on PackedCodec rows ({Wp.codec.rows} of 31 bits a "
          "coordinate): each result equals (sum s_i a_i mod q) G")
    points, _ = known["bls12-377"]
    packed_keys = (cuda_codec.K13, cuda_scalar.KERNEL) + tuple(
        cuda_curve.K14[k] for k in (cuda_curve.K3, cuda_curve.K4, cuda_curve.K5))
    # off the packed path: K1 (beta x runs on K13), K13 on Fma51Codec, and
    # the K14 variants the projective pipeline does not run
    packed_absent = (cuda_mul.KERNEL, cuda_codec.K13_FMA51) + tuple(
        cuda_curve.K14[k] for k in (cuda_curve.K4M, cuda_curve.K6, cuda_curve.K7))
    for what, run in (
        ("msm(mode='projective')", lambda: curve.msm(scal, points)),
        ("msm(mode='packed')", lambda: curve.msm(scal, points, mode="packed")),
        ("msm_unsafe(mode='packed')", lambda: curve.msm_unsafe(scal, points, mode="packed")),
    ):
        packed = "packed" in what
        mode_launches[what] = drive(
            f"bls12-377 {what}", run,
            packed_keys if packed else (cuda_mul.KERNEL, cuda_scalar.KERNEL, cuda_curve.K3),
            equals_known(f"bls12-377 {what}", curve, want),
            absent=packed_absent if packed else ())
    pts_n, logs_n = known_ints
    scs_n = curve.scalar.unpack(scal.cpu())
    dup_pts, dup_logs = pts_n[:-1] + [pts_n[0]], logs_n[:-1] + [logs_n[0]]
    for what, pts_i, logs_i in (("distinct points", pts_n, logs_n),
                                ("a duplicated point", dup_pts, dup_logs)):
        t0 = time.perf_counter()
        got = compute_msm(pts_i, scs_n, mode="packed", device=dev)
        secs = time.perf_counter() - t0
        if got != expected_msm(BLS12_377, scs_n, logs_i):
            raise AssertionError(f"compute_msm(mode='packed') with {what} disagrees with the host oracle")
        print(f"    compute_msm({N} int points and scalars, mode='packed') with {what}: equals the "
              f"known-discrete-log result; {secs:.2f} s with the int conversions")

    # the new kernels' launches: per run of the path each serves first; the
    # K14 variants no codec-mode path runs, and K13 on Fma51Codec, as the
    # packed run's counts read them (0, checked there)
    src_runs = {"k4m": ("msm(mode='halving')", cuda_curve.K4M),
                "k6": ("subgroup check", cuda_curve.K6),
                "k7": ("msm(mode='affine')", cuda_curve.K7),
                "k8_bls": ("msm(mode='affine')", cuda_mul.K8),
                "k13": ("msm(mode='packed')", cuda_codec.K13),
                "k13_fma51": ("msm(mode='packed')", cuda_codec.K13_FMA51)}
    for k in (cuda_curve.K3, cuda_curve.K4, cuda_curve.K4M, cuda_curve.K5, cuda_curve.K6,
              cuda_curve.K7):
        src_runs["k14_" + k.split("_")[0]] = ("msm(mode='packed')", cuda_curve.K14[k])
    for row in table:
        src_run = src_runs.get(row["key"])
        if src_run is not None:
            row["launches"] = mode_launches[src_run[0]][src_run[1]]

    # one entry per kernel and path: its main-path shape's numbers (the first
    # row, the widest), its worst error
    unset = sorted({row["id"] for row in table if row["launches"] is None})
    if unset:
        raise AssertionError(f"no path run counted the launches of {unset}")
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
