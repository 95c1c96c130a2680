#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MSM paths end to end on one GPU: the
BLS12-377 MSM in its four modes (the codec storage mode "packed" among
them) and on projective inputs, the ed-on-bls12-377 twisted-Edwards MSM in
its two modes, the device generator of random points, ``compute_msm``, and
the BLS12-381 and Pallas MSMs (Pallas also on Fma51Codec rows, "fma51").

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is
non-zero and no result line is printed):

1. device: the card's name and power limit, and the kernel build
   (one ``nvcc`` per source into ``build/``, with the ptxas register,
   stack and spill lines, and each curve kernel's SASS instructions and
   local loads/stores from ``cuobjdump -sass``);
2. every kernel of every path against its plain PyTorch twin on the card,
   at the shapes the 2^16 MSMs give it (K2 and K9 bit-exact, the others
   exact mod p, the pass-through lanes of K4m and K7 bit for bit), with the
   card's own time per call (CUDA-graph replay, so no host enqueue time),
   the twin's CUDA-event time, and the bound: the least time the card could
   take for the same work. K4, K4m and K5 run every built instance (G
   threads a point, as the kernels' library lists them), each against the
   twin and timed twice in turns, K4 over the main path's widths on limbs
   (450,560 down to 1 at 2^16); the row's time is the instance the kernels'
   width table picks. The timed calls replay one input set, which stays in
   the 50 MB L2 below ~45k lanes; per-MSM sums come from ``profile_msm``.
   K5's line also gives its latency floor: its dependent product levels
   times one product's latency (K8's time over its products);
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
    inputs, without and with a duplicated point, against the host oracle;
13. BLS12-381 (n = 33 limbs, R = 2^396): the MSM at N = 8 and its edge cases
    against both host oracles; ``msm`` in ``"projective"`` and ``"packed"``
    (13 rows) at 2^16 against the known-discrete-log result, with the launch
    counts of each path (each > 0; K1 = 0 on ``"packed"``), 2 warmups and 5
    timed runs; then at N = 8 the other modes (``"affine"``,
    ``msm_unsafe``, ``"halving"``, ``msm_projective``), ``random_points_fast``
    and a subgroup check of its points on the card (K6);
14. Pallas (n = 22, 4p > 2^256) the same way, with ``"fma51"`` (10 Fma51Codec
    pair rows: K13 and the K14 variants on them) in place of ``"packed"`` at
    2^16, and ``"packed"`` (9 rows) among the modes at N = 8.

Phase 2 holds the kernels of phases 13-14 too: K1, K2, K8 and K3-K7 on each
curve's limbs, K13 and the K14 variants on each of its codec storages.

The second-to-last line is the kernel table as JSON, the last the result.
Nothing of JAX or of the JAX package is imported: the port stands alone.
"""

from __future__ import annotations

import json
import random
import re
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
    to enqueue a call than the card to run it, this is the host's time (the
    plain twins' timing)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps=REPS) -> float:
    """The card's own time of one fn() call in ms: a CUDA graph of reps
    back-to-back calls, replayed once untimed and once between two CUDA
    events, so that no host enqueue time is in it (the kernels' timing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _sass_sizes(bindir: Path, lib: Path) -> dict:
    """SASS instructions and local-memory loads and stores (LDL, STL) of each
    curve kernel of the built library, by demangled name (``cuobjdump
    -sass`` and ``cu++filt`` of the toolkit in ``bindir``)."""
    out = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            sizes[name] = [0, 0]
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            sizes[name][0] += 1
            sizes[name][1] += bool(re.search(r"\b(LDL|STL)", line))
    names = [k for k in sizes if "wei" in k]
    plain = subprocess.run([str(bindir / "cu++filt")], input="\n".join(names), capture_output=True,
                           text=True, check=True, timeout=60).stdout.splitlines()
    return {p.replace("msm::", "").replace("wei::", ""): sizes[k] for k, p in zip(names, plain)}


def main() -> None:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    from msm_zprize_tpu_torch import _build, counters
    from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
    from msm_zprize_tpu_torch.curves.params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
    from msm_zprize_tpu_torch.curves.weierstrass import AffinePoints, ProjectivePoints
    from msm_zprize_tpu_torch.fields import cuda_codec, cuda_mul, cuda_scalar
    from msm_zprize_tpu_torch.fields.codec import Fma51Codec
    from msm_zprize_tpu_torch.fields.scalar import signed_digits
    from msm_zprize_tpu_torch.msm.common import default_windows, window_size
    from msm_zprize_tpu_torch.msm.engine import slot_count
    from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
    from msm_zprize_tpu_torch.submission import compute_msm
    from msm_zprize_tpu_torch.testing.bounds import HBM_BYTES_PER_S, bound_ms, imad_per_s, mont_imads
    from msm_zprize_tpu_torch.testing.points import (
        ed_expected_msm, ed_naive_msm, ed_points_with_logs, expected_msm, naive_msm,
        points_with_logs,
    )

    if "jax" in sys.modules or "msm_zprize_tpu" in sys.modules:
        raise AssertionError("the port must import nothing of JAX or the JAX package")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = _smi("name,power.limit")
    imad_rate = imad_per_s(torch)

    # ---- 1. device and build --------------------------------------------------
    print(card)  # name, power limit: as nvidia-smi reports them
    t0 = time.perf_counter()
    _, info = _build.library()
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel build {info.seconds:.1f} s (nvcc), load {time.perf_counter() - t0:.1f} s | "
          f"bound rates: {HBM_BYTES_PER_S / 1e12:.2f} TB/s, {imad_rate / 1e12:.2f} T IMAD/s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")
    for name, (count, local) in _sass_sizes(Path(_build._nvcc()).resolve().parent, info.path).items():
        print(f"    sass: {count} instructions, {local} local loads/stores: {name}")

    rng = np.random.default_rng(SEED)

    def field_elems(G, width, edges=()):
        """Random Montgomery-form elements below 2^(bits(p) - 1) < p, on the
        card; the first lanes hold ``edges`` (values the kernels take) where
        the width allows."""
        limbs = rng.integers(0, 1 << 12, size=(G.n, width), dtype=np.int32)
        keep = np.clip(G.p.bit_length() - 1 - 12 * np.arange(G.n), 0, 12)
        limbs &= ((1 << keep) - 1).astype(np.int32)[:, None]
        k = min(len(edges), width)
        if k:
            limbs[:, :k] = G.pack(list(edges[:k]), montgomery=False)
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
    # Each row names the smoke run whose launch counts (set to 0 just before
    # it, read just after) give its launches, and the counter it reads there.
    table = []

    def kernel_row(key, name, kid, source, replaces, run, counter, err, ms, plain_ms, shape,
                   nbytes, imads):
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain twin at {shape}: max err {err}")
        bound, bound_by = bound_ms(nbytes, imads, imad_rate)
        print(f"[2 kernel] {kid} {name} {shape}: equal to plain twin (max err {err}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({bound_by})")
        table.append(dict(key=key, name=name, id=kid, route="cuda", source=src + source,
                          replaces=replaces, run=run, counter=counter, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                          library_ms=None, shape=shape))

    src = "msm_zprize_tpu_torch/csrc/"
    curve_line = "msm_zprize_tpu/curves/pallas_curve.py:{}".format

    def weierstrass_rows(cv, tag, units, runs):
        """K1, K2, K8 and K3-K7 of one Weierstrass curve at the shapes of its
        2^16 MSM, on each storage in ``units`` ((ops, curve unit, run of its
        K3-K5; limbs first): K13 and the K14 variants on a codec storage. The
        first lanes of every field operand are 2p - 1 and 2p - 2 (sums past
        2^256 on Pallas); K1's also take 4p - 1 (its inputs are < 4p).
        ``runs`` names the smoke runs that give the launches of K1/K2
        ("proj"), K8 and K7 ("affine"), K4m ("halving") and K6 ("subgroup")."""
        G, Sg = cv.ops.F, cv.scalar
        n, nw, _ = _build.FIELD_SHAPES[_build.field_shape(G)]
        mm = mont_imads(nw, 12 * n > 32 * nw)
        edges = (2 * G.p - 1, 2 * G.p - 2)
        cg = window_size("batched-affine", LOG_N)
        Kg, Lg = default_windows(Sg.max_bits, cg), 1 << (cg - 1)
        w1 = (slot_count(2 * N, Lg) // 2) * Kg * Lg  # level-1 pairs of the main round
        wh = Kg * ((2 * N + Lg) // 2 + 1)  # level 1 of the halving engine
        c0g = max((cg - 1) // 2, 1)
        wr = Kg * (Lg >> c0g)  # the affine reduction's mixed adds

        x, y = field_elems(G, N, edges + (4 * G.p - 1,)), field_elems(G, N, (4 * G.p - 1,) + edges)
        kernel_row(f"k1_{tag}", f"montmul_{tag}", "K1", "montmul.cu",
                   "msm_zprize_tpu/fields/pallas_mul.py:167", runs["proj"], cuda_mul.KERNEL,
                   mod_p_err(G, [cuda_mul.montmul(G, x, y)], [G.montmul_plain(x, y)]),
                   _graph_ms(torch, lambda: cuda_mul.montmul(G, x, y)),
                   _cuda_ms(torch, lambda: G.montmul_plain(x, y), PLAIN_REPS), f"({n}, {N})",
                   3 * n * 4 * N, mm * N)
        e = G.p - 2  # batch_inverse's one Fermat inverse, on one lane
        k8_ms = _graph_ms(torch, lambda: cuda_mul.exp_const(G, x[:, :1], e))
        k8_products = e.bit_length() + bin(e).count("1")
        product_ms = k8_ms / k8_products  # one dependent product's latency on one lane
        kernel_row(f"k8_{tag}", f"exp_const_{tag}", "K8", "montmul.cu",
                   "msm_zprize_tpu/fields/pallas_mul.py:237", runs["affine"], cuda_mul.K8,
                   mod_p_err(G, [cuda_mul.exp_const(G, x[:, :1], e)], [G.exp_const_plain(x[:, :1], e)]),
                   k8_ms, _cuda_ms(torch, lambda: G.exp_const_plain(x[:, :1], e), PLAIN_REPS),
                   f"({n}, 1), e = p - 2", 2 * n * 4, k8_products * mm)
        print(f"    one dependent product's latency on {tag} (K8 on one lane over its "
              f"{k8_products} products): {product_ms * 1e3:.3f} us")

        def instances(kernel, shape, args, err_of, inst, plain, chain=0):
            """Every built instance of ``kernel`` (G threads a point) against
            the twin on ``args``, each timed twice in turns (G ascending, then
            descending); prints them and, for a chain of ``chain`` dependent
            product levels, its latency floor; returns (the worst error, the
            width table's pick's time, the twin's time) for its row."""
            want = plain(args)
            gs = cuda_curve._groups(G, kernel)
            worst = max(err_of(inst(g, args), want) for g in gs)
            del want
            times = {g: [] for g in gs}
            for g in gs + gs[::-1]:
                times[g].append(_graph_ms(torch, lambda: inst(g, args)))
            ms = {g: sum(t) / len(t) for g, t in times.items()}
            pick = cuda_curve._group_for(G, kernel, args[0].shape[-1])
            floor = (f"; latency floor {chain} product levels x {product_ms * 1e3:.3f} us = "
                     f"{chain * product_ms:.4f} ms" if chain else "")
            print(f"[2 instances] {kernel} {tag} {shape}: width table's G = {pick}; "
                  + ", ".join(f"G={g} {ms[g]:.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
                              for g, t in times.items()) + floor)
            return worst, ms[pick], _cuda_ms(torch, lambda: plain(args), PLAIN_REPS)
        scal = cv.random_scalars(N, seed=SEED, device=dev)
        gm, gs = cuda_scalar.glv_digits(Sg, scal, cg, Kg)
        wm, ws = cuda_scalar.glv_digits_plain(Sg, scal, cg, Kg)
        if not (torch.equal(gm, wm) and torch.equal(gs, ws)):
            raise AssertionError(f"K2 glv_digits on {tag} is not bit-identical to its plain twin")
        muls = 2 * Sg.n * len(Sg.m0) + 4 * sum(
            1 for i in range(Sg.n_half + 1) for j in range(Sg.n_half) if i + j < Sg.n_acc)
        kernel_row(f"k2_{tag}", f"glv_digits_{tag}", "K2", "glv_digits.cu",
                   "msm_zprize_tpu/fields/pallas_scalar.py:279", runs["proj"], cuda_scalar.KERNEL,
                   max((gm - wm).abs().max().item(), (gs - ws).abs().max().item()),
                   _graph_ms(torch, lambda: cuda_scalar.glv_digits(Sg, scal, cg, Kg)),
                   _cuda_ms(torch, lambda: cuda_scalar.glv_digits_plain(Sg, scal, cg, Kg), PLAIN_REPS),
                   f"N={N}, c={cg}, K={Kg}", (Sg.n + 4 * Kg) * 4 * N, muls * N)
        del x, y, scal, gm, gs, wm, ws

        for Wc, unit, run in units:
            codec = getattr(Wc, "codec", None)
            if codec is None:
                nr, cname, pre, side = n, "", "", runs
                keys = {k: k for k in cuda_curve.KERNEL_IDS}
                kid = lambda k: k
                err = lambda got, want: mod_p_err(G, got, want)
                elem = lambda width: field_elems(G, width, edges)
            else:
                # K4m, K6 and K7 are on no path of a codec mode: 0 launches in
                # its run; they are timed at a small width
                fma = isinstance(codec, Fma51Codec)
                nr, cname = codec.rows, "_" + type(codec).__name__
                pre, keys = ("k14_fma51_", cuda_curve.K14_FMA51) if fma else ("k14_", cuda_curve.K14)
                side = {"halving": run, "subgroup": run, "affine": run}
                kid = lambda k: "K14-" + k
                err = lambda got, want, codec=codec: rows_err(G, codec, got, want)
                elem = lambda width, codec=codec: codec.from_digits(G, field_elems(G, width, edges))
                x, y = elem(N), elem(N)
                kernel_row(f"{'k13_fma51' if fma else 'k13'}_{tag}", f"montmul_rows{cname}_{tag}",
                           "K13", "montmul.cu", "msm_zprize_tpu/fields/fma51_pallas.py:302", run,
                           cuda_codec.K13_FMA51 if fma else cuda_codec.K13,
                           rows_err(G, codec, [cuda_codec.montmul_rows(G, codec, x, y)],
                                    [cuda_codec.montmul_rows_plain(G, codec, x, y)]),
                           _graph_ms(torch, lambda: cuda_codec.montmul_rows(G, codec, x, y)),
                           _cuda_ms(torch, lambda: cuda_codec.montmul_rows_plain(G, codec, x, y),
                                    PLAIN_REPS),
                           f"({nr}, {N}), n = {n}", 3 * nr * 4 * N, mm * N)
                del x, y

            def row(k, name, line, run_, *rest):
                kernel_row(f"{pre}{k.lower()}_{tag}", f"{name}{cname}_{tag}", kid(k), unit,
                           curve_line(line) if codec is None else curve_line(149), run_,
                           keys[getattr(cuda_curve, k.upper())], *rest)

            a3 = [elem(w1), elem(w1), flags(w1), flags(w1), elem(w1), elem(w1), flags(w1), flags(w1)]
            row("K3", "aff_pair_add", 372, run,
                err(cuda_curve.aff_pair_add(Wc, *a3), cuda_curve.aff_pair_add_plain(Wc, *a3)),
                _graph_ms(torch, lambda: cuda_curve.aff_pair_add(Wc, *a3)),
                _cuda_ms(torch, lambda: cuda_curve.aff_pair_add_plain(Wc, *a3), PLAIN_REPS),
                f"W={w1}, {nr} rows", (7 * nr + 4) * 4 * w1, 9 * mm * w1)
            del a3
            # K4, K4m and K5: every instance (G threads a point) against the
            # twin and timed in turns; the row's time is the width table's pick
            # limbs: the main round's tree levels, the compact residual's
            # 8 x 2048 lanes, the fold and reduction widths Kg Lg 2^(1-i)
            # (45,056 down to 176 at 2^16) and Horner's 1
            k4_widths = ((w1 // 2, w1 // 4, w1 // 8, 2 * Kg * Lg, Kg * Lg, 8 * 2048)
                         + tuple(Kg * Lg >> i for i in range(1, 6)) + (Kg * Lg >> 7, 1)
                         if codec is None else (w1 // 2, 1))
            for width in k4_widths:
                a4 = [elem(width) for _ in range(6)]
                row("K4", "proj_add", 382, run, *instances(
                    cuda_curve.K4, f"W={width}, {nr} rows", a4, err,
                    lambda G, a: cuda_curve._proj_add(Wc, G, *a),
                    lambda a: cuda_curve.proj_add_plain(Wc, *a)),
                    f"W={width}, {nr} rows", 9 * nr * 4 * width, 12 * mm * width)
            for width, k in ((Kg, c0g), (1, cg)):
                a5 = [elem(width) for _ in range(3)]
                row("K5", "proj_double_k", 324, run, *instances(
                    cuda_curve.K5, f"W={width}, k={k}, {nr} rows", a5, err,
                    lambda G, a, k=k: cuda_curve._proj_double_k(Wc, G, *a, k),
                    lambda a, k=k: cuda_curve.proj_double_k_plain(Wc, *a, k), chain=2 * k),
                    f"W={width}, k={k}, {nr} rows", 6 * nr * 4 * width, 8 * k * mm * width)
            wm4 = wh if codec is None else SMALL
            a4 = [elem(wm4) for _ in range(6)]
            m4 = flags(wm4)
            off = m4 == 0  # masked-off lanes are P1, bit for bit
            row("K4m", "proj_add_masked", 382, side["halving"], *instances(
                cuda_curve.K4M, f"W={wm4}, masked, {nr} rows", a4,
                lambda got, want: max(err(got, want),
                                      raw_err([g[:, off] for g in got], [a[:, off] for a in a4[:3]])),
                lambda G, a: cuda_curve._proj_add(Wc, G, *a, mask=m4),
                lambda a: cuda_curve.proj_add_plain(Wc, *a, mask=m4)),
                f"W={wm4}, masked, {nr} rows", (9 * nr + 1) * 4 * wm4, 12 * mm * int(m4.sum().item()))
            del a4, a5
            a6 = [elem(SAMPLE) for _ in range(3)]  # the subgroup check's width
            row("K6", "proj_double", 394, side["subgroup"],
                err(cuda_curve.proj_double(Wc, *a6), cuda_curve.proj_double_plain(Wc, *a6)),
                _graph_ms(torch, lambda: cuda_curve.proj_double(Wc, *a6)),
                _cuda_ms(torch, lambda: cuda_curve.proj_double_plain(Wc, *a6), PLAIN_REPS),
                f"W={SAMPLE}, {nr} rows", 6 * nr * 4 * SAMPLE, 8 * mm * SAMPLE)
            # the affine reduction's width and random_points_fast's
            for width in ((wr, N) if codec is None else (SMALL,)):
                a7 = [elem(width) for _ in range(5)]
                i7 = flags(width)
                got, want = (cuda_curve.proj_add_mixed(Wc, *a7, i7),
                             cuda_curve.proj_add_mixed_plain(Wc, *a7, i7))
                on = i7 == 1  # lanes with an infinite affine operand are P1
                row("K7", "proj_add_mixed", 397, side["affine"],
                    max(err(got, want), raw_err([g[:, on] for g in got], [a[:, on] for a in a7[:3]])),
                    _graph_ms(torch, lambda: cuda_curve.proj_add_mixed(Wc, *a7, i7)),
                    _cuda_ms(torch, lambda: cuda_curve.proj_add_mixed_plain(Wc, *a7, i7), PLAIN_REPS),
                    f"W={width}, {nr} rows", (8 * nr + 1) * 4 * width, 11 * mm * int((~on).sum().item()))
            del a7, got, want

    curve = Weierstrass.create(BLS12_377)
    W, F = curve.ops, curve.ops.F
    ed = TwistedEdwards.create(ED_ON_BLS12_377)
    E, FE, SE = ed.ops, ed.ops.F, ed.scalar
    c381, cpal = Weierstrass.create(BLS12_381), Weierstrass.create(PALLAS)
    N = 1 << LOG_N
    weierstrass_rows(curve, "bls12-377", (
        (curve.ops, "curve.cu", "bls12-377 msm 2^16"),
        (curve.ops_packed, "curve_codec.cu", "bls12-377 msm(mode='packed')"),
    ), dict(proj="bls12-377 msm 2^16", affine="bls12-377 msm(mode='affine')",
            halving="bls12-377 msm(mode='halving')", subgroup="bls12-377 subgroup check"))

    # ed-on-bls12-377 path (n = 22, R = 2^264)
    mm8 = mont_imads(8, True)
    ed_run = "ed-on-bls12-377 msm 2^16"
    ce = window_size("edwards", LOG_N)
    Ke, Le = default_windows(SE.bits, ce), 1 << (ce - 1)
    lanes1e = (slot_count(N, Le) // 2) * Ke * Le
    n22 = FE.n
    x, y = field_elems(FE, N), field_elems(FE, N)
    kernel_row("k1_ed", "montmul_n22", "K1", "montmul.cu",
               "msm_zprize_tpu/fields/pallas_mul.py:167", ed_run, cuda_mul.KERNEL,
               mod_p_err(FE, [cuda_mul.montmul(FE, x, y)], [FE.montmul_plain(x, y)]),
               _graph_ms(torch, lambda: cuda_mul.montmul(FE, x, y)),
               _cuda_ms(torch, lambda: FE.montmul_plain(x, y), PLAIN_REPS), f"({n22}, {N})",
               3 * n22 * 4 * N, mm8 * N)

    e = FE.p - 2  # batch_inverse's one Fermat inverse, on one lane
    x1 = field_elems(FE, 1)
    kernel_row("k8", "exp_const", "K8", "montmul.cu",
               "msm_zprize_tpu/fields/pallas_mul.py:237", ed_run, cuda_mul.K8,
               mod_p_err(FE, [cuda_mul.exp_const(FE, x1, e)], [FE.exp_const_plain(x1, e)]),
               _graph_ms(torch, lambda: cuda_mul.exp_const(FE, x1, e)),
               _cuda_ms(torch, lambda: FE.exp_const_plain(x1, e), PLAIN_REPS),
               f"({n22}, 1), e = p - 2", 2 * n22 * 4,
               (e.bit_length() + bin(e).count("1")) * mm8)

    scal = ed.random_scalars(N, seed=SEED, device=dev)
    gm, gs = cuda_scalar.simple_digits(scal, ce, Ke)
    wm, ws = signed_digits(scal, ce, Ke, 12)
    if not (torch.equal(gm, wm) and torch.equal(gs, ws)):
        raise AssertionError("K9 simple_digits is not bit-identical to its plain twin")
    kernel_row("k9", "simple_digits", "K9", "glv_digits.cu",
               "msm_zprize_tpu/fields/pallas_scalar.py:239", ed_run, cuda_scalar.K9,
               max((gm - wm).abs().max().item(), (gs - ws).abs().max().item()),
               _graph_ms(torch, lambda: cuda_scalar.simple_digits(scal, ce, Ke)),
               _cuda_ms(torch, lambda: signed_digits(scal, ce, Ke, 12), PLAIN_REPS),
               f"N={N}, c={ce}, K={Ke}", (SE.n + 2 * Ke) * 4 * N, 0)

    a10 = [field_elems(FE, lanes1e), field_elems(FE, lanes1e), flags(lanes1e), flags(lanes1e),
           field_elems(FE, lanes1e), field_elems(FE, lanes1e), flags(lanes1e), flags(lanes1e)]
    kernel_row("k10", "ed_pair_add", "K10", "edwards.cu",
               "msm_zprize_tpu/curves/pallas_curve.py:449", ed_run, cuda_edwards.K10,
               mod_p_err(FE, cuda_edwards.ed_pair_add(E, *a10), cuda_edwards.ed_pair_add_plain(E, *a10)),
               _graph_ms(torch, lambda: cuda_edwards.ed_pair_add(E, *a10)),
               _cuda_ms(torch, lambda: cuda_edwards.ed_pair_add_plain(E, *a10), PLAIN_REPS),
               f"W={lanes1e}", (8 * n22 + 4) * 4 * lanes1e, 10 * mm8 * lanes1e)
    del a10

    for width, masked in ((lanes1e // 2, False), (lanes1e // 2, True), (1, False)):
        a11 = [field_elems(FE, width) for _ in range(8)]
        mask = {"mask": flags(width)} if masked else {}
        kernel_row("k11", "ed_add", "K11", "edwards.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:500", ed_run, cuda_edwards.K11,
                   mod_p_err(FE, cuda_edwards.ed_add(E, *a11, **mask),
                             cuda_edwards.ed_add_plain(E, *a11, **mask)),
                   _graph_ms(torch, lambda: cuda_edwards.ed_add(E, *a11, **mask)),
                   _cuda_ms(torch, lambda: cuda_edwards.ed_add_plain(E, *a11, **mask), PLAIN_REPS),
                   f"W={width}{', masked' if masked else ''}",
                   (12 * n22 + masked) * 4 * width, 9 * mm8 * width)
    del a11

    c0e = max((ce - 1) // 2, 1)
    for width, k in ((Ke, c0e), (1, ce)):
        a12 = [field_elems(FE, width) for _ in range(4)]
        kernel_row("k12", "ed_double_k", "K12", "edwards.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:494", ed_run, cuda_edwards.K12,
                   mod_p_err(FE, cuda_edwards.ed_double_k(E, *a12, k),
                             cuda_edwards.ed_double_k_plain(E, *a12, k)),
                   _graph_ms(torch, lambda: cuda_edwards.ed_double_k(E, *a12, k)),
                   _cuda_ms(torch, lambda: cuda_edwards.ed_double_k_plain(E, *a12, k), PLAIN_REPS),
                   f"W={width}, k={k}", 8 * n22 * 4 * width, 9 * k * mm8 * width)
    del a12

    # K13 on Fma51Codec rows of the n = 22 Edwards field: on no MSM path (its
    # 0 is read from the BLS12-377 packed run)
    fc51 = Fma51Codec(FE.p)
    x, y = fc51.from_digits(FE, field_elems(FE, N)), fc51.from_digits(FE, field_elems(FE, N))
    kernel_row("k13_fma51", "montmul_rows_Fma51Codec", "K13", "montmul.cu",
               "msm_zprize_tpu/fields/fma51_pallas.py:302", "bls12-377 msm(mode='packed')",
               cuda_codec.K13_FMA51,
               rows_err(FE, fc51, [cuda_codec.montmul_rows(FE, fc51, x, y)],
                        [cuda_codec.montmul_rows_plain(FE, fc51, x, y)]),
               _graph_ms(torch, lambda: cuda_codec.montmul_rows(FE, fc51, x, y)),
               _cuda_ms(torch, lambda: cuda_codec.montmul_rows_plain(FE, fc51, x, y), PLAIN_REPS),
               f"({fc51.rows}, {N}), n = {n22}", 3 * fc51.rows * 4 * N, mm8 * N)
    del x, y

    # BLS12-381 (Fp33: 12 words and a 12-bit tail round) and Pallas (Fp22c:
    # 8 words, an 8-bit tail round, 4p > 2^256)
    weierstrass_rows(c381, "bls12-381", (
        (c381.ops, "curve_381.cu", "bls12-381 msm(mode='projective')"),
        (c381.ops_packed, "curve_381_codec.cu", "bls12-381 msm(mode='packed')"),
    ), dict(proj="bls12-381 msm(mode='projective')", affine="bls12-381 N=8 msm(mode='affine')",
            halving="bls12-381 N=8 msm(mode='halving')", subgroup="bls12-381 N=8 subgroup check"))
    weierstrass_rows(cpal, "pallas", (
        (cpal.ops, "curve_pallas.cu", "pallas msm(mode='projective')"),
        (cpal.ops51, "curve_pallas_codec.cu", "pallas msm(mode='fma51')"),
        (cpal.ops_packed, "curve_pallas_codec.cu", "pallas N=8 msm(mode='packed')"),
    ), dict(proj="pallas msm(mode='projective')", affine="pallas N=8 msm(mode='affine')",
            halving="pallas N=8 msm(mode='halving')", subgroup="pallas N=8 subgroup check"))
    torch.cuda.synchronize()

    # ---- runs of the paths: counts set to 0 just before each, read just after --
    run_counts = {}  # run name -> its launch counts

    def launches_of(counts, keys, what):
        """The run's launches of each kernel of its path; none may be 0."""
        got = {k: counts.get(k, 0) for k in keys}
        missing = [k for k, v in got.items() if v == 0]
        if missing:
            raise AssertionError(f"{what}: kernels of the path were not launched: {missing}")
        return got

    def drive(what, run, keys, check, absent=()):
        """One run with the counts set to 0 just before it and read just
        after (kept as ``run_counts[what]``), its check (and no launch of the
        kernels in ``absent``), then MODE_WARMUP + MODE_RUNS timed runs of the
        same inputs."""
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = run_counts[what] = counters.snapshot()
        check(out)
        launches = launches_of(counts, keys, what)
        stray = {k: counts[k] for k in absent if counts.get(k, 0)}
        if stray:
            raise AssertionError(f"{what}: launched kernels that are off its path: {stray}")
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

    def equals_known(what, cv, want_):
        def check(res):
            if cv.result_to_int(res) != want_:
                raise AssertionError(f"{what} disagrees with the known-discrete-log result")
        return check

    def small_msms(label, phase, cv, params, with_logs, expected, naive):
        """The MSM at N = 8 and its edge cases against both host oracles."""
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

    # ---- 3-8. each curve: small MSMs, the 2^16 MSM, timing -----------------------
    glv = (cuda_mul.KERNEL, cuda_scalar.KERNEL)
    finals = (cuda_curve.K4, cuda_curve.K5)
    curves = (
        ("bls12-377", 3, curve, BLS12_377, points_with_logs, expected_msm, naive_msm,
         glv + (cuda_curve.K3,) + finals),
        ("ed-on-bls12-377", 6, ed, ED_ON_BLS12_377, ed_points_with_logs, ed_expected_msm,
         ed_naive_msm, (cuda_mul.KERNEL, cuda_mul.K8, cuda_scalar.K9, cuda_edwards.K10,
                        cuda_edwards.K11, cuda_edwards.K12)),
    )
    known = {}  # label -> (int points, points on the card, discrete logs) of the 2^16 MSMs
    for label, phase, cv, params, with_logs, expected, naive, path in curves:
        small_msms(label, phase, cv, params, with_logs, expected, naive)
        t0 = time.perf_counter()
        pts_n, logs = with_logs(params, N, seed=SEED)
        points = cv.points_from_ints(pts_n, dev)
        setup_s = time.perf_counter() - t0
        known[label] = (pts_n, points, logs)
        scal = cv.random_scalars(N, seed=SEED + 1, device=dev)
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        res = cv.msm(scal, points)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = run_counts[f"{label} msm 2^16"] = counters.snapshot()
        if cv.result_to_int(res) != expected(params, cv.scalar.unpack(scal.cpu()), logs):
            raise AssertionError(f"{label}: 2^{LOG_N} MSM disagrees with the known-discrete-log result")
        launches = launches_of(counts, path, f"{label} MSM")
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
    pts_n, points, logs = known["bls12-377"]
    scal = curve.random_scalars(N, seed=SEED + 1, device=dev)
    want = expected_msm(BLS12_377, curve.scalar.unpack(scal.cpu()), logs)
    z = field_elems(F, N)  # random Z (< 2^376 < p, nonzero with overwhelming odds)
    proj = ProjectivePoints(F.montmul(points.x, z), F.montmul(points.y, z), z)
    print(f"[9 modes 2^{LOG_N}] bls12-377: each result equals (sum s_i a_i mod q) G")
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
        drive(f"bls12-377 {what}", run, keys, equals_known(f"bls12-377 {what}", curve, want))
    del proj

    _, points_e, logs_e = known["ed-on-bls12-377"]
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

        drive(f"{label} random_points_fast({N})",
              lambda cv=cv: cv.random_points_fast(N, seed=SEED, device=dev), keys, check)
        pts = cv.random_points_fast(N, seed=SEED, device=dev)
        s2 = cv.random_scalars(N, seed=SEED + 2, device=dev)
        a, b = (("affine", "projective") if is_w else ("basic", "padded"))
        if cv.result_to_int(cv.msm(s2, pts, mode=a)) != cv.result_to_int(cv.msm(s2, pts, mode=b)):
            raise AssertionError(f"{label}: the {a} and {b} MSMs over random points disagree")
        msg = f"the {a}- and {b}-mode MSMs over them agree"
        if is_w:
            # q P == 0 on the card for the sampled lanes: 252 K6 doublings
            sub = AffinePoints(*(t.index_select(-1, sample.to(dev)) for t in pts))
            counters.reset()
            qP = W.proj_scale_const(BLS12_377.order, W.from_affine(sub))
            torch.cuda.synchronize()
            counts = run_counts["bls12-377 subgroup check"] = counters.snapshot()
            if not bool(F.is_zero(qP.Z).all()):
                raise AssertionError("random_points_fast lanes outside the prime-order subgroup")
            msg += (f"; q P = 0 for the {SAMPLE} sampled lanes (launches "
                    f"{launches_of(counts, (cuda_curve.K6, cuda_curve.K4), 'subgroup check')})")
        print(f"    {label}: every lane on the curve (on the card), {SAMPLE} sampled lanes equal "
              f"the host sums of their picks; {msg}")

    # ---- 12. the codec storage mode ------------------------------------------------
    print(f"[12 packed 2^{LOG_N}] bls12-377 on PackedCodec rows ({curve.ops_packed.codec.rows} of "
          "31 bits a coordinate): each result equals (sum s_i a_i mod q) G")
    k14_path = (cuda_curve.K3, cuda_curve.K4, cuda_curve.K5)
    k14_side = (cuda_curve.K4M, cuda_curve.K6, cuda_curve.K7)
    codec_keys = {  # mode -> (K13 counter, K14 counters)
        "packed": (cuda_codec.K13, cuda_curve.K14),
        "fma51": (cuda_codec.K13_FMA51, cuda_curve.K14_FMA51),
    }
    all_codec = tuple(k for k13, k14 in codec_keys.values() for k in (k13, *k14.values()))

    def codec_run(mode):
        """The launches a codec mode's projective pipeline must make (K13,
        K2, the K14 variants of K3-K5) and must not (K1: beta x runs on K13;
        the other codec's kernels; the K14 variants of K4m, K6, K7)."""
        k13, k14 = codec_keys[mode]
        keys = (k13, cuda_scalar.KERNEL) + tuple(k14[k] for k in k14_path)
        absent = (cuda_mul.KERNEL,) + tuple(k for k in all_codec if k not in keys)
        return keys, absent

    packed_keys, packed_absent = codec_run("packed")
    for what, run in (
        ("msm(mode='projective')", lambda: curve.msm(scal, points)),
        ("msm(mode='packed')", lambda: curve.msm(scal, points, mode="packed")),
        ("msm_unsafe(mode='packed')", lambda: curve.msm_unsafe(scal, points, mode="packed")),
    ):
        packed = "packed" in what
        drive(f"bls12-377 {what}", run,
              packed_keys if packed else glv + (cuda_curve.K3,) + finals,
              equals_known(f"bls12-377 {what}", curve, want),
              absent=packed_absent if packed else all_codec)
    scs_n = curve.scalar.unpack(scal.cpu())
    dup_pts, dup_logs = pts_n[:-1] + [pts_n[0]], logs[:-1] + [logs[0]]
    for what, pts_i, logs_i in (("distinct points", pts_n, logs),
                                ("a duplicated point", dup_pts, dup_logs)):
        t0 = time.perf_counter()
        got = compute_msm(pts_i, scs_n, mode="packed", device=dev)
        secs = time.perf_counter() - t0
        if got != expected_msm(BLS12_377, scs_n, logs_i):
            raise AssertionError(f"compute_msm(mode='packed') with {what} disagrees with the host oracle")
        print(f"    compute_msm({N} int points and scalars, mode='packed') with {what}: equals the "
              f"known-discrete-log result; {secs:.2f} s with the int conversions")

    # ---- 13-14. BLS12-381 and Pallas ------------------------------------------------
    for phase, params, cv, codec_mode in ((13, BLS12_381, c381, "packed"), (14, PALLAS, cpal, "fma51")):
        label = params.label
        small_msms(label, phase, cv, params, points_with_logs, expected_msm, naive_msm)
        t0 = time.perf_counter()
        pts_c, logs_c = points_with_logs(params, N, seed=SEED)
        points_c = cv.points_from_ints(pts_c, dev)
        setup_s = time.perf_counter() - t0
        scal_c = cv.random_scalars(N, seed=SEED + 1, device=dev)
        want_c = expected_msm(params, cv.scalar.unpack(scal_c.cpu()), logs_c)
        print(f"[{phase} msm 2^{LOG_N}] {label}: each result equals (sum s_i a_i mod q) G "
              f"(input set-up {setup_s:.1f} s)")
        for mode, (keys, absent) in (("projective", (glv + (cuda_curve.K3,) + finals, all_codec)),
                                     (codec_mode, codec_run(codec_mode))):
            what = f"{label} msm(mode='{mode}')"
            drive(what, lambda mode=mode: cv.msm(scal_c, points_c, mode=mode), keys,
                  equals_known(what, cv, want_c), absent=absent)
        # the other modes and point generation at N = 8
        pts8, logs8 = points_with_logs(params, 8, seed=SEED + 3)
        points8 = cv.points_from_ints(pts8, dev)
        scal8 = cv.random_scalars(8, seed=SEED + 3, device=dev)
        want8 = expected_msm(params, cv.scalar.unpack(scal8.cpu()), logs8)
        F8 = cv.ops.F
        z8 = field_elems(F8, 8)
        proj8 = ProjectivePoints(F8.montmul(points8.x, z8), F8.montmul(points8.y, z8), z8)
        others = [
            ("msm(mode='affine')", lambda: cv.msm(scal8, points8, mode="affine"),
             glv + (cuda_mul.K8, cuda_curve.K7) + finals, ()),
            ("msm_unsafe(mode='affine')", lambda: cv.msm_unsafe(scal8, points8, mode="affine"),
             glv + (cuda_mul.K8, cuda_curve.K7) + finals, ()),
            ("msm(mode='halving')", lambda: cv.msm(scal8, points8, mode="halving"),
             glv + (cuda_curve.K4M,) + finals, ()),
            ("msm_projective (random Z)", lambda: cv.msm_projective(scal8, proj8),
             (cuda_scalar.K9,) + finals, ()),
        ]
        if codec_mode != "packed":  # Pallas: the packed mode at N = 8
            others.append(("msm(mode='packed')", lambda: cv.msm(scal8, points8, mode="packed"),
                           *codec_run("packed")))
        for what, run, keys, absent in others:
            what = f"{label} N=8 {what}"
            drive(what, run, keys, equals_known(what, cv, want8), absent=absent)

        def on_curve(pts, cv=cv, label=label):
            if not bool(cv.ops.affine_is_on_curve(pts).all()):
                raise AssertionError(f"{label}: random_points_fast lanes off the curve")

        drive(f"{label} N=8 random_points_fast", lambda cv=cv: cv.random_points_fast(8, seed=SEED, device=dev),
              (cuda_curve.K7, cuda_mul.KERNEL, cuda_mul.K8), on_curve)
        rp = cv.random_points_fast(8, seed=SEED, device=dev)
        counters.reset()
        qP = cv.ops.proj_scale_const(params.order, cv.ops.from_affine(rp))
        torch.cuda.synchronize()
        counts = run_counts[f"{label} N=8 subgroup check"] = counters.snapshot()
        if not bool(cv.ops.F.is_zero(qP.Z).all()):
            raise AssertionError(f"{label}: random_points_fast lanes outside the prime-order subgroup")
        print(f"    {label}: random_points_fast(8) on the curve and in the prime-order subgroup (q P = 0 "
              f"on the card; launches {launches_of(counts, (cuda_curve.K6, cuda_curve.K4), label)})")

    # ---- the kernel table --------------------------------------------------------------
    # each row's launches: its counter in the run it names; 0 only where the
    # row is on no path of that run (the K14 variants of K4m, K6 and K7 in a
    # codec mode, K13 on the Edwards field's Fma51Codec rows)
    for row in table:
        row["launches"] = run_counts[row["run"]].get(row["counter"], 0)
    unlaunched = sorted({row["key"] for row in table if row["launches"] == 0} - {
        row["key"] for row in table if row["id"] in ("K14-K4m", "K14-K6", "K14-K7")} - {"k13_fma51"})
    if unlaunched:
        raise AssertionError(f"kernels no run of their path launched: {unlaunched}")

    # one entry per kernel, field shape and storage: its main-path shape's
    # numbers (the first row, the widest), its worst error
    kernels = {}
    for row in table:
        entry = kernels.setdefault(row["key"], {
            k: row[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        })
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
    print(f"[end] every phase passed in {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
