#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MSM paths end to end on one GPU: the
BLS12-377 MSM in its four modes (the codec storage mode "packed" among
them) and on projective inputs, the ed-on-bls12-377 twisted-Edwards MSM in
its two modes, the device generator of random points, ``compute_msm``, the
BLS12-381 and Pallas MSMs (Pallas also on Fma51Codec rows, "fma51"), and
the sharded MSM on a one-rank mesh and on two ranks sharing the card.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is
non-zero and no result line is printed):

1. device: the card's name and power limit, and the kernel build
   (one ``nvcc`` per source into ``build/``, with the ptxas register,
   stack and spill lines, and each curve kernel's SASS instructions and
   local loads/stores from ``cuobjdump -sass``; a ``[1 K10]`` line per K10
   instance: registers, stack, spills, SASS size, none with a stack frame
   or a spill); then the libraries of the
   shapes made on demand and of BN462's scalar module that phases 18 and
   20 run start building in the background (one ``nvcc`` per source; their
   ``[1 K10]`` lines print when phases 18 and 20 take them, n = 63's
   without a stack frame or a spill);
2. every kernel of every path against its plain PyTorch twin on the card,
   at the shapes the 2^16 MSMs give it (K2 and K9 bit-exact, the others
   exact mod p, the pass-through lanes of K4m, K7 and the masked K11 bit
   for bit), with the card's own time per call (CUDA-graph replay, so no
   host enqueue time), the twin's CUDA-event time, and the bound: the
   least time the card could take for the same work. K3, K4, K4m, K5 and
   K7 run every built instance (G threads a point, as the kernels' library
   lists them), each against the twin and timed twice in turns: K3 on
   every storage at the main round's and the residual's widths, its code
   flushed from the L2 before each call (as in the MSM, where it follows
   the slot gather); K4 over the main path's widths on limbs (450,560 down
   to 1 at 2^16); K7 on every storage at the affine reduction's and
   ``random_points_fast``'s widths; K10 (G = 1, 2) at the padded path's
   level-1 widths and at 131,072-524,288 lanes, cold as K3, the pick
   also warm at the widest; the row's time is the instance the
   kernels' width table picks. K11 (one instance) runs at one block's
   points +- 1 and, timed, at the Edwards padded path's distinct widths,
   from 16,384 lanes up with its code flushed from the L2; masked (on no
   MSM path) at the widest and at W = 1. The other timed calls replay one
   input set, which stays in the 50 MB L2 below ~45k lanes; per-MSM sums
   come from ``profile_msm``. K2 runs at c = 8, 12, the path's c and the
   wide windows 21, 22 and 30 (the widest it takes), at W = 1, 1,000 and
   2^16, without and with the infinity mask, bit for bit against the twin,
   and is timed with the mask at 2^16 and at 2^20 (c = 13, the window size
   there: a row of its own); K9 at the path's c and at 21, 22 and 30, the
   same widths; c = 31 refused by both before any launch. K8 (one warp a lane)
   runs at W = 1, 4 and 64 and at e = 1, with its own measured product
   cost (e = p - 2 less e = 1, over its chain's products; not a bound) and
   its bound on the products x^e needs; K6 (K5's group kernel at k = 1) at the subgroup
   check's 256 lanes on every storage. K5's, K11's (at W = 1) and K12's
   lines give their latency floors: dependent product levels times one
   thread's product latency, which K8's probe measures (x^e by binary
   square-and-multiply with one-thread ``mont_mul`` calls, operands in
   registers; no path runs it);
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
    2^16, and ``"packed"`` (9 rows) among the modes at N = 8;
15. windows past 20 bits: BLS12-377 ``msm`` and ed-on-bls12-377
    ``TwistedEdwards.msm`` at N = 16 and c = 22 (L = 2^21 buckets) against
    both host oracles, with their launches and peak device memory; K2 and K9
    timed at 2^16 and c = 22 (rows of their own);
16. ROADMAP queue 1 item 10's ops at 2^16, each timed once after one warmup
    on the host clock with its launches by kernel, 256 lanes of each held
    against the host: ``sqrt`` on the squares of the 2^16 points of phases
    4, 7, 13 and 14 (BLS12-377, ed-on-bls12-377, BLS12-381, Pallas base
    fields; K8, and the K1 squaring chain), ``is_square``, ``exp_dyn`` (K1)
    and ``left_shift`` on the first two; K8 timed at 2^16 lanes on each
    field (rows of their own); BLS12-377 ``proj_scale_dyn`` (K4m selects, K6
    doubles: rows at 2^16), ``is_in_subgroup`` on the 2^16 points and on 256
    host-made points off the subgroup, ``to_subgroup`` on those; Edwards
    ``scale_dyn`` (the masked K11's path: a row at 2^16), ``scale_const``,
    ``is_in_subgroup`` and ``to_subgroup`` the same way; the special GLV
    split's MSM on BLS12-381 at 2^16 (K3-K5, no K2) against the known logs,
    its ``decompose_no_msb`` and ``BarrettReducer.reduce``; ``Fma51Field``'s
    montmul, add and sub (and ``montmul_fma_model``); the bytes codec's
    round trip; and one 2^16 run of ``compute_msm``'s stages (decode, MSM,
    result) through ``submission.py``'s own helpers, beside one whole call.
17. the sharded MSM over a ``torch.distributed`` mesh (``parallel/mesh.py``):
    a one-rank NCCL mesh in this process (``make_mesh()`` on a file store
    under ``build/``), BLS12-377 ``msm(mesh=...)`` and ed-on-bls12-377
    ``msm(mesh=...)`` on the 2^16 points of phases 4 and 7 against the known
    logs and the unsharded result, each with its launches and 2 warmups + 5
    timed runs beside the unsharded path's; then the card's compute mode and
    two rank processes sharing the card over gloo
    (``parallel/launch.spawn``): BLS12-377 on ``make_mesh()``,
    ``make_mesh2(1, 2)`` and ``make_mesh2(2, 1)``, ed-on-bls12-377 on
    ``make_mesh()``, each rank's result against the known logs with, per
    rank, its wall, the exchange's and the gather's bytes and times, its
    launches by kernel (the combine's adds among K4's and K11's) and its
    peak device memory; and ``compute_msm`` with ``mesh=`` at N = 2^12.
18. every field ``make_field`` takes: K1 and K8 on the 11 example fields and
    on primes of n = 1 and n = 63 limbs (the shapes outside the main library
    built on demand, since phase 1), against the host and their twins; every
    limb-storage curve kernel (K3-K7, K4m, K10-K12, the masked K11; K10
    every built instance, outputs below 2p) on goldilocks, babybear and
    secp256k1's base field against its twin; the equivalence harness on the
    card.
19. the tools: ``run_msm`` on BLS12-377 at 2^16 (with its phase table) and
    2^20 (against the known logs) and on ed-on-bls12-377 at 2^16;
    ``field_benchmark``; ``evaluate_msm`` over c = 10..14 in turns (records
    only), its reading of the table's c beside ``run_msm``'s before and after
    it; ``scaling_bench`` at d = 1 on NCCL.
20. the wide fields (``testing/wide_curves.py``): BN462 (n = 39; its field
    shape and its GLV scalar module built on demand) through
    ``Weierstrass.create(BN462).msm``: N = 8 and edge cases against both host
    oracles, the N = 8 modes (``"packed"``, ``"affine"``, ``msm_unsafe``,
    ``"halving"``, ``msm_projective``) and a subgroup check (K6), then
    ``"projective"`` and ``"packed"`` (15 rows) at 2^16 against the
    known-log sum, with launches and 2 warmups + 5 timed runs; ed25519 (the
    9-word shape) through ``TwistedEdwards.create(ED25519).msm``, N = 8 and
    ``"basic"``, then ``"padded"`` at 2^16 the same way; then every new
    kernel instance against its twin, a row each, with registers, stack
    and spills of the new libraries: K1, K2, K8, K9, K3-K7, K4m and K10-K12
    at n = 39 (K1-K5 and K14 at the widths of BN462's 2^16 runs), K9-K12 at
    ed25519's padded widths, K3-K7, K4m, K10-K12, K13 and K14 at n = 63
    (PackedCodec, 25 rows), K13 and K14 on goldilocks's Fma51Codec and
    PackedCodec rows.

Phase 2 holds the kernels of phases 13-14 too: K1, K2, K8 and K3-K7 on each
curve's limbs, K13 and the K14 variants on each of its codec storages.

The second-to-last line is the kernel table as JSON, the last the result.
Nothing of JAX or of the JAX package is imported: the port stands alone.
"""

from __future__ import annotations

import collections
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

LOG_N = 16
SEED = 2026
WARMUP, RUNS = 5, 10
MODE_WARMUP, MODE_RUNS = 2, 5  # the modes of phases 9-11
SAMPLE = 256  # lanes of random_points_fast checked on the host
SMALL = 4096  # width of the K14 variants that no codec-mode path runs
REPS, PLAIN_REPS = 20, 3  # back-to-back calls per timing: kernel, plain twin
WIDE_CS = (21, 22, 30)  # windows past 20 bits, up to the widest K2 and K9 take
C_WIDE, N_WIDE = 22, 16  # the wide-window MSMs: L = 2^21 buckets
ED_DYN_RUN = "ed-on-bls12-377 scale_dyn 2^16 (252 bits)"  # the masked K11's path
MESH_RANKS = 2  # processes sharing the one card in phase 17
N_MESH_COMPUTE = 1 << 12  # compute_msm on the mesh: its int decode takes ~1.9 s at 2^16



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


def _captured(torch, fn, reps):
    """A CUDA graph of reps back-to-back fn() calls, replayed once untimed."""
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
    return graph


def _replay_ms(torch, graph, reps) -> float:
    """One replay of ``graph`` between two CUDA events, in ms per call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps=REPS) -> float:
    """The card's own time of one fn() call in ms: a CUDA graph of reps
    back-to-back calls, replayed once untimed and once between two CUDA
    events, so that no host enqueue time is in it (the kernels' timing)."""
    graph = _captured(torch, fn, reps)
    ms = _replay_ms(torch, graph, reps)
    del graph
    return ms


def _cold_ms(torch, fn, operands, reps=REPS, rounds=5) -> float:
    """The card's own time of one fn() call that finds its code out of the
    50 MB L2 and its ``operands`` in it, as the MSM's K3 does after the
    slot gather that writes them: a CUDA graph of reps (flush, fn()) pairs,
    where the flush reads and writes 96 MB and then reads the operands, and
    a graph of reps flushes alone, replayed in turns; the median over
    ``rounds`` turns of their difference."""
    scratch = torch.zeros(24 << 20, dtype=torch.int32, device="cuda")

    def flush():
        scratch.add_(1)
        for a in operands:
            a.sum()

    both, alone = _captured(torch, lambda: (flush(), fn()), reps), _captured(torch, flush, reps)
    diffs = [_replay_ms(torch, both, reps) - _replay_ms(torch, alone, reps) for _ in range(rounds)]
    del both, alone
    return statistics.median(diffs)


def _sass_sizes(bindir: Path, lib: Path) -> dict:
    """SASS instructions and local-memory loads and stores (LDL, STL) of each
    curve kernel of the built library, Weierstrass and Edwards, and of K2,
    by demangled name (``testing/main_turns.sass`` and the toolkit's
    ``cu++filt`` in ``bindir``)."""
    from msm_zprize_tpu_torch.testing.main_turns import sass

    code = sass(str(lib))
    names = [k for k in code if "3msm3wei" in k or "3msm2ed" in k or "glv_digits" in k]
    plain = subprocess.run([str(bindir / "cu++filt")], input="\n".join(names), capture_output=True,
                           text=True, check=True, timeout=60).stdout.splitlines()
    return {p.replace("msm::", "").replace("wei::", ""):
            (len(code[k]), sum(bool(re.search(r"\b(LDL|STL)", line)) for line in code[k]))
            for k, p in zip(names, plain)}


def _k10_report(tag: str, info, bindir: Path, clean: bool = False, sizes=None) -> None:
    """One line per K10 instance (G threads a point; 1: the one-thread
    kernel) of a built library: registers, stack frame and spills from its
    ptxas log, SASS instructions and local loads/stores (``sizes``: the
    library's ``_sass_sizes``, read here when not given). Where ``clean``,
    an instance with a stack frame or a spill fails the smoke."""
    props, kern = {}, None
    for line in info.log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kern = m.group(1) if "ed_pair_add" in m.group(1) else None
            continue
        f = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        r = re.search(r"Used (\d+) registers", line)
        if kern and (f or r):
            g = re.search(r"ILi(\d+)EE", kern)
            props.setdefault(int(g.group(1)) if g else 1, {}).update(
                dict(zip(("stack", "spill_st", "spill_ld"), map(int, f.groups()))) if f
                else {"regs": int(r.group(1))})
    for name, (count, local) in (sizes or _sass_sizes(bindir, info.path)).items():
        if "ed_pair_add" in name:
            g = re.search(r"<\(int\)(\d+)>", name)
            props.setdefault(int(g.group(1)) if g else 1, {}).update(sass=count, local=local)
    for g, pr in sorted(props.items()):
        print(f"[1 K10] {tag}: G={g}: {pr.get('regs')} registers, {pr.get('stack')} B stack frame, "
              f"{pr.get('spill_st')} B spill stores, {pr.get('spill_ld')} B spill loads; "
              f"{pr.get('sass')} SASS instructions, {pr.get('local')} local loads/stores")
        if clean and (pr.get("stack") or pr.get("spill_st") or pr.get("spill_ld") or pr.get("local")):
            raise AssertionError(f"K10 G={g} on {tag} has a stack frame or spills: {pr}")
    if not props:
        raise AssertionError(f"no K10 instance in the library of {tag}")


def main() -> None:
    import torch
    import torch.distributed as dist

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    from msm_zprize_tpu_torch import _build, counters
    from msm_zprize_tpu_torch.bigint import field as host_field
    from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
    from msm_zprize_tpu_torch.curves.edwards import ExtPoints
    from msm_zprize_tpu_torch.curves.example_fields import EXAMPLE_FIELDS
    from msm_zprize_tpu_torch.curves.params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
    from msm_zprize_tpu_torch.curves.weierstrass import AffinePoints, ProjectivePoints
    from msm_zprize_tpu_torch.fields import cuda_codec, cuda_mul, cuda_scalar
    from msm_zprize_tpu_torch.fields.barrett import BarrettReducer
    from msm_zprize_tpu_torch.fields.bytes_codec import bytes_to_limbs, limbs_to_bytes
    from msm_zprize_tpu_torch.fields.codec import Fma51Codec, PackedCodec
    from msm_zprize_tpu_torch.fields.fma51 import make_fma51_field, montmul_fma_model
    from msm_zprize_tpu_torch.fields.fp import make_field
    from msm_zprize_tpu_torch.fields.limbs import LimbScheme, unpack
    from msm_zprize_tpu_torch.fields.scalar import GlvScalarSpecialMsm, signed_digits
    from msm_zprize_tpu_torch.fields.sqrt import make_sqrt
    from msm_zprize_tpu_torch.msm.batched_affine import msm_batched_affine
    from msm_zprize_tpu_torch.msm.common import default_windows, window_size
    from msm_zprize_tpu_torch.msm.engine import slot_count
    from msm_zprize_tpu_torch.parallel import launch
    from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
    from msm_zprize_tpu_torch.parallel.mesh import make_mesh
    from msm_zprize_tpu_torch.submission import _pick_msm, _to_int_points, _to_int_scalars, compute_msm
    from msm_zprize_tpu_torch.scripts import evaluate_msm, field_benchmark, run_msm, scaling_bench
    from msm_zprize_tpu_torch.testing import Random, Spec, equivalent
    from msm_zprize_tpu_torch.testing.bounds import (
        HBM_BYTES_PER_S, bound_ms, curve_work, glv_digits_work, imad_per_s, mont_imads,
    )
    from msm_zprize_tpu_torch.testing.equivalent import field_spec
    from msm_zprize_tpu_torch.testing.points import (
        ed_expected_msm, ed_naive_msm, ed_points_with_logs, expected_msm, naive_msm,
        points_with_logs, table_points_with_logs,
    )
    from msm_zprize_tpu_torch.testing import mesh_ranks
    from msm_zprize_tpu_torch.testing.wide_curves import (
        BN462, ED25519, TOY63_B, TOY63_P, toy63_points,
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
    bindir = Path(_build._nvcc()).resolve().parent
    sizes = _sass_sizes(bindir, info.path)
    for name, (count, local) in sizes.items():
        print(f"    sass: {count} instructions, {local} local loads/stores: {name}")
    _k10_report("main library (Fp22)", info, bindir, clean=True, sizes=sizes)
    # the libraries of the shapes made on demand that phases 18 and 20 run, and
    # of BN462's scalar module: one nvcc per source, all started now, built in
    # the background while phases 2-17 keep the card busy
    fields18 = dict(EXAMPLE_FIELDS)
    fields18["n1-p97"] = 97
    fields18["n63-p751"] = TOY63_P  # the least prime above 2^750 + 12345, 3 mod 4
    made18 = {name: make_field(p) for name, p in fields18.items()}
    c462 = Weierstrass.create(BN462)
    dyn_sids = sorted({_build.field_shape(G) for G in (*made18.values(), c462.ops.F)}
                      - set(_build.FIELD_SHAPES))
    t_dyn = time.perf_counter()
    dyn_pool = ThreadPoolExecutor(len(dyn_sids) + 1)
    dyn_builds = {s: dyn_pool.submit(lambda s=s: _build.library(s)[1]) for s in dyn_sids}
    scalar_build = dyn_pool.submit(lambda: _build.scalar_library(cuda_scalar._dims(c462.scalar))[1])
    dyn_pool.shutdown(wait=False)

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

    def curve_err(G, got, want):
        """mod_p_err of a curve kernel's limbs; every output must also hold a
        value below 2p."""
        if not all(torch.equal(G._sub_const_select(g, G.two_p_limbs), g) for g in got):
            raise AssertionError("curve kernel output at or above 2p")
        return mod_p_err(G, got, want)

    def k10_err(E_, a, want):
        """The worst curve_err of every built K10 instance (G threads a point)
        on the slots a, against the twin's ``want``."""
        return max(curve_err(E_.F, cuda_edwards._ed_pair_add(E_, g, *a), want)
                   for g in cuda_edwards._k10_groups(E_))

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

    def instances(label, shape, args, err_of, inst, plain, groups, pick, chain=0, product_ms=0.0,
                  cold=False):
        """Every built instance (G threads a point: ``groups``) of a kernel
        against the twin on ``args``, each timed twice in turns (G
        ascending, then descending), by ``_cold_ms`` where ``cold`` (a
        launch that follows other work, as K3 follows the slot gather),
        else ``_graph_ms`` (a launch after one of its own, as K4's tree
        levels are); prints them and, for a chain of ``chain`` dependent
        product levels of ``product_ms`` each, its latency floor; returns
        (the worst error, the width table's pick's time, the twin's time)
        for its row."""
        want = plain(args)
        worst = max(err_of(inst(g, args), want) for g in groups)
        del want
        times = {g: [] for g in groups}
        for g in groups + groups[::-1]:
            run = lambda: inst(g, args)
            times[g].append(_cold_ms(torch, run, args) if cold else _graph_ms(torch, run))
        ms = {g: sum(t) / len(t) for g, t in times.items()}
        floor = (f"; latency floor {chain} product levels x {product_ms * 1e3:.3f} us = "
                 f"{chain * product_ms:.4f} ms" if chain else "")
        print(f"[2 instances] {label} {shape}{' (code flushed from the L2 before each call)' if cold else ''}: "
              f"width table's G = {pick}; "
              + ", ".join(f"G={g} {ms[g]:.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
                          for g, t in times.items()) + floor)
        return worst, ms[pick], _cuda_ms(torch, lambda: plain(args), PLAIN_REPS)

    def k8_rows(G, key, name, tag, run, x, mm):
        """K8 (batch_inverse's Fermat inverse, e = p - 2) against its twin at
        W = 1 (its row), 4 and 64 on ``x``'s first lanes, timed there and
        at e = 1 (the chain's fixed cost: its two domain changes and the
        launch). Its bound counts the multiply-adds of the products x^e
        needs (its chain's, the domain changes left out); the bit length
        plus popcount that binary square-and-multiply would take is printed
        beside it as a note. K8's own product cost (e = p - 2 less e = 1,
        over the chain's products) is a measurement, not a bound. Then
        K8's probe (x^e on one thread by binary square-and-multiply,
        operands in registers: the chain K8 ran before its warp design),
        timed less its launch (the probe at e = 0): over its products, one
        thread's dependent product latency, returned for the curve kernels'
        floors and printed times K8's chain beside K8."""
        e = G.p - 2
        products = cuda_mul.exp_products(cuda_mul.exp_chain(e))
        widths = (1, 4, 64)
        err = max(curve_err(G, [cuda_mul.exp_const(G, x[:, :w], e)], [G.exp_const_plain(x[:, :w], e)])
                  for w in widths)
        ms = {w: _graph_ms(torch, lambda w=w: cuda_mul.exp_const(G, x[:, :w], e)) for w in widths}
        ms_e1 = _graph_ms(torch, lambda: cuda_mul.exp_const(G, x[:, :1], 1))
        own = (ms[1] - ms_e1) / products
        kernel_row(key, name, "K8", "montmul.cu", "msm_zprize_tpu/fields/pallas_mul.py:237", run,
                   cuda_mul.K8, err, ms[1],
                   _cuda_ms(torch, lambda: G.exp_const_plain(x[:, :1], e), PLAIN_REPS),
                   f"({G.n}, 1), e = p - 2", 2 * G.n * 4, products * mm)
        binary = cuda_mul.probe_products(e)
        probe_err = curve_err(G, [cuda_mul._exp_probe(G, x[:, :1], e)], [G.exp_const_plain(x[:, :1], e)])
        if probe_err:
            raise AssertionError(f"K8's probe on {tag} disagrees with the twin: {probe_err}")
        probe_ms = (_graph_ms(torch, lambda: cuda_mul._exp_probe(G, x[:, :1], e))
                    - _graph_ms(torch, lambda: cuda_mul._exp_probe(G, x[:, :1], 0))) / binary
        print(f"    K8 {tag}: W=4 {ms[4]:.4f} ms, W=64 {ms[64]:.4f} ms, e = 1 {ms_e1:.4f} ms; bound "
              f"on {products} products x {mm} multiply-adds (binary square-and-multiply: "
              f"{binary} products, {binary * mm / imad_rate * 1e3:.6f} ms); K8's own product "
              f"(measured, not a bound: e = p - 2 less e = 1, over {products}) {own * 1e3:.3f} us; "
              f"the chain on one thread's mont_mul: {products} x {probe_ms * 1e3:.3f} us = "
              f"{products * probe_ms:.4f} ms")
        print(f"    one dependent product's latency on one thread ({tag}; K8's probe: binary "
              f"square-and-multiply, {binary} mont_mul calls, operands in registers, less the "
              f"probe at e = 0): {probe_ms * 1e3:.3f} us")
        return probe_ms

    def refusal(fn):
        """The ValueError a call past the widest window raises, with no
        launch (a kernel launch here would be counted)."""
        before = dict(counters.COUNTS)
        try:
            fn()
        except ValueError as err:
            if dict(counters.COUNTS) != before:
                raise AssertionError("a refused window size launched a kernel")
            if str(cuda_scalar.MAX_C) not in str(err):
                raise AssertionError(f"the refusal does not name the limit: {err}")
            return f"ValueError: {err}"
        raise AssertionError("a window size past the limit was not refused")

    def k2_rows(cv, tag, run, cg):
        """K2 on one curve's scalars against the twin, bit for bit, at c = 8,
        12, the path's c and the wide windows (21, 22 and the widest, 30), at
        W = 1, 1,000 and 2^16, without and with an infinity mask (the first
        lanes 0, 1, q - 1 and q // 2), and c = 31 refused; then, with
        the mask glv_prep passes, timed at the path's shape at 2^16 (its
        row) and at 2^20 with c = 13 (the window size there; its own row)."""
        Sg, q = cv.scalar, cv.params.order
        edges = torch.as_tensor(Sg.pack([0, 1, q - 1, q // 2]), device=dev)
        cs, worst = sorted({8, 12, cg} | set(WIDE_CS)), 0
        for c_ in cs:
            K_ = default_windows(Sg.max_bits, c_)
            for width in (1, 1000, N):
                scal = cv.random_scalars(width, seed=SEED + width, device=dev)
                scal[:, :4] = edges[:, :width]
                for inf in (None, flags(2 * width)):
                    worst = max(worst, raw_err(cuda_scalar.glv_digits(Sg, scal, c_, K_, inf),
                                               cuda_scalar.glv_digits_plain(Sg, scal, c_, K_, inf)))
        if worst:
            raise AssertionError(f"K2 on {tag} is not bit-identical to its plain twin: {worst}")
        refused = refusal(lambda: cuda_scalar.glv_digits(Sg, scal, cuda_scalar.MAX_C + 1, K_))
        print(f"[2 kernel] K2 glv_digits_{tag}: bit-identical to the twin at c = {cs}, "
              f"W = 1, 1000, {N}, without and with the mask; c = {cuda_scalar.MAX_C + 1} refused "
              f"before any launch ({refused})")
        for key, width, c_ in ((f"k2_{tag}", N, cg), (f"k2_2e20_{tag}", 1 << 20, 13)):
            K_ = default_windows(Sg.max_bits, c_)
            scal = cv.random_scalars(width, seed=SEED, device=dev)
            inf = flags(2 * width)
            kernel_row(key, f"glv_digits_{tag}" + ("" if width == N else "_2e20"), "K2", "glv_digits.cu",
                       "msm_zprize_tpu/fields/pallas_scalar.py:279", run, cuda_scalar.KERNEL,
                       raw_err(cuda_scalar.glv_digits(Sg, scal, c_, K_, inf),
                               cuda_scalar.glv_digits_plain(Sg, scal, c_, K_, inf)),
                       _graph_ms(torch, lambda: cuda_scalar.glv_digits(Sg, scal, c_, K_, inf)),
                       _cuda_ms(torch, lambda: cuda_scalar.glv_digits_plain(Sg, scal, c_, K_, inf),
                                PLAIN_REPS),
                       f"N={width}, c={c_}, K={K_}, masked", *glv_digits_work(width, Sg.n, K_))
            del scal, inf

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
        mr = min(32, slot_count(2 * N, Lg))
        wres = (mr + (mr & 1)) // 2 * min(2048, Kg * Lg)  # level 1 of the compact residual

        x, y = field_elems(G, N, edges + (4 * G.p - 1,)), field_elems(G, N, (4 * G.p - 1,) + edges)
        kernel_row(f"k1_{tag}", f"montmul_{tag}", "K1", "montmul.cu",
                   "msm_zprize_tpu/fields/pallas_mul.py:167", runs["proj"], cuda_mul.KERNEL,
                   mod_p_err(G, [cuda_mul.montmul(G, x, y)], [G.montmul_plain(x, y)]),
                   _graph_ms(torch, lambda: cuda_mul.montmul(G, x, y)),
                   _cuda_ms(torch, lambda: G.montmul_plain(x, y), PLAIN_REPS), f"({n}, {N})",
                   3 * n * 4 * N, mm * N)
        product_ms = k8_rows(G, f"k8_{tag}", f"exp_const_{tag}", tag, runs["affine"], x, mm)

        def wei_instances(Wc, kernel, shape, args, err_of, inst, plain, chain=0):
            """``instances`` of curve kernel ``kernel`` on the storage of Wc, as
            the kernels' library lists them, and its width table's pick (K3
            timed cold)."""
            return instances(f"{kernel} {tag}", shape, args, err_of, inst, plain,
                             cuda_curve._groups(Wc, kernel),
                             cuda_curve._group_for(Wc, kernel, args[0].shape[-1]), chain, product_ms,
                             cold=kernel == cuda_curve.K3)
        k2_rows(cv, tag, runs["proj"], cg)
        del x, y

        for Wc, unit, run in units:
            codec = getattr(Wc, "codec", None)
            if codec is None:
                nr, cname, pre, side = n, "", "", runs
                keys = {k: k for k in cuda_curve.KERNEL_IDS}
                kid = lambda k: k
                err = lambda got, want: curve_err(G, got, want)
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

            # K3, K4, K4m and K5: every instance (G threads a point) against
            # the twin and timed in turns; the row's time is the width table's
            # pick. K3: the main round's level 1 and the compact residual's
            for width in (w1, wres):
                a3 = [elem(width), elem(width), flags(width), flags(width), elem(width),
                      elem(width), flags(width), flags(width)]
                row("K3", "aff_pair_add", 372, run, *wei_instances(
                    Wc, cuda_curve.K3, f"W={width}, {nr} rows", a3, err,
                    lambda G, a: cuda_curve._aff_pair_add(Wc, G, *a),
                    lambda a: cuda_curve.aff_pair_add_plain(Wc, *a)),
                    f"W={width}, {nr} rows", (7 * nr + 4) * 4 * width, 9 * mm * width)
                del a3
            # limbs: the main round's tree levels, the compact residual's
            # 8 x 2048 lanes, the fold and reduction widths Kg Lg 2^(1-i)
            # (45,056 down to 176 at 2^16) and Horner's 1
            k4_widths = ((w1 // 2, w1 // 4, w1 // 8, 2 * Kg * Lg, Kg * Lg, 8 * 2048)
                         + tuple(Kg * Lg >> i for i in range(1, 6)) + (Kg * Lg >> 7, 1)
                         if codec is None else (w1 // 2, 1))
            for width in k4_widths:
                a4 = [elem(width) for _ in range(6)]
                row("K4", "proj_add", 382, run, *wei_instances(
                    Wc, cuda_curve.K4, f"W={width}, {nr} rows", a4, err,
                    lambda G, a: cuda_curve._proj_add(Wc, G, *a),
                    lambda a: cuda_curve.proj_add_plain(Wc, *a)),
                    f"W={width}, {nr} rows", 9 * nr * 4 * width, 12 * mm * width)
            for width, k in ((Kg, c0g), (1, cg)):
                a5 = [elem(width) for _ in range(3)]
                row("K5", "proj_double_k", 324, run, *wei_instances(
                    Wc, cuda_curve.K5, f"W={width}, k={k}, {nr} rows", a5, err,
                    lambda G, a, k=k: cuda_curve._proj_double_k(Wc, G, *a, k),
                    lambda a, k=k: cuda_curve.proj_double_k_plain(Wc, *a, k), chain=2 * k),
                    f"W={width}, k={k}, {nr} rows", 6 * nr * 4 * width, 8 * k * mm * width)
            wm4 = wh if codec is None else SMALL
            a4 = [elem(wm4) for _ in range(6)]
            m4 = flags(wm4)
            off = m4 == 0  # masked-off lanes are P1, bit for bit
            row("K4m", "proj_add_masked", 382, side["halving"], *wei_instances(
                Wc, cuda_curve.K4M, f"W={wm4}, masked, {nr} rows", a4,
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
            # K7, every instance: the affine reduction's width and
            # random_points_fast's
            for width in ((wr, N) if codec is None else (SMALL,)):
                a7 = [elem(width) for _ in range(5)]
                i7 = flags(width)
                on = i7 == 1  # lanes with an infinite affine operand are P1
                row("K7", "proj_add_mixed", 397, side["affine"], *wei_instances(
                    Wc, cuda_curve.K7, f"W={width}, {nr} rows", a7,
                    lambda got, want: max(err(got, want),
                                          raw_err([g[:, on] for g in got], [a[:, on] for a in a7[:3]])),
                    lambda G, a: cuda_curve._proj_add_mixed(Wc, G, *a, i7),
                    lambda a: cuda_curve.proj_add_mixed_plain(Wc, *a, i7)),
                    f"W={width}, {nr} rows", (8 * nr + 1) * 4 * width, 11 * mm * int((~on).sum().item()))
            del a7

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

    ed_product_ms = k8_rows(FE, "k8", "exp_const", "ed-on-bls12-377", ed_run, x, mm8)

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
    for c_ in WIDE_CS:
        K_ = default_windows(SE.bits, c_)
        for width in (1, 1000, N):
            part = scal[:, :width].contiguous()
            if raw_err(cuda_scalar.simple_digits(part, c_, K_), signed_digits(part, c_, K_, 12)):
                raise AssertionError(f"K9 at c={c_}, W={width} is not bit-identical to its twin")
    refused = refusal(lambda: cuda_scalar.simple_digits(scal, cuda_scalar.MAX_C + 1, Ke))
    print(f"[2 kernel] K9 simple_digits: bit-identical to the twin at c = {list(WIDE_CS)}, W = 1, "
          f"1000, {N}; c = {cuda_scalar.MAX_C + 1} refused before any launch ({refused})")

    # K10: every instance (G threads a point; 1: the one-thread kernel)
    # against the twin and timed in turns, cold (as in the MSM: after the slot
    # gather) at the main round's level 1 and the compact residual's; the
    # row's time is the width table's pick. Every output below 2p. Then the
    # instances at the widths between, where the table's G = 2 gives way to
    # the one-thread kernel, and the pick's warm time (CUDA-graph replay, as
    # PR 2-14 timed this row) beside the main width's cold one.
    me = min(32, slot_count(N, Le))
    wres_e = (me + (me & 1)) // 2 * min(2048, Ke * Le)

    def k10_instances(width, a10):
        return instances("K10 ed-on-bls12-377", f"W={width}", a10,
                         lambda got, want: curve_err(FE, got, want),
                         lambda G, a: cuda_edwards._ed_pair_add(E, G, *a),
                         lambda a: cuda_edwards.ed_pair_add_plain(E, *a),
                         cuda_edwards._k10_groups(E), cuda_edwards._k10_group_for(E, width), cold=True)

    for width in (lanes1e, wres_e, 131_072, 262_144, 524_288):
        a10 = [field_elems(FE, width, (2 * FE.p - 1,)), field_elems(FE, width, (2 * FE.p - 2,)),
               flags(width), flags(width), field_elems(FE, width, (2 * FE.p - 2,)),
               field_elems(FE, width, (2 * FE.p - 1,)), flags(width), flags(width)]
        if width not in (lanes1e, wres_e):
            err = k10_instances(width, a10)[0]
            if err:
                raise AssertionError(f"K10 disagrees with its plain twin at W={width}: max err {err}")
            continue
        kernel_row("k10", "ed_pair_add", "K10", "edwards.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:449", ed_run, cuda_edwards.K10,
                   *k10_instances(width, a10), f"W={width} (code flushed from the L2)",
                   (8 * n22 + 4) * 4 * width, 10 * mm8 * width)
        if width == lanes1e:
            print(f"[2 instances] K10 ed-on-bls12-377 W={width}: the table's pick warm (CUDA-graph "
                  f"replay) {_graph_ms(torch, lambda: cuda_edwards.ed_pair_add(E, *a10)):.4f} ms")
        del a10

    # K11 (G = 4 threads a point) against the twin, unmasked and masked: at
    # one block's points +- 1 (32 points a block), untimed; then timed at the
    # padded path's distinct widths (the tree's widest, the fold, the
    # sub-rounds, reduce_buckets_log's narrowest, Horner), from 16,384 lanes
    # up with its code flushed from the L2 (as in the MSM, where those
    # launches follow the slot gathers), W = 1 beside its latency floor (3
    # dependent product levels). The masked K11 (counter K11M) is on no MSM
    # path; Edwards scale_dyn runs it (phase 16, which times it at 2^16):
    # timed here at the widest width and at W = 1.
    def k11_err(got, want, a, mask):
        """curve_err, and the masked-off lanes P1's limbs bit for bit."""
        worst = curve_err(FE, got, want)
        if mask:
            off = mask["mask"] == 0
            worst = max(worst, raw_err([g[:, off] for g in got], [x[:, off] for x in a[:4]]))
        return worst

    for masked in (False, True):
        for width in (31, 32, 33):
            a11 = [field_elems(FE, width) for _ in range(8)]
            mask = {"mask": flags(width)} if masked else {}
            if k11_err(cuda_edwards.ed_add(E, *a11, **mask), cuda_edwards.ed_add_plain(E, *a11, **mask),
                       a11, mask) != 0:
                raise AssertionError(f"K11 W={width} masked={masked} disagrees with its twin")
    print("[2] K11, unmasked and masked: equal to its twin at one block's points +- 1")
    for masked, widths in ((False, (lanes1e // 2, 2 * Ke * Le, Ke * Le, Ke, 1)),
                           (True, (lanes1e // 2, 1))):
        for width in widths:
            a11 = [field_elems(FE, width) for _ in range(8)]
            mask = {"mask": flags(width)} if masked else {}
            run11 = lambda: cuda_edwards.ed_add(E, *a11, **mask)
            ms11 = _cold_ms(torch, run11, a11) if width >= 16384 else _graph_ms(torch, run11)
            if width == 1 and not masked:
                print(f"[2] K11 W=1: {ms11:.4f} ms; latency floor 3 product levels x "
                      f"{ed_product_ms * 1e3:.3f} us = {3 * ed_product_ms:.4f} ms")
            kernel_row("k11m" if masked else "k11", "ed_add_masked" if masked else "ed_add", "K11",
                       "edwards.cu", "msm_zprize_tpu/curves/pallas_curve.py:500",
                       ED_DYN_RUN if masked else ed_run, cuda_edwards.K11M if masked else cuda_edwards.K11,
                       k11_err(run11(), cuda_edwards.ed_add_plain(E, *a11, **mask), a11, mask), ms11,
                       _cuda_ms(torch, lambda: cuda_edwards.ed_add_plain(E, *a11, **mask), PLAIN_REPS),
                       f"W={width}{', masked' if masked else ''}"
                       f"{' (code flushed from the L2)' if width >= 16384 else ''}",
                       (12 * n22 + masked) * 4 * width,
                       9 * mm8 * (int(mask["mask"].sum().item()) if masked else width))
    del a11

    # K12 (G = 4 threads a point) against the twin, with its latency floor:
    # 3 dependent product levels a doubling
    c0e = max((ce - 1) // 2, 1)
    for width, k in ((Ke, c0e), (1, ce)):
        a12 = [field_elems(FE, width) for _ in range(4)]
        ms12 = _graph_ms(torch, lambda: cuda_edwards.ed_double_k(E, *a12, k))
        print(f"[2] K12 W={width}, k={k}: {ms12:.4f} ms; latency floor {3 * k} product levels x "
              f"{ed_product_ms * 1e3:.3f} us = {3 * k * ed_product_ms:.4f} ms")
        kernel_row("k12", "ed_double_k", "K12", "edwards.cu",
                   "msm_zprize_tpu/curves/pallas_curve.py:494", ed_run, cuda_edwards.K12,
                   curve_err(FE, cuda_edwards.ed_double_k(E, *a12, k),
                             cuda_edwards.ed_double_k_plain(E, *a12, k)),
                   ms12, _cuda_ms(torch, lambda: cuda_edwards.ed_double_k_plain(E, *a12, k), PLAIN_REPS),
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
        known[label] = (pts_c, points_c, logs_c)
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

    # ---- 15. windows past 20 bits: the c = 22 MSMs ----------------------------------
    # L = 2^21 buckets: the padded engine streams its (M = 2, K, L) slots in
    # window chunks of at most 8M slots (2 windows a chunk here)
    print(f"[15 c={C_WIDE}] N={N_WIDE} MSMs at c = {C_WIDE} (L = 2^{C_WIDE - 1} buckets), each against "
          "both host oracles")
    for label, _, cv, params, with_logs, expected, naive, path in curves:
        pts16, logs16 = with_logs(params, N_WIDE, seed=SEED + 5)
        scal16 = cv.random_scalars(N_WIDE, seed=SEED + 5, device=dev)
        points16 = cv.points_from_ints(pts16, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        res = cv.msm(scal16, points16, c=C_WIDE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = run_counts[f"{label} msm c={C_WIDE}"] = counters.snapshot()
        scs16 = cv.scalar.unpack(scal16.cpu())
        if not cv.result_to_int(res) == naive(params, scs16, pts16) == expected(params, scs16, logs16):
            raise AssertionError(f"{label}: the c = {C_WIDE} MSM disagrees with the host oracles")
        print(f"    {label} msm(N={N_WIDE}, c={C_WIDE}): equals both host oracles; {ms:.1f} ms; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
              f"{launches_of(counts, path, label)}; host syncs {counts.get('host_sync', 0)}")
    del res
    Kw = default_windows(curve.scalar.max_bits, C_WIDE)
    scal = curve.random_scalars(N, seed=SEED, device=dev)
    inf = flags(2 * N)
    kernel_row("k2_c22", "glv_digits_c22", "K2", "glv_digits.cu", "msm_zprize_tpu/fields/pallas_scalar.py:279",
               f"bls12-377 msm c={C_WIDE}", cuda_scalar.KERNEL,
               raw_err(cuda_scalar.glv_digits(curve.scalar, scal, C_WIDE, Kw, inf),
                       cuda_scalar.glv_digits_plain(curve.scalar, scal, C_WIDE, Kw, inf)),
               _graph_ms(torch, lambda: cuda_scalar.glv_digits(curve.scalar, scal, C_WIDE, Kw, inf)),
               _cuda_ms(torch, lambda: cuda_scalar.glv_digits_plain(curve.scalar, scal, C_WIDE, Kw, inf),
                        PLAIN_REPS),
               f"N={N}, c={C_WIDE}, K={Kw}, masked", *glv_digits_work(N, curve.scalar.n, Kw))
    Kw9 = default_windows(SE.bits, C_WIDE)
    scal = ed.random_scalars(N, seed=SEED, device=dev)
    kernel_row("k9_c22", "simple_digits_c22", "K9", "glv_digits.cu", "msm_zprize_tpu/fields/pallas_scalar.py:239",
               f"ed-on-bls12-377 msm c={C_WIDE}", cuda_scalar.K9,
               raw_err(cuda_scalar.simple_digits(scal, C_WIDE, Kw9), signed_digits(scal, C_WIDE, Kw9, 12)),
               _graph_ms(torch, lambda: cuda_scalar.simple_digits(scal, C_WIDE, Kw9)),
               _cuda_ms(torch, lambda: signed_digits(scal, C_WIDE, Kw9, 12), PLAIN_REPS),
               f"N={N}, c={C_WIDE}, K={Kw9}", (SE.n + 2 * Kw9) * 4 * N, 0)
    del scal, inf

    # ---- 16. item 10's ops at 2^16 ----------------------------------------------------
    t16 = time.perf_counter()
    print(f"[16 item 10 ops 2^{LOG_N}] square roots, runtime exponents and scalars, subgroup ops, "
          f"the special GLV split, Barrett, the 51x5 engine and the bytes codec; {SAMPLE} lanes of "
          "each against the host")
    lanes = sample.to(dev)
    orng = random.Random(SEED + 16)  # host-made points and field values

    def pick(t):
        return t.index_select(-1, lanes)

    def op(label, fn, keys=()):
        """One call after one warmup: its host-clock time and its launches by
        kernel (the counts set to 0 just before it, kept as run_counts[label];
        each of ``keys`` must be > 0)."""
        fn()
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = run_counts[label] = counters.snapshot()
        launches_of(counts, keys, label)
        print(f"    {label}: {ms:.1f} ms (host clock, one call after one warmup); launches "
              f"{ {k: v for k, v in sorted(counts.items()) if k.startswith('k')} }")
        return out

    def check(ok, what):
        if not ok:
            raise AssertionError(f"phase 16: {what}")

    # fields: the squares y^2 of the 2^16 points of phases 4, 7, 13 and 14
    field_sets = (("bls12-377", F, known["bls12-377"][1].y, True),
                  ("ed-on-bls12-377", FE, known["ed-on-bls12-377"][1].Y, True),  # Z = 1
                  ("bls12-381", c381.ops.F, known["bls12-381"][1].y, False),
                  ("pallas", cpal.ops.F, known["pallas"][1].y, False))
    for tag, G, y, full in field_sets:
        p, Sq = G.p, make_sqrt(G.p)
        y2 = G.montsquare(y)
        root, ok = op(f"{tag} sqrt 2^16 (M = {Sq.M})", lambda: Sq.sqrt(y2),
                      (cuda_mul.K8,) + ((cuda_mul.KERNEL,) if Sq.M > 1 else ()))
        check(bool(ok.all()) and bool(G.is_equal(G.montsquare(root), y2).all()),
              f"{tag}: a root of y^2 does not square back")
        check(all(r in (v, (-v) % p) for r, v in zip(G.unpack(pick(root)), G.unpack(pick(y)))),
              f"{tag}: sampled roots are not +-y")
        x = field_elems(G, N)
        if full:
            check(bool(op(f"{tag} is_square 2^16 (the squares)", lambda: Sq.is_square(y2),
                          (cuda_mul.K8,)).all()), f"{tag}: is_square false on a square")
            sq = op(f"{tag} is_square 2^16 (random elements)", lambda: Sq.is_square(x), (cuda_mul.K8,))
            check(pick(sq).tolist() == [host_field.is_square(v, p) for v in G.unpack(pick(x))],
                  f"{tag}: is_square disagrees with the host")
            e = torch.as_tensor(rng.integers(0, 1 << 12, size=(22, N), dtype=np.int32), device=dev)
            xe = op(f"{tag} exp_dyn 2^16 (22-limb exponents)", lambda: G.exp_dyn(x, e), (cuda_mul.KERNEL,))
            check(G.unpack(pick(xe)) == [pow(a, b, p) for a, b in zip(
                G.unpack(pick(x)), unpack(pick(e), LimbScheme(12, 22)))], f"{tag}: exp_dyn != pow")
            xs = op(f"{tag} left_shift(x, 7) 2^16", lambda: G.left_shift(x, 7), (cuda_mul.KERNEL,))
            check(G.unpack(pick(xs)) == [(a << 7) % p for a in G.unpack(pick(x))], f"{tag}: left_shift")
        # K8 at 2^16 lanes at is_square's exponent; the twin on the sampled lanes
        n, nw, _ = _build.FIELD_SHAPES[_build.field_shape(G)]
        e = (p - 1) // 2
        products = cuda_mul.exp_products(cuda_mul.exp_chain(e))
        k1_chain = run_counts[f"{tag} sqrt 2^16 (M = {Sq.M})"].get(cuda_mul.KERNEL, 0)
        kernel_row(f"k8_2e16_{tag}", f"exp_const_2e16_{tag}", "K8", "montmul.cu",
                   "msm_zprize_tpu/fields/pallas_mul.py:237", f"{tag} sqrt 2^16 (M = {Sq.M})", cuda_mul.K8,
                   curve_err(G, [pick(cuda_mul.exp_const(G, x, e))], [G.exp_const_plain(pick(x), e)]),
                   _graph_ms(torch, lambda: cuda_mul.exp_const(G, x, e), 5),
                   _cuda_ms(torch, lambda: G.exp_const_plain(x, e), 1),
                   f"({n}, {N}), e = (p - 1) / 2", 2 * n * 4 * N,
                   products * mont_imads(nw, 12 * n > 32 * nw) * N)
        print(f"    {tag}: K8 at 2^16 lanes above; its chain {products} products; sqrt's K1 chain "
              f"{k1_chain} launches (squarings and masked products)")
        del y2, root, ok, x

    # Weierstrass, BLS12-377, on the 2^16 points of phase 4
    pts_n, points, logs = known["bls12-377"]
    O, h, q = curve.oracle, BLS12_377.cofactor, BLS12_377.order
    P4 = W.from_affine(points)

    def affine_of(Wc, R):
        pw = Wc.F.p
        return [None if Z == 0 else (X * pow(Z, -1, pw) % pw, Y * pow(Z, -1, pw) % pw)
                for X, Y, Z in Wc.unpack_projective(R)]

    ks = curve.random_scalars(N, seed=SEED + 7, device=dev)
    R = op("bls12-377 proj_scale_dyn 2^16 (264 bits)", lambda: W.proj_scale_dyn(ks, P4),
           (cuda_curve.K4M, cuda_curve.K6))
    check(affine_of(W, ProjectivePoints(*(pick(a) for a in R))) == [
        O.scale(k, pts_n[i]) for k, i in zip(curve.scalar.unpack(pick(ks).cpu()), sample.tolist())],
        "proj_scale_dyn differs from the host's double-and-add")
    check(bool(op("bls12-377 is_in_subgroup 2^16", lambda: W.is_in_subgroup(P4),
                  (cuda_curve.K4, cuda_curve.K6)).all()), "a subgroup point failed is_in_subgroup")
    off = []  # curve points without cofactor clearing (in the subgroup with odds 1/h)
    while len(off) < SAMPLE:
        xo = host_field.random_field(BLS12_377.modulus, orng)
        yo = host_field.sqrt((xo**3 + BLS12_377.b) % BLS12_377.modulus, BLS12_377.modulus)
        if yo is not None:
            off.append((xo, yo))
    Poff = W.from_affine(curve.points_from_ints(off, dev))
    check(not bool(W.is_in_subgroup(Poff).any()), "an off-subgroup point passed is_in_subgroup")
    cleared = op(f"bls12-377 to_subgroup {SAMPLE} off-subgroup points", lambda: W.to_subgroup(Poff),
                 (cuda_curve.K4, cuda_curve.K6))
    check(bool(W.is_in_subgroup(cleared).all()) and affine_of(W, cleared) == [O.scale(h, pt) for pt in off],
          "to_subgroup differs from the host's h P or left the subgroup")
    print(f"    bls12-377: proj_scale_dyn equals the host on {SAMPLE} lanes; is_in_subgroup true on "
          f"every lane, false on {SAMPLE} points off the subgroup; to_subgroup equals h P on them")
    mm12 = mont_imads(12, False)
    a4 = [field_elems(F, N) for _ in range(6)]
    m4 = flags(N)
    offl = m4 == 0
    kernel_row("k4m_2e16", "proj_add_masked_2e16", "K4m", "curve.cu", curve_line(382),
               "bls12-377 proj_scale_dyn 2^16 (264 bits)", cuda_curve.K4M,
               max(curve_err(F, cuda_curve.proj_add(W, *a4, mask=m4), cuda_curve.proj_add_plain(W, *a4, mask=m4)),
                   raw_err([g[:, offl] for g in cuda_curve.proj_add(W, *a4, mask=m4)], [a[:, offl] for a in a4[:3]])),
               _graph_ms(torch, lambda: cuda_curve.proj_add(W, *a4, mask=m4)),
               _cuda_ms(torch, lambda: cuda_curve.proj_add_plain(W, *a4, mask=m4), PLAIN_REPS),
               f"W={N}, masked", (9 * F.n + 1) * 4 * N, 12 * mm12 * int(m4.sum().item()))
    kernel_row("k6_2e16", "proj_double_2e16", "K6", "curve.cu", curve_line(394),
               "bls12-377 proj_scale_dyn 2^16 (264 bits)", cuda_curve.K6,
               curve_err(F, cuda_curve.proj_double(W, *a4[:3]), cuda_curve.proj_double_plain(W, *a4[:3])),
               _graph_ms(torch, lambda: cuda_curve.proj_double(W, *a4[:3])),
               _cuda_ms(torch, lambda: cuda_curve.proj_double_plain(W, *a4[:3]), PLAIN_REPS),
               f"W={N}", 6 * F.n * 4 * N, 8 * mm12 * N)
    del a4, R, P4, Poff, cleared

    # Edwards, ed-on-bls12-377, on the 2^16 points of phase 7
    pts_e, points_e, _ = known["ed-on-bls12-377"]
    OE, qe, he = ed.oracle, ED_ON_BLS12_377.order, ED_ON_BLS12_377.cofactor
    ext = [OE.from_affine(pts_e[i]) for i in sample.tolist()]

    def ed_affine(R):
        return [OE.to_affine(pt) for pt in E.unpack(ExtPoints(*(pick(a) for a in R)))]

    ke = ed.random_scalars(N, seed=SEED + 8, device=dev)
    R = op(ED_DYN_RUN, lambda: E.scale_dyn(ke, points_e), (cuda_edwards.K11M, cuda_edwards.K12))
    check(ed_affine(R) == [OE.to_affine(OE.scale(k, pt)) for k, pt in zip(ed.scalar.unpack(pick(ke).cpu()), ext)],
          "Edwards scale_dyn differs from the host's double-and-add")
    kc = int(rng.integers(1 << 62)) << 188 | int(rng.integers(1 << 62))  # a static 250-bit scalar
    R = op("ed-on-bls12-377 scale_const 2^16 (250 bits)", lambda: E.scale_const(kc, points_e),
           (cuda_edwards.K11, cuda_edwards.K12))
    check(ed_affine(R) == [OE.to_affine(OE.scale(kc, pt)) for pt in ext], "Edwards scale_const")
    check(bool(op("ed-on-bls12-377 is_in_subgroup 2^16", lambda: E.is_in_subgroup(points_e),
                  (cuda_edwards.K11, cuda_edwards.K12)).all()), "an Edwards subgroup point failed")
    off = []  # curve points with a component of order 2 or 4 (host-checked)
    pe, de = ED_ON_BLS12_377.modulus, ED_ON_BLS12_377.d
    while len(off) < SAMPLE:
        yo = host_field.random_field(pe, orng)
        xo = host_field.sqrt((yo * yo - 1) * pow(de * yo * yo + 1, -1, pe) % pe, pe)
        if xo is not None and not OE.is_zero(OE.scale(qe, OE.from_affine((xo, yo)))):
            off.append(OE.from_affine((xo, yo)))
    Poff = E.pack(off, dev)
    check(not bool(E.is_in_subgroup(Poff).any()), "an off-subgroup Edwards point passed")
    cleared = op(f"ed-on-bls12-377 to_subgroup {SAMPLE} off-subgroup points", lambda: E.to_subgroup(Poff),
                 (cuda_edwards.K12,))
    check(bool(E.is_in_subgroup(cleared).all()) and [OE.to_affine(pt) for pt in E.unpack(cleared)] == [
        OE.to_affine(OE.scale(he, pt)) for pt in off], "Edwards to_subgroup")
    print(f"    ed-on-bls12-377: scale_dyn and scale_const equal the host on {SAMPLE} lanes; "
          f"is_in_subgroup true on every lane, false on {SAMPLE} points off the subgroup; "
          f"to_subgroup equals {he} P on them")
    a11 = [field_elems(FE, N) for _ in range(8)]
    m11 = flags(N)
    kernel_row("k11m_2e16", "ed_add_masked_2e16", "K11", "edwards.cu",
               "msm_zprize_tpu/curves/pallas_curve.py:500", ED_DYN_RUN, cuda_edwards.K11M,
               k11_err(cuda_edwards.ed_add(E, *a11, mask=m11), cuda_edwards.ed_add_plain(E, *a11, mask=m11),
                       a11, {"mask": m11}),
               _graph_ms(torch, lambda: cuda_edwards.ed_add(E, *a11, mask=m11)),
               _cuda_ms(torch, lambda: cuda_edwards.ed_add_plain(E, *a11, mask=m11), PLAIN_REPS),
               f"W={N}, masked", (12 * FE.n + 1) * 4 * N, 9 * mm8 * int(m11.sum().item()))
    del a11, R, Poff, cleared

    # the special GLV split (BLS12-381's lambda ~ sqrt(q)), Barrett
    pts_c, points_c, logs_c = known["bls12-381"]
    S381 = GlvScalarSpecialMsm(BLS12_381.order, BLS12_381.lambda_)
    scal_c = c381.random_scalars(N, seed=SEED + 9, device=dev)
    scs_c = c381.scalar.unpack(scal_c.cpu())
    res = op("bls12-381 special-GLV msm 2^16",
             lambda: msm_batched_affine(c381.ops, S381, scal_c, points_c, mode="projective"),
             (cuda_curve.K3, cuda_curve.K4, cuda_curve.K5))
    check(run_counts["bls12-381 special-GLV msm 2^16"].get(cuda_scalar.KERNEL, 0) == 0,
          "the special split launched K2")
    check(c381.result_to_int(res) == expected_msm(BLS12_381, scs_c, logs_c),
          "the special-GLV MSM disagrees with the known-discrete-log result")
    sp = S381._sp
    lam, hb = sp.lambda_, sp.half_bits - 1
    g0, u0, u1 = op("bls12-381 decompose_no_msb 2^16", lambda: sp.decompose_no_msb(scal_c))
    half = LimbScheme(12, sp.n_half)
    host = []
    for v in (scs_c[i] for i in sample.tolist()):
        hi, lo = divmod(v, lam)
        host.append((1, lam - lo, hi + 1) if lo >> hb else (0, lo, hi))
    check(list(zip(pick(g0).tolist(), unpack(pick(u0), half), unpack(pick(u1), half))) == host,
          "decompose_no_msb differs from the host's integer division")
    br = BarrettReducer(BLS12_381.modulus)
    bits = 2 * br.b - 2  # values below 2^(2b - 2) <= p^2
    xl = rng.integers(0, 1 << 12, size=(2 * br.n, N), dtype=np.int32)
    xl &= ((1 << np.clip(bits - 12 * np.arange(2 * br.n), 0, 12)) - 1).astype(np.int32)[:, None]
    xb = torch.as_tensor(xl, device=dev)
    rb = op("bls12-381 Barrett reduce 2^16 (x < p^2)", lambda: br.reduce(xb))
    check(unpack(pick(rb), br.scheme) == [v % br.p for v in unpack(pick(xb), LimbScheme(12, 2 * br.n))],
          "Barrett reduce differs from %")
    print(f"    bls12-381: the special-GLV MSM equals (sum s_i a_i mod q) G with no K2 launch; "
          f"decompose_no_msb and Barrett equal the host on {SAMPLE} lanes")
    del res, g0, u0, u1, xb, rb

    # the 51x5 engine and the bytes codec
    q377 = BLS12_377.order
    F51 = make_fma51_field(q377)
    vals = [[host_field.random_field(q377, orng) for _ in range(N)] for _ in range(2)]
    X51, Y51 = (F51.pack(v, dev) for v in vals)
    picked = [[v[i] for i in sample.tolist()] for v in vals]
    got = {name: op(f"bls12-377 scalar field Fma51Field.{name} 2^16", lambda fn=fn: fn(X51, Y51))
           for name, fn in (("montmul", F51.montmul), ("add", F51.add), ("sub", F51.sub))}
    want = {"montmul": [a * b % q377 for a, b in zip(*picked)], "add": [(a + b) % q377 for a, b in zip(*picked)],
            "sub": [(a - b) % q377 for a, b in zip(*picked)]}
    for name, out in got.items():
        check(F51.unpack(pick(out)) == want[name], f"Fma51Field.{name}")
    raw = F51.montmul(pick(X51), pick(Y51))  # on the Montgomery-form limbs, as the model takes them
    xm, ym = (F51.unpack(pick(t), montgomery=False) for t in (X51, Y51))
    check(F51.unpack(raw, montgomery=False) == [montmul_fma_model(q377, a, b) % q377 for a, b in zip(xm, ym)],
          "Fma51Field.montmul differs from montmul_fma_model")
    del X51, Y51, got
    scheme = curve.scalar.scheme
    limbs = curve.random_scalars(N, seed=SEED + 10, device="cpu").numpy()
    t0 = time.perf_counter()
    data = limbs_to_bytes(limbs, scheme)
    back = bytes_to_limbs(data, scheme)
    codec_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(back, limbs), "bytes_to_limbs(limbs_to_bytes(x)) != x")
    print(f"    Fma51Field montmul, add, sub equal the host on {SAMPLE} lanes, montmul also "
          f"montmul_fma_model; bytes_to_limbs(limbs_to_bytes(x)) == x at {N} scalars "
          f"({data.shape[1]} bytes each), {codec_ms:.1f} ms on the host")

    # compute_msm at 2^16: one run of its body's stages, one after another
    # through submission.py's own helpers (host clock, synchronised between
    # stages; each share is of that run's sum), then one whole call
    scs_n = curve.scalar.unpack(curve.random_scalars(N, seed=SEED + 11, device="cpu"))
    compute_msm(pts_n, scs_n, device=dev)  # warm
    t = [time.perf_counter()]
    pts_i, scs_i = _to_int_points(pts_n), _to_int_scalars(scs_n)
    t.append(time.perf_counter())
    run = _pick_msm(curve, pts_i)
    t.append(time.perf_counter())
    s_dev = curve.scalars_from_ints(scs_i, dev)
    t.append(time.perf_counter())
    p_dev = curve.points_from_ints(pts_i, dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    res = run(s_dev, p_dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    out = curve.result_to_int(res)
    t.append(time.perf_counter())
    whole = time.perf_counter()
    check(compute_msm(pts_n, scs_n, device=dev) == out == expected_msm(BLS12_377, scs_n, logs),
          "compute_msm's stages disagree with it or with the known logs")
    whole = (time.perf_counter() - whole) * 1e3
    st = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    share = [100 * v / sum(st) for v in (sum(st[:4]), st[4], st[5])]
    print(f"    compute_msm({N}) stages, one run (host clock, ms): decode {sum(st[:4]):.1f} "
          f"({share[0]:.1f} %: ints {st[0]:.1f}, same-point check {st[1]:.1f}, scalar limbs to the "
          f"card {st[2]:.1f}, point limbs in Montgomery form to the card {st[3]:.1f}), MSM {st[4]:.1f} "
          f"({share[1]:.1f} %), result {st[5]:.1f} ({share[2]:.1f} %), sum {sum(st):.1f}; a whole "
          f"compute_msm call, another run: {whole:.1f}")
    print(f"    phase 16 took {time.perf_counter() - t16:.1f} s")

    # ---- 17. the sharded MSM over a torch.distributed mesh -----------------------------
    # (a) one rank, NCCL, in this process: what the mesh path costs at d = 1;
    # (b) two ranks sharing this card over gloo (NCCL refuses two ranks on one
    # card), each a process of its own: the exchange and the combine's adds
    t17 = time.perf_counter()
    print("[17 mesh] the sharded MSM (parallel/mesh.py): a one-rank NCCL mesh in this process, "
          f"then {MESH_RANKS} ranks on this card over gloo")
    store = _build.BUILD_DIR / f"nccl_store_{os.getpid()}"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh1 = make_mesh()
        for label, cv, params, expected in (("bls12-377", curve, BLS12_377, expected_msm),
                                            ("ed-on-bls12-377", ed, ED_ON_BLS12_377, ed_expected_msm)):
            path = mesh_ranks.CARD_PATHS[label]
            _, pts_dev, logs_k = known[label]
            scal17 = cv.random_scalars(N, seed=SEED + 17, device=dev)
            want17 = expected(params, cv.scalar.unpack(scal17.cpu()), logs_k)
            unsharded = cv.result_to_int(cv.msm(scal17, pts_dev))
            if unsharded != want17:
                raise AssertionError(f"{label}: the unsharded MSM disagrees with the known logs")
            for what, run in (
                ("msm(mesh=one-rank NCCL mesh)",
                 lambda cv=cv, s=scal17, p=pts_dev: cv.msm(s, p, mesh=mesh1)),
                ("msm (unsharded, the same inputs)", lambda cv=cv, s=scal17, p=pts_dev: cv.msm(s, p)),
            ):
                drive(f"{label} {what}", run, path, equals_known(f"{label} {what}", cv, want17))
            counts = run_counts[f"{label} msm(mesh=one-rank NCCL mesh)"]
            print(f"    {label} on the one-rank mesh: exchange {counts.get('exchange_bytes', 0)} B, "
                  f"gather {counts.get('gather_bytes', 0)} B (an axis of size 1 exchanges nothing)")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)

    compute_mode = _smi("compute_mode")
    print(f"    compute mode of the card: {compute_mode}")
    if compute_mode != "Default":
        raise AssertionError(f"the card's compute mode is {compute_mode}: it cannot host "
                             f"{MESH_RANKS} rank processes")
    pts_b, _, logs_b = known["bls12-377"]
    pts_e17, _, logs_e17 = known["ed-on-bls12-377"]
    scs_cm = curve.scalar.unpack(curve.random_scalars(N_MESH_COMPUTE, seed=SEED + 18, device="cpu"))
    inputs = {"N": N, "seed": SEED + 17, "bls12-377": pts_b, "ed-on-bls12-377": pts_e17,
              "compute_msm": (scs_cm, pts_b[:N_MESH_COMPUTE])}
    want = {
        "bls12-377": expected_msm(BLS12_377, curve.scalar.unpack(
            curve.random_scalars(N, seed=SEED + 17, device="cpu")), logs_b),
        "ed-on-bls12-377": ed_expected_msm(ED_ON_BLS12_377, ed.scalar.unpack(
            ed.random_scalars(N, seed=SEED + 17, device="cpu")), logs_e17),
        "compute_msm": expected_msm(BLS12_377, scs_cm, logs_b[:N_MESH_COMPUTE]),
    }
    t0 = time.perf_counter()
    results = launch.spawn(mesh_ranks.card_ranks, MESH_RANKS, device="cuda", backend="gloo",
                           args=(inputs,))
    spawn_s = time.perf_counter() - t0
    mesh_ranks.check_card_ranks(results, want)
    print(f"    {MESH_RANKS} ranks (gloo, one card; {spawn_s:.1f} s with the processes' start and "
          "their input conversion): every rank's every run equals the known-discrete-log result "
          "and launched every kernel of its path; per rank, the counted run after one warm run "
          f"(compute_msm at N = {N_MESH_COMPUTE}: one call with its decode) on {card}:")
    for rank, res in enumerate(results):
        for label, run in res.items():
            if label == "foreign":
                continue
            c = run["counts"]
            kernels = {k: v for k, v in sorted(c.items()) if k.startswith("k")}
            peak = f"; peak device memory {run['peak_gib']:.2f} GiB" if "peak_gib" in run else ""
            print(f"      rank {rank} {label}: {run['ms']:.1f} ms; exchange (all_to_all) "
                  f"{int(c.get('exchange_bytes', 0))} B in {c.get('exchange_ms', 0.0):.2f} ms, gather "
                  f"{int(c.get('gather_bytes', 0))} B in {c.get('gather_ms', 0.0):.2f} ms; launches "
                  f"{kernels}{peak}")
    print(f"    phase 17 took {time.perf_counter() - t17:.1f} s")

    # ---- 18. queue 3's fault 3: every field make_field takes, on the card -----------
    # K1 and K8 on every EXAMPLE_FIELDS field and on the two synthetic primes at
    # the ends of the limb code's domain (n = 1 and n = 63): the fields outside
    # the four shapes of the main library build a shape of their own at first
    # use (_build.field_shape, _build.library(shape); built here all at once).
    # Each field's run: the user's entry points (MontgomeryFp.montmul,
    # exp_const, inverse) at 4 lanes, against the host's ints; then K1 and K8
    # against their twins at W = 1, 4 and 65,536 (the row), K1 limb for limb
    # where the twin defines the integer (4p < 2^(32 NW)). Then every
    # limb-storage curve kernel (K3, K4, K4m, K5, K6, K7, K10, K11, the
    # masked K11, K12; 3b no small integer: one product by 3b R) on
    # goldilocks, babybear and secp256k1's base field, with random curve
    # constants, against their twins at 65,536 lanes, a row each; n = 63
    # refused by the curve entries; then the equivalence harness on the card.
    t18 = time.perf_counter()
    sids18 = {name: _build.field_shape(G) for name, G in made18.items()}
    dyn18 = sorted({s for s in sids18.values() if s >= _build.DYN_ID_BASE})
    builds18 = {s: dyn_builds[s].result() for s in dyn18}
    print(f"[18 shapes] {len(dyn18)} shapes made on demand, built in the background since phase 1 "
          f"(waited {time.perf_counter() - t18:.1f} s here, {time.perf_counter() - t_dyn:.1f} s after "
          f"the builds started; main library untouched: {info.path.name}); each: "
          + "; ".join(f"shape {s} = (n, NW) {_build.shape_layout(s)[:2]}: nvcc {b.seconds:.1f} s "
                      f"({b.path.name})" for s, b in builds18.items()))
    def ptxas_lines(tag, log):
        """One line a kernel of a library's build log: registers, stack, spills
        (the storage is named where a kernel is built for several)."""
        kern, props = None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '_Z\w*?\d+([a-z_]+_kernel)(\w*)'", line)
            if m:
                rows = re.search(r"Packed31ILi(\d+)", m.group(2))
                store = (f" <{rows.group(1)} packed rows>" if rows else " <Fma51 rows>"
                         if "Fma51Rows" in m.group(2) else " <limbs>" if "LimbStore" in m.group(2)
                         else "")
                kern = m.group(1) + ("<masked>" if "Lb1EEEv" in m.group(2) else "") + store
            elif kern and "stack frame" in line:
                props[kern] = line.split(":")[-1].strip()
            elif kern and "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"    ptxas {tag}: {kern}: {regs} registers; {props.get(kern, '')}")

    for s18, b in builds18.items():  # one line a kernel: registers, stack, spills
        ptxas_lines(f"shape {s18}", b.log)
        # K10's instances; none may have a stack frame or a spill at n = 63
        _k10_report(f"shape {s18} (n, NW) {_build.shape_layout(s18)[:2]}", b, bindir,
                    clean=_build.shape_layout(s18)[0] == 63)

    def once_ms(fn):
        """CUDA-event ms of one fn() call, and its result."""
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    W18 = (1, 4, N)
    for name, G in made18.items():
        p, sid = G.p, sids18[name]
        n, nw, carry = _build.shape_layout(sid)
        rw, tail = divmod(12 * n, 32)
        mm = mont_imads(nw, tail > 0, rw)
        run18 = f"phase 18 {name} montmul, exp_const, inverse"
        x4, y4 = field_elems(G, 4, (1, 2, 3, 5)), field_elems(G, 4, (p - 1, 7, 11, 13))  # nonzero
        torch.cuda.synchronize()
        counters.reset()
        outs = (G.montmul(x4, y4), G.exp_const(x4, p - 2), G.inverse(x4))
        torch.cuda.synchronize()
        run_counts[run18] = counters.snapshot()
        launches_of(run_counts[run18], (cuda_mul.KERNEL, cuda_mul.K8), run18)
        xs, ys = G.unpack(x4), G.unpack(y4)
        want4 = ([a * b % p for a, b in zip(xs, ys)], [pow(a, p - 2, p) for a in xs],
                 [pow(a, -1, p) for a in xs])
        if [G.unpack(o) for o in outs] != list(want4):
            raise AssertionError(f"phase 18 {name}: montmul / exp_const / inverse disagree with the host")
        k1_err = k8_err = 0
        for W in W18:
            x = field_elems(G, W, (4 * p - 1, 2 * p - 1, 1))
            y = field_elems(G, W, (4 * p - 1, 1, 2 * p - 2))
            got, want = cuda_mul.montmul(G, x, y), G.montmul_plain(x, y)
            k1_err = max(k1_err, mod_p_err(G, [got], [want]) if carry else raw_err([got], [want]))
            if W == N:
                k8_plain_ms, want8 = once_ms(lambda: G.exp_const_plain(x, p - 2))
            else:
                want8 = G.exp_const_plain(x, p - 2)
            k8_err = max(k8_err, curve_err(G, [cuda_mul.exp_const(G, x, p - 2)], [want8]))
        products = cuda_mul.exp_products(cuda_mul.exp_chain(p - 2))
        design = "warp" if -(-32 * nw // 30) <= 13 else "one thread a lane"
        shape_txt = f"shape {sid} (n = {n}, NW = {nw}, {rw} rounds + {tail}-bit tail)"
        kernel_row(f"k1_f_{name}", f"montmul_{name}", "K1", "montmul.cu",
                   "msm_zprize_tpu/fields/pallas_mul.py:167", run18, cuda_mul.KERNEL, k1_err,
                   _graph_ms(torch, lambda: cuda_mul.montmul(G, x, y)),
                   _cuda_ms(torch, lambda: G.montmul_plain(x, y), PLAIN_REPS),
                   f"({n}, {N}) {shape_txt}; W = 1, 4 too", 3 * n * 4 * N, mm * N)
        kernel_row(f"k8_f_{name}", f"exp_const_{name}", "K8", "montmul.cu",
                   "msm_zprize_tpu/fields/pallas_mul.py:237", run18, cuda_mul.K8, k8_err,
                   _graph_ms(torch, lambda: cuda_mul.exp_const(G, x, p - 2), 3), k8_plain_ms,
                   f"({n}, {N}), e = p - 2 ({products} products, {design}) {shape_txt}; W = 1, 4 too",
                   2 * n * 4 * N, products * mm * N)
        del x, y, got, want, want8

    # every limb-storage curve kernel on three shapes made on demand, random
    # constants; the masked kernels' masked-off lanes P1's limbs bit for bit
    crng = random.Random(SEED)
    for name in ("goldilocks", "babybear", "secp256k1-fp"):
        G = made18[name]
        p, (n, nw, _) = G.p, _build.shape_layout(sids18[name])
        rw, tail = divmod(12 * n, 32)
        mm = mont_imads(nw, tail > 0, rw)
        Wc = types.SimpleNamespace(F=G, b3_mont=crng.randrange(2, p) * G.R % p, b3_small=None,
                                   storage=cuda_curve.Storage(G.n))
        E18 = types.SimpleNamespace(F=G, k_mont=crng.randrange(2, p) * G.R % p, two_mont=2 * G.R % p)
        P1, P2 = [field_elems(G, N) for _ in range(3)], [field_elems(G, N) for _ in range(3)]
        Q1, Q2 = [field_elems(G, N) for _ in range(4)], [field_elems(G, N) for _ in range(4)]
        inf, m4, m11 = flags(N), flags(N), flags(N)
        slots = [field_elems(G, N), field_elems(G, N), flags(N), flags(N),
                 field_elems(G, N), field_elems(G, N), flags(N), flags(N)]
        # kernel: (launch, twin, k, lanes computing, (mask, P1) for the pass-through)
        calls = {
            cuda_curve.K3: (lambda: cuda_curve.aff_pair_add(Wc, *slots),
                            lambda: cuda_curve.aff_pair_add_plain(Wc, *slots), 0, None, None),
            cuda_curve.K4: (lambda: cuda_curve.proj_add(Wc, *P1, *P2),
                            lambda: cuda_curve.proj_add_plain(Wc, *P1, *P2), 0, None, None),
            cuda_curve.K4M: (lambda: cuda_curve.proj_add(Wc, *P1, *P2, mask=m4),
                             lambda: cuda_curve.proj_add_plain(Wc, *P1, *P2, mask=m4), 0,
                             int(m4.sum()), (m4, P1)),
            cuda_curve.K5: (lambda: cuda_curve.proj_double_k(Wc, *P1, 3),
                            lambda: cuda_curve.proj_double_k_plain(Wc, *P1, 3), 3, None, None),
            cuda_curve.K6: (lambda: cuda_curve.proj_double(Wc, *P1),
                            lambda: cuda_curve.proj_double_plain(Wc, *P1), 0, None, None),
            cuda_curve.K7: (lambda: cuda_curve.proj_add_mixed(Wc, *P1, *P2[:2], inf),
                            lambda: cuda_curve.proj_add_mixed_plain(Wc, *P1, *P2[:2], inf), 0,
                            int(inf.eq(0).sum()), (inf.eq(0), P1)),
            cuda_edwards.K10: (lambda: cuda_edwards.ed_pair_add(E18, *slots),
                               lambda: cuda_edwards.ed_pair_add_plain(E18, *slots), 0, None, None),
            cuda_edwards.K11: (lambda: cuda_edwards.ed_add(E18, *Q1, *Q2),
                               lambda: cuda_edwards.ed_add_plain(E18, *Q1, *Q2), 0, None, None),
            cuda_edwards.K11M: (lambda: cuda_edwards.ed_add(E18, *Q1, *Q2, mask=m11),
                                lambda: cuda_edwards.ed_add_plain(E18, *Q1, *Q2, mask=m11), 0,
                                int(m11.sum()), (m11, Q1)),
            cuda_edwards.K12: (lambda: cuda_edwards.ed_double_k(E18, *Q1, 3),
                               lambda: cuda_edwards.ed_double_k_plain(E18, *Q1, 3), 3, None, None),
        }
        run18 = f"phase 18 curve kernels on {name}"
        torch.cuda.synchronize()
        counters.reset()
        gots = {key: fns[0]() for key, fns in calls.items()}
        torch.cuda.synchronize()
        run_counts[run18] = counters.snapshot()
        launches_of(run_counts[run18], list(calls), run18)
        for key, (kern, plain, k, computing, keep) in calls.items():
            plain_ms, want = once_ms(plain)
            # K3 as phase 2 holds it: mod p (its outputs need not be below 2p);
            # K10 every built instance, below 2p
            err = (mod_p_err if key == cuda_curve.K3 else curve_err)(G, gots[key], want)
            if key == cuda_edwards.K10:
                err = max(err, k10_err(E18, slots, want))
            if keep is not None:
                off = keep[0] == 0
                err = max(err, raw_err([g[:, off] for g in gots[key]], [a[:, off] for a in keep[1]]))
            nbytes, imads = curve_work(key, n, mm, N, k, computing)
            kid = key.split("_")[0]
            edwards = key in (cuda_edwards.K10, cuda_edwards.K11, cuda_edwards.K11M, cuda_edwards.K12)
            kernel_row(f"{key}_f_{name}", f"{key.split('_', 1)[1]}_{name}",
                       {"k4m": "K4m", "k11m": "K11"}.get(kid, kid.upper()),
                       "edwards.cu" if edwards else "curve.cu",
                       curve_line(149), run18, key, err, _graph_ms(torch, kern), plain_ms,
                       f"({n}, {N}) shape {sids18[name]}" + (f", k = {k}" if k else "")
                       + (", masked" if keep is not None and key != cuda_curve.K7 else "")
                       + (", k R random" if edwards else ", 3b R by a product"),
                       nbytes, imads)
        del P1, P2, Q1, Q2, slots, gots
    # the equivalence harness (testing/equivalent.py) on the card: the JAX
    # harness test's four extra fields, mul / add / sub, and inverse(0) flagged
    run18 = "phase 18 harness"
    torch.cuda.synchronize()
    counters.reset()
    for name in ("ed25519-fp", "secp256k1-fp", "goldilocks", "babybear"):
        G, p = made18[name], fields18[name]
        spec = field_spec(G, Random.field(p), batch=4, device="cuda")
        runs = dict(min_runs=8, max_runs=8)
        equivalent(frm=[spec, spec], to=spec, label=f"{name} mul", **runs)(lambda a, b: a * b % p, G.montmul)
        equivalent(frm=[spec, spec], to=spec, label=f"{name} add", **runs)(lambda a, b: (a + b) % p, G.add)
        equivalent(frm=[spec, spec], to=spec, label=f"{name} sub", **runs)(lambda a, b: (a - b) % p, G.sub)
        zero = Spec(lambda r: 0, spec.there, spec.back)
        try:
            equivalent(frm=[zero], to=spec, label=f"{name} inv0", min_runs=1, max_runs=1)(
                lambda a: pow(a, -1, p), G.inverse)
            raise RuntimeError(f"{name}: inverse(0) was not flagged")
        except AssertionError:
            pass  # the reference throws, the port returns 0: flagged, as in the JAX test
    torch.cuda.synchronize()
    run_counts[run18] = counters.snapshot()
    launches_of(run_counts[run18], (cuda_mul.KERNEL, cuda_mul.K8), run18)
    print(f"[18 harness] mul, add, sub equal the host's on the card on ed25519, secp256k1, "
          f"goldilocks and babybear (8 draws x 4 lanes each); inverse(0) flagged on each; launches "
          f"{ {k: v for k, v in run_counts[run18].items() if k.startswith('k')} }")
    print(f"    phase 18 took {time.perf_counter() - t18:.1f} s")

    # ---- 19. the tools on the card ------------------------------------------------------
    t19 = time.perf_counter()
    tool19 = {}
    for argv in (["bls12-377", "16", "--runs", "10", "--warmup", "3", "--verbose"],
                 ["bls12-377", "20", "--runs", "5", "--warmup", "2", "--points", "logs"],
                 ["ed-on-bls12-377", "16", "--runs", "10", "--warmup", "3"]):
        t0 = time.perf_counter()
        res = run_msm.main(argv)
        tool19[f"{argv[0]} 2^{argv[1]}"] = res
        peak = f"{res['peak_bytes'] / 2**30:.2f} GiB" if res["peak_bytes"] else "not measured"
        print(f"[19 run_msm] {' '.join(argv)}: {res['median_ms']:.3f} +- {res['std_ms']:.3f} ms "
              f"(median +- sigma) on {card}; peak device memory {peak}; checked "
              f"{res.get('checked', [])}; {time.perf_counter() - t0:.1f} s with its set-up")
    if tool19["bls12-377 2^20"].get("checked") != ["known logs"]:
        raise AssertionError("the 2^20 MSM was not held against the known-discrete-log result")
    print("[19 field_benchmark] bls12-377:")
    field_benchmark.main(["bls12-377"])
    print("[19 evaluate_msm] bls12-377 2^16, c = 10..14 in turns (records only; the window "
          "table stays):")
    sweep = evaluate_msm.main(["bls12-377", "16", "--cmin", "10", "--cmax", "14", "--runs", "10"])
    # the sweep's reading of the table's c against run_msm's of the same MSM
    # (c = None, the table's c) just before the sweep and just after it
    again = run_msm.main(["bls12-377", "16", "--runs", "10", "--warmup", "3"])
    c12 = sweep["default"]
    print(f"[19 sweep check] bls12-377 2^16, c = {c12}: sweep {sweep['table'][c12][0]:.3f} +- "
          f"{sweep['table'][c12][1]:.3f} ms; run_msm before it "
          f"{tool19['bls12-377 2^16']['median_ms']:.3f} +- {tool19['bls12-377 2^16']['std_ms']:.3f}, "
          f"after it {again['median_ms']:.3f} +- {again['std_ms']:.3f} (median +- sigma, on {card})")
    print("[19 scaling_bench] bls12-377 2^16, d = 1 on NCCL (a process of its own):")
    scaling_bench.main(["bls12-377", "16", "--devices", "1", "--backend", "nccl", "--runs", "5"])
    print(f"    phase 19 took {time.perf_counter() - t19:.1f} s")

    # ---- 20. the wide fields: BN462 (n = 39), ed25519 and n = 63 ------------------------
    # Queue 3's last kernels through the normal entry points: the curve
    # kernels of shapes made on demand up to n = 63, K2 on a scalar module of
    # other sizes (its own library), K13 and K14 on the codec rows of shapes
    # made on demand. BN462 (testing/wide_curves.py: 15 words, 15 packed rows,
    # a 39-limb scalar module) runs Weierstrass.create(BN462).msm at N = 8 in
    # every mode and at 2^16 in "projective" and "packed"; ed25519 (the
    # 9-word shape) runs TwistedEdwards.create(ED25519).msm at N = 8 and at
    # 2^16 "padded". Then every new kernel instance against its twin, a row
    # each: at n = 39 K1, K2, K3, K4, K5 and K14 at the widths of BN462's
    # 2^16 runs (read from cuda_curve.LAUNCH_LOG), the others at 65,536
    # lanes; ed25519's K9-K12 at the widths of its padded run; at n = 63
    # (phase 18's 751-bit field) the limb curve kernels and K13/K14 on its 25
    # packed rows at 65,536 lanes, on points of y^2 = x^3 + 7 with random Z;
    # K13/K14 on goldilocks's Fma51Codec and PackedCodec rows. Twins run
    # once (their time is that call's).
    t20 = time.perf_counter()
    c255 = TwistedEdwards.create(ED25519)
    G39, G63, Ggl, S462 = c462.ops.F, made18["n63-p751"], made18["goldilocks"], c462.scalar
    dims462 = cuda_scalar._dims(S462)
    sid39 = _build.field_shape(G39)
    b39, bsc = dyn_builds[sid39].result(), scalar_build.result()
    print(f"[20 builds] BN462's field shape {sid39} ((n, NW) {_build.shape_layout(sid39)[:2]}, "
          f"{_build.shape_rows(sid39)} packed rows): nvcc {b39.seconds:.1f} s ({b39.path.name}); "
          f"its scalar module {dims462} (n, n_half, n_acc, K0, n_m, words of s): nvcc "
          f"{bsc.seconds:.1f} s ({bsc.path.name}); both built in the background since phase 1 "
          f"(n = 63, ed25519's and goldilocks's shapes: phase 18's libraries)")
    ptxas_lines(f"shape {sid39}", b39.log)
    _k10_report(f"shape {sid39} (n, NW) {_build.shape_layout(sid39)[:2]}", b39, bindir)
    ptxas_lines("BN462 scalar module", bsc.log)

    # BN462: N = 8 and edge cases against both host oracles, then the other
    # modes at N = 8 with random Z / random points / a subgroup check (K6)
    small_msms("bn462", 20, c462, BN462, points_with_logs, expected_msm, naive_msm)
    pts8, logs8 = points_with_logs(BN462, 8, seed=SEED + 3)
    points8 = c462.points_from_ints(pts8, dev)
    scal8 = c462.random_scalars(8, seed=SEED + 3, device=dev)
    want8 = expected_msm(BN462, c462.scalar.unpack(scal8.cpu()), logs8)
    z8 = field_elems(G39, 8)
    proj8 = ProjectivePoints(G39.montmul(points8.x, z8), G39.montmul(points8.y, z8), z8)
    for what, run, keys, absent in (
        ("msm(mode='packed')", lambda: c462.msm(scal8, points8, mode="packed"), *codec_run("packed")),
        ("msm(mode='affine')", lambda: c462.msm(scal8, points8, mode="affine"),
         glv + (cuda_mul.K8, cuda_curve.K7) + finals, ()),
        ("msm_unsafe(mode='affine')", lambda: c462.msm_unsafe(scal8, points8, mode="affine"),
         glv + (cuda_mul.K8, cuda_curve.K7) + finals, ()),
        ("msm(mode='halving')", lambda: c462.msm(scal8, points8, mode="halving"),
         glv + (cuda_curve.K4M,) + finals, ()),
        ("msm_projective (random Z)", lambda: c462.msm_projective(scal8, proj8),
         (cuda_scalar.K9,) + finals, ()),
    ):
        drive(f"bn462 N=8 {what}", run, keys, equals_known(f"bn462 N=8 {what}", c462, want8),
              absent=absent)
    del proj8
    counters.reset()
    qP = c462.ops.proj_scale_const(BN462.order, c462.ops.from_affine(points8))
    torch.cuda.synchronize()
    counts = run_counts["bn462 N=8 subgroup check"] = counters.snapshot()
    if not bool(G39.is_zero(qP.Z).all()):
        raise AssertionError("bn462: q P != 0 on the card")
    print(f"    bn462: q P = 0 on the card for its N = 8 points (launches "
          f"{launches_of(counts, (cuda_curve.K6, cuda_curve.K4), 'bn462 subgroup check')})")

    # BN462 at 2^16: points of known logs made on the card (K7 over 8 tables
    # of known-log bases), "projective" and "packed" against the known-log sum
    t0 = time.perf_counter()
    points462, expected462 = table_points_with_logs(c462, N, seed=SEED, device=dev)
    scal462 = c462.random_scalars(N, seed=SEED + 1, device=dev)
    want462 = expected462(scal462)
    print(f"[20 msm 2^{LOG_N}] bn462: each result equals (sum s_i a_i mod q) G (points of known logs "
          f"made on the card, {time.perf_counter() - t0:.1f} s with the host's bases)")
    widths20 = {}  # (curve, counter) -> the launches' (width, k) in the run of its path
    for mode, (keys, absent) in (("projective", (glv + (cuda_curve.K3,) + finals, all_codec)),
                                 ("packed", codec_run("packed"))):
        what = f"bn462 msm(mode='{mode}') 2^16"
        cuda_curve.LAUNCH_LOG = []
        drive(what, lambda mode=mode: c462.msm(scal462, points462, mode=mode), keys,
              equals_known(what, c462, want462), absent=absent)
        for key, width, k, *_ in cuda_curve.LAUNCH_LOG:
            widths20.setdefault(("bn462", key), set()).add((width, k))
        cuda_curve.LAUNCH_LOG = None

    # ed25519: N = 8 and edge cases, the basic mode, and 2^16 padded
    small_msms("ed25519", 20, c255, ED25519, ed_points_with_logs, ed_expected_msm, ed_naive_msm)
    epts8, elogs8 = ed_points_with_logs(ED25519, 8, seed=SEED + 3)
    escal8 = c255.random_scalars(8, seed=SEED + 3, device=dev)
    drive("ed25519 N=8 msm(mode='basic')",
          lambda: c255.msm(escal8, c255.points_from_ints(epts8, dev), mode="basic"),
          (cuda_scalar.K9, cuda_edwards.K11, cuda_edwards.K12),
          equals_known("ed25519 N=8 msm(mode='basic')", c255,
                       ed_expected_msm(ED25519, c255.scalar.unpack(escal8.cpu()), elogs8)))
    t0 = time.perf_counter()
    points255, expected255 = table_points_with_logs(c255, N, seed=SEED, device=dev)
    scal255 = c255.random_scalars(N, seed=SEED + 1, device=dev)
    print(f"[20 msm 2^{LOG_N}] ed25519: the result equals (sum s_i a_i mod l) B (points of known "
          f"logs made on the card, {time.perf_counter() - t0:.1f} s)")
    ed255_run = "ed25519 msm(mode='padded') 2^16"
    cuda_curve.LAUNCH_LOG = []
    drive(ed255_run, lambda: c255.msm(scal255, points255),
          (cuda_mul.KERNEL, cuda_mul.K8, cuda_scalar.K9, cuda_edwards.K10, cuda_edwards.K11,
           cuda_edwards.K12), equals_known(ed255_run, c255, expected255(scal255)))
    for key, width, k, *_ in cuda_curve.LAUNCH_LOG:
        widths20.setdefault(("ed25519", key), set()).add((width, k))
    cuda_curve.LAUNCH_LOG = None

    # the kernel rows
    proj462, packed462 = "bn462 msm(mode='projective') 2^16", "bn462 msm(mode='packed') 2^16"

    def widest(curve_, key):
        return max(widths20[(curve_, key)])

    def row20(key, name, kid, source, line, run, counter, G, launch, plain, shape, work, keep=None,
              err_of=None):
        """One phase-20 row: the kernel against its twin (run once, timed
        by that call), the kernel timed by CUDA-graph replay; ``keep`` =
        (mask, P1): lanes where mask == 0 must be P1's rows bit for bit."""
        got = launch()
        plain_ms, want = once_ms(plain)
        err = (err_of or (lambda g, w: curve_err(G, g, w)))(got, want)
        if keep is not None:
            off = keep[0] == 0
            err = max(err, raw_err([g[:, off] for g in got], [a[:, off] for a in keep[1]]))
        kernel_row(key, name, kid, source, line, run, counter, err, _graph_ms(torch, launch),
                   plain_ms, shape, *work)

    def curve_rows(tag, G, Wc, E, point, aff, elem, widths, runs, source, codec=None):
        """Every curve kernel on one storage of G, a row each: K3-K7 (and,
        on limbs, K10-K12 with E's random k), each at its (width, k) in
        ``widths``, on projective points from ``point`` (X, Y, Z), affine
        ones from ``aff`` (x, y) and, for the Edwards kernels, field values
        from ``elem``; the run that gives each row's launches is
        ``runs[kernel]``."""
        n, nw, _ = _build.shape_layout(_build.field_shape(G))
        rw, tail = divmod(12 * n, 32)
        mm = mont_imads(nw, tail > 0, rw)
        nr = n if codec is None else codec.rows
        pre, keys = ("", {k: k for k in cuda_curve.KERNEL_IDS}) if codec is None else (
            ("k14_fma51_", cuda_curve.K14_FMA51) if isinstance(codec, Fma51Codec)
            else ("k14_", cuda_curve.K14))
        err_of = ((lambda g, w: curve_err(G, g, w)) if codec is None
                  else (lambda g, w: rows_err(G, codec, g, w)))
        cname = "" if codec is None else f"_{type(codec).__name__}"
        kid = (lambda k: k) if codec is None else (lambda k: "K14-" + k)
        for kernel, line in ((cuda_curve.K3, 372), (cuda_curve.K4, 382), (cuda_curve.K4M, 382),
                             (cuda_curve.K5, 324), (cuda_curve.K6, 394), (cuda_curve.K7, 397)):
            width, k = widths[kernel]
            short = kernel.split("_")[0]
            if kernel == cuda_curve.K3:
                x1, y1 = aff(width)
                x2, y2 = aff(width)
                a = [x1, y1, flags(width), flags(width), x2, y2, flags(width), flags(width)]
                call = (lambda a=a: cuda_curve.aff_pair_add(Wc, *a),
                        lambda a=a: cuda_curve.aff_pair_add_plain(Wc, *a), None, None)
            elif kernel in (cuda_curve.K4, cuda_curve.K4M):
                a = [*point(width), *point(width)]
                m = flags(width) if kernel == cuda_curve.K4M else None
                call = (lambda a=a, m=m: cuda_curve.proj_add(Wc, *a, mask=m),
                        lambda a=a, m=m: cuda_curve.proj_add_plain(Wc, *a, mask=m),
                        None if m is None else int(m.sum()), None if m is None else (m, a[:3]))
            elif kernel == cuda_curve.K5:
                a = list(point(width))
                call = (lambda a=a, k=k: cuda_curve.proj_double_k(Wc, *a, k),
                        lambda a=a, k=k: cuda_curve.proj_double_k_plain(Wc, *a, k), None, None)
            elif kernel == cuda_curve.K6:
                a = list(point(width))
                call = (lambda a=a: cuda_curve.proj_double(Wc, *a),
                        lambda a=a: cuda_curve.proj_double_plain(Wc, *a), None, None)
            else:
                a = [*point(width), *aff(width)]
                i7 = flags(width)
                call = (lambda a=a, i7=i7: cuda_curve.proj_add_mixed(Wc, *a, i7),
                        lambda a=a, i7=i7: cuda_curve.proj_add_mixed_plain(Wc, *a, i7),
                        int(i7.eq(0).sum()), (i7.eq(0).int(), a[:3]))
            launch, plain, computing, keep = call
            # K3 as phase 2 holds it: mod p (its outputs need not be below 2p)
            row_err = ((lambda g, w: mod_p_err(G, g, w)) if codec is None and kernel == cuda_curve.K3
                       else err_of)
            row20(f"{pre}{short}_{tag}", f"{kernel.split('_', 1)[1]}{cname}_{tag}",
                  kid({"k4m": "K4m"}.get(short, short.upper())), source,
                  curve_line(line if codec is None else 149), runs[kernel], keys[kernel], G,
                  launch, plain, f"W={width}{f', k={k}' if k else ''}, {nr} rows",
                  curve_work(pre + kernel, nr, mm, width, k, computing), keep, row_err)
            del a
        if codec is not None:
            x, y = aff(N)
            fma = isinstance(codec, Fma51Codec)
            row20(f"k13{'_fma51' if fma else ''}_{tag}", f"montmul_rows{cname}_{tag}", "K13",
                  "montmul.cu", "msm_zprize_tpu/fields/fma51_pallas.py:302", runs["k13"],
                  cuda_codec.K13_FMA51 if fma else cuda_codec.K13, G,
                  lambda: [cuda_codec.montmul_rows(G, codec, x, y)],
                  lambda: [cuda_codec.montmul_rows_plain(G, codec, x, y)],
                  f"({nr}, {N}), n = {n}", (3 * nr * 4 * N, mm * N), err_of=err_of)
            del x, y
            return
        edw = "msm_zprize_tpu/curves/pallas_curve.py:{}".format
        for kernel, line in ((cuda_edwards.K10, 449), (cuda_edwards.K11, 500),
                             (cuda_edwards.K11M, 500), (cuda_edwards.K12, 494)):
            width, k = widths[kernel]
            short = kernel.split("_")[0]
            if kernel == cuda_edwards.K10:
                x1, y1 = aff(width)
                x2, y2 = aff(width)
                a = [x1, y1, flags(width), flags(width), x2, y2, flags(width), flags(width)]
                launch = lambda a=a: cuda_edwards.ed_pair_add(E, *a)
                plain = lambda a=a: cuda_edwards.ed_pair_add_plain(E, *a)
                computing = keep = None
            elif kernel == cuda_edwards.K12:
                a = [elem(width) for _ in range(4)]
                launch = lambda a=a, k=k: cuda_edwards.ed_double_k(E, *a, k)
                plain = lambda a=a, k=k: cuda_edwards.ed_double_k_plain(E, *a, k)
                computing = keep = None
            else:
                a = [elem(width) for _ in range(8)]
                m = flags(width) if kernel == cuda_edwards.K11M else None
                launch = lambda a=a, m=m: cuda_edwards.ed_add(E, *a, mask=m)
                plain = lambda a=a, m=m: cuda_edwards.ed_add_plain(E, *a, mask=m)
                computing, keep = (None, None) if m is None else (int(m.sum()), (m, a[:4]))
            row20(f"{short}_{tag}", f"{kernel.split('_', 1)[1]}_{tag}", "K11" if short == "k11m"
                  else short.upper(), "edwards.cu", edw(line), runs[kernel], kernel, G, launch,
                  plain, f"W={width}{f', k={k}' if k else ''}, {n} rows",
                  curve_work(kernel, n, mm, width, k, computing), keep,
                  (lambda g, w, a=a: max(curve_err(G, g, w), k10_err(E, a, w)))
                  if kernel == cuda_edwards.K10 else None)
            del a

    # n = 39, limbs: K1 (beta x), K2 and K3-K5 at the projective run's widths;
    # K4m, K7 and K8 in the N = 8 modes (K8 at the one lane of batch_inverse);
    # K6 in the subgroup check; the Edwards kernels (no BN462 path: a run of
    # their own), each at 65,536 lanes
    n39, nw39, _ = _build.shape_layout(sid39)
    mm39 = mont_imads(nw39, 12 * n39 % 32 > 0, 12 * n39 // 32)
    x, y = field_elems(G39, N, (2 * G39.p - 1,)), field_elems(G39, N, (4 * G39.p - 1,))
    row20("k1_bn462", "montmul_bn462", "K1", "montmul.cu", "msm_zprize_tpu/fields/pallas_mul.py:167",
          proj462, cuda_mul.KERNEL, G39, lambda: [cuda_mul.montmul(G39, x, y)],
          lambda: [G39.montmul_plain(x, y)], f"({n39}, {N}), shape {sid39}",
          (3 * n39 * 4 * N, mm39 * N), err_of=lambda g, w: mod_p_err(G39, g, w))
    e = G39.p - 2
    products = cuda_mul.exp_products(cuda_mul.exp_chain(e))
    row20("k8_bn462", "exp_const_bn462", "K8", "montmul.cu", "msm_zprize_tpu/fields/pallas_mul.py:237",
          "bn462 N=8 msm(mode='affine')", cuda_mul.K8, G39,
          lambda: [cuda_mul.exp_const(G39, x[:, :1], e)], lambda: [G39.exp_const_plain(x[:, :1], e)],
          f"({n39}, 1), e = p - 2 ({products} products, one thread a lane)",
          (2 * n39 * 4, products * mm39))
    del x, y
    cg = window_size("batched-affine", LOG_N)
    Kg = default_windows(S462.max_bits, cg)
    worst = 0
    for c_ in sorted({8, 13, cg} | set(WIDE_CS)):
        K_ = default_windows(S462.max_bits, c_)
        for width in (1, 1000, N):
            scal = c462.random_scalars(width, seed=SEED + width, device=dev)
            for inf in (None, flags(2 * width)):
                worst = max(worst, raw_err(cuda_scalar.glv_digits(S462, scal, c_, K_, inf),
                                           cuda_scalar.glv_digits_plain(S462, scal, c_, K_, inf)))
            K9_ = default_windows(S462.bits, c_)
            worst = max(worst, raw_err(cuda_scalar.simple_digits(scal, c_, K9_),
                                       signed_digits(scal, c_, K9_, 12)))
    if worst:
        raise AssertionError(f"K2 / K9 on BN462's scalars are not bit-identical to the twins: {worst}")
    print(f"[20 kernel] K2 (BN462's module, its own library) and K9 on BN462's 39-limb scalars: "
          f"bit-identical to the twins at c = {sorted({8, 13, cg} | set(WIDE_CS))}, W = 1, 1000, "
          f"{N}, K2 without and with the mask")
    scal, inf = c462.random_scalars(N, seed=SEED, device=dev), flags(2 * N)
    sw, mw, vw, aw = dims462[5], -(-12 * dims462[4] // 32), -(-12 * dims462[1] // 32), -(-12 * dims462[2] // 32)
    row20("k2_bn462", "glv_digits_bn462", "K2", "glv_digits.cu",
          "msm_zprize_tpu/fields/pallas_scalar.py:279", proj462, cuda_scalar.KERNEL, G39,
          lambda: cuda_scalar.glv_digits(S462, scal, cg, Kg, inf),
          lambda: cuda_scalar.glv_digits_plain(S462, scal, cg, Kg, inf),
          f"N={N}, c={cg}, K={Kg}, masked; words (s, m, v, acc) {(sw, mw, vw, aw)}",
          glv_digits_work(N, S462.n, Kg, (sw, mw, vw, aw)), err_of=raw_err)
    K9g = default_windows(S462.bits, cg)
    row20("k9_bn462", "simple_digits_bn462", "K9", "glv_digits.cu",
          "msm_zprize_tpu/fields/pallas_scalar.py:239", "bn462 N=8 msm_projective (random Z)",
          cuda_scalar.K9, G39, lambda: cuda_scalar.simple_digits(scal, cg, K9g),
          lambda: signed_digits(scal, cg, K9g, 12), f"N={N}, c={cg}, K={K9g}, n = {S462.n}",
          ((S462.n + 2 * K9g) * 4 * N, 0), err_of=raw_err)
    del scal, inf

    crng = random.Random(SEED)
    E39 = types.SimpleNamespace(F=G39, k_mont=crng.randrange(2, G39.p) * G39.R % G39.p,
                                two_mont=2 * G39.R % G39.p)
    ed39_run = "phase 20 Edwards kernels on n = 39"
    w65 = (N, 0)
    widths39 = {cuda_curve.K3: widest("bn462", cuda_curve.K3), cuda_curve.K4: widest("bn462", cuda_curve.K4),
                cuda_curve.K4M: w65, cuda_curve.K5: widest("bn462", cuda_curve.K5),
                cuda_curve.K6: w65, cuda_curve.K7: w65, cuda_edwards.K10: w65, cuda_edwards.K11: w65,
                cuda_edwards.K11M: w65, cuda_edwards.K12: (N, 3)}
    runs39 = {cuda_curve.K3: proj462, cuda_curve.K4: proj462, cuda_curve.K5: proj462,
              cuda_curve.K4M: "bn462 N=8 msm(mode='halving')", cuda_curve.K6: "bn462 N=8 subgroup check",
              cuda_curve.K7: "bn462 N=8 msm(mode='affine')", **{k: ed39_run for k in (
                  cuda_edwards.K10, cuda_edwards.K11, cuda_edwards.K11M, cuda_edwards.K12)}}
    elem39 = lambda width: field_elems(G39, width, (2 * G39.p - 1, 2 * G39.p - 2))
    aff39 = lambda width: (elem39(width), elem39(width))
    point39 = lambda width: (elem39(width), elem39(width), elem39(width))
    counters.reset()  # the Edwards kernels' run on n = 39: each launched once
    a = [field_elems(G39, 64) for _ in range(8)]
    f4 = [flags(64) for _ in range(4)]
    cuda_edwards.ed_pair_add(E39, a[0], a[1], f4[0], f4[1], a[2], a[3], f4[2], f4[3])
    cuda_edwards.ed_add(E39, *a)
    cuda_edwards.ed_add(E39, *a, mask=f4[0])
    cuda_edwards.ed_double_k(E39, *a[:4], 3)
    torch.cuda.synchronize()
    run_counts[ed39_run] = counters.snapshot()
    del a
    curve_rows("bn462", G39, c462.ops, E39, point39, aff39, elem39, widths39, runs39, "curve.cu")
    # n = 39 on 15 PackedCodec rows: K14's widths from the packed run, K4m,
    # K6, K7 (on no codec-mode path) at 4,096 lanes
    Wp, pc = c462.ops_packed, c462.ops_packed.codec
    enc = lambda t: pc.from_digits(G39, t)
    wsmall = (SMALL, 0)
    curve_rows("bn462", G39, Wp, None, lambda w: tuple(map(enc, point39(w))),
               lambda w: tuple(map(enc, aff39(w))), None,
               {cuda_curve.K3: widest("bn462", cuda_curve.K14[cuda_curve.K3]),
                cuda_curve.K4: widest("bn462", cuda_curve.K14[cuda_curve.K4]),
                cuda_curve.K5: widest("bn462", cuda_curve.K14[cuda_curve.K5]),
                cuda_curve.K4M: wsmall, cuda_curve.K6: wsmall, cuda_curve.K7: wsmall},
               dict.fromkeys((cuda_curve.K3, cuda_curve.K4, cuda_curve.K5, cuda_curve.K4M,
                              cuda_curve.K6, cuda_curve.K7, "k13"), packed462),
               "curve_codec.cu", pc)

    # ed25519's padded path (9 words): K9, K10, K11, K12 at its run's widths
    S255, G25 = c255.scalar, c255.ops.F
    ce = window_size("edwards", LOG_N)
    Ke = default_windows(S255.bits, ce)
    scal = c255.random_scalars(N, seed=SEED, device=dev)
    row20("k9_ed25519", "simple_digits_ed25519", "K9", "glv_digits.cu",
          "msm_zprize_tpu/fields/pallas_scalar.py:239", ed255_run, cuda_scalar.K9, G25,
          lambda: cuda_scalar.simple_digits(scal, ce, Ke), lambda: signed_digits(scal, ce, Ke, 12),
          f"N={N}, c={ce}, K={Ke}, n = {S255.n}", ((S255.n + 2 * Ke) * 4 * N, 0), err_of=raw_err)
    del scal
    n25, nw25, _ = _build.shape_layout(_build.field_shape(G25))
    mm25 = mont_imads(nw25, 12 * n25 % 32 > 0, 12 * n25 // 32)
    e25 = c255.ops
    for kernel, line, (width, k) in (
        (cuda_edwards.K10, 449, widest("ed25519", cuda_edwards.K10)),
        (cuda_edwards.K11, 500, widest("ed25519", cuda_edwards.K11)),
        (cuda_edwards.K12, 494, min(w for w in widths20[("ed25519", cuda_edwards.K12)] if w[0] > 1)),
    ):
        short = kernel.split("_")[0]
        if kernel == cuda_edwards.K10:
            a = [field_elems(G25, width), field_elems(G25, width), flags(width), flags(width),
                 field_elems(G25, width), field_elems(G25, width), flags(width), flags(width)]
            launch, plain = (lambda a=a: cuda_edwards.ed_pair_add(e25, *a),
                             lambda a=a: cuda_edwards.ed_pair_add_plain(e25, *a))
        elif kernel == cuda_edwards.K11:
            a = [field_elems(G25, width) for _ in range(8)]
            launch, plain = (lambda a=a: cuda_edwards.ed_add(e25, *a),
                             lambda a=a: cuda_edwards.ed_add_plain(e25, *a))
        else:
            a = [field_elems(G25, width) for _ in range(4)]
            launch, plain = (lambda a=a, k=k: cuda_edwards.ed_double_k(e25, *a, k),
                             lambda a=a, k=k: cuda_edwards.ed_double_k_plain(e25, *a, k))
        row20(f"{short}_ed25519", f"{kernel.split('_', 1)[1]}_ed25519", short.upper(), "edwards.cu",
              f"msm_zprize_tpu/curves/pallas_curve.py:{line}", ed255_run, kernel, G25, launch, plain,
              f"W={width}{f', k={k}' if k else ''}, {n25} rows (9 words)",
              curve_work(kernel, n25, mm25, width, k),
              err_of=(lambda g, w, a=a: max(curve_err(G25, g, w), k10_err(e25, a, w)))
              if kernel == cuda_edwards.K10 else None)
        del a

    # n = 63 (24 words): points of y^2 = x^3 + 7, 1,024 made on the host,
    # tiled over the lanes, in projective form with a random Z a lane; every
    # curve kernel on limbs and on its 25 PackedCodec rows, each launched
    # once in a run of its own
    p63 = G63.p
    host63 = toy63_points(1024, seed=SEED)
    ax63 = torch.as_tensor(G63.pack([pt[0] for pt in host63]), device=dev)
    ay63 = torch.as_tensor(G63.pack([pt[1] for pt in host63]), device=dev)
    tile = lambda t, w: t.repeat(1, -(-w // t.shape[1]))[:, :w].contiguous()
    aff63 = lambda w: (tile(ax63, w), tile(ay63, w))

    def point63(width):
        z = field_elems(G63, width)
        x, y = aff63(width)
        return cuda_mul.montmul(G63, x, z), cuda_mul.montmul(G63, y, z), z

    W63 = types.SimpleNamespace(F=G63, b3_mont=3 * TOY63_B * G63.R % p63, b3_small=3 * TOY63_B,
                                storage=cuda_curve.Storage(G63.n))
    E63 = types.SimpleNamespace(F=G63, k_mont=crng.randrange(2, p63) * G63.R % p63,
                                two_mont=2 * G63.R % p63)
    pc63 = PackedCodec(p63)
    Wp63 = types.SimpleNamespace(F=G63, b3_mont=W63.b3_mont, b3_small=W63.b3_small,
                                 storage=cuda_curve.Storage.of_codec(pc63), codec=pc63)
    enc63 = lambda t: pc63.from_digits(G63, t)
    run63 = "phase 20 curve and codec kernels on n = 63"
    counters.reset()  # each n = 63 kernel launched once
    for Wc, enc_ in ((W63, lambda t: t), (Wp63, enc63)):
        P1 = [enc_(t) for t in point63(64)]
        x2, y2 = map(enc_, aff63(64))
        f4 = [flags(64) for _ in range(4)]
        cuda_curve.aff_pair_add(Wc, x2, y2, f4[0], f4[1], x2, y2, f4[2], f4[3])
        cuda_curve.proj_add(Wc, *P1, *P1)
        cuda_curve.proj_add(Wc, *P1, *P1, mask=f4[0])
        cuda_curve.proj_double_k(Wc, *P1, 2)
        cuda_curve.proj_double(Wc, *P1)
        cuda_curve.proj_add_mixed(Wc, *P1, x2, y2, f4[1])
    cuda_codec.montmul_rows(G63, pc63, x2, y2)
    a = [field_elems(G63, 64) for _ in range(8)]
    cuda_edwards.ed_pair_add(E63, a[0], a[1], f4[0], f4[1], a[2], a[3], f4[2], f4[3])
    cuda_edwards.ed_add(E63, *a)
    cuda_edwards.ed_add(E63, *a, mask=f4[0])
    cuda_edwards.ed_double_k(E63, *a[:4], 3)
    torch.cuda.synchronize()
    run_counts[run63] = counters.snapshot()
    del a
    widths63 = {k: (N, 3 if k in (cuda_curve.K5, cuda_edwards.K12) else 0) for k in (
        cuda_curve.K3, cuda_curve.K4, cuda_curve.K4M, cuda_curve.K5, cuda_curve.K6, cuda_curve.K7,
        cuda_edwards.K10, cuda_edwards.K11, cuda_edwards.K11M, cuda_edwards.K12)}
    runs63 = collections.defaultdict(lambda: run63)
    curve_rows("n63", G63, W63, E63, point63, aff63, lambda w: field_elems(G63, w), widths63,
               runs63, "curve.cu")
    curve_rows("n63", G63, Wp63, None, lambda w: tuple(map(enc63, point63(w))),
               lambda w: tuple(map(enc63, aff63(w))), None, widths63, runs63, "curve_codec.cu", pc63)

    # goldilocks (3 words): K13 and K14 on Fma51Codec and PackedCodec rows
    gl_run, w64 = "phase 20 codec kernels on goldilocks", 64
    Wgl = {}
    for codec in (Fma51Codec(Ggl.p), PackedCodec(Ggl.p)):
        Wgl[codec] = types.SimpleNamespace(F=Ggl, b3_mont=21 * Ggl.R % Ggl.p, b3_small=21,
                                           storage=cuda_curve.Storage.of_codec(codec), codec=codec)
    counters.reset()
    for codec, Wc in Wgl.items():
        enc_gl = lambda t, codec=codec: codec.from_digits(Ggl, t)
        P1 = [enc_gl(field_elems(Ggl, w64)) for _ in range(3)]
        f4 = [flags(w64) for _ in range(4)]
        cuda_curve.aff_pair_add(Wc, P1[0], P1[1], f4[0], f4[1], P1[1], P1[2], f4[2], f4[3])
        cuda_curve.proj_add(Wc, *P1, *P1)
        cuda_curve.proj_add(Wc, *P1, *P1, mask=f4[0])
        cuda_curve.proj_double_k(Wc, *P1, 2)
        cuda_curve.proj_double(Wc, *P1)
        cuda_curve.proj_add_mixed(Wc, *P1, P1[0], P1[1], f4[1])
        cuda_codec.montmul_rows(Ggl, codec, P1[0], P1[1])
    torch.cuda.synchronize()
    run_counts[gl_run] = counters.snapshot()
    for codec, Wc in Wgl.items():
        enc_gl = lambda t, codec=codec: codec.from_digits(Ggl, t)
        curve_rows("goldilocks", Ggl, Wc, None,
                   lambda w, e=enc_gl: tuple(e(field_elems(Ggl, w)) for _ in range(3)),
                   lambda w, e=enc_gl: (e(field_elems(Ggl, w)), e(field_elems(Ggl, w))), None,
                   widths63,
                   collections.defaultdict(lambda: gl_run), "curve_pallas_codec.cu"
                   if isinstance(codec, Fma51Codec) else "curve_codec.cu", codec)
    print(f"    phase 20 took {time.perf_counter() - t20:.1f} s")

    # ---- the kernel table --------------------------------------------------------------
    # each row's launches: its counter in the run it names; 0 only where the
    # row is on no path of that run (the K14 variants of K4m, K6 and K7 in a
    # codec mode, K13 on the Edwards field's Fma51Codec rows, the masked K11)
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
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
