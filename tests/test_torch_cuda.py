"""The port's CUDA kernels on the card, against their plain twins.

This file imports nothing of JAX or the JAX package (the machine with the
card has no JAX), so run it there without the suite's conftest, which
configures JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False (decided inside the fixture). Widths
are odd (ragged last block) and some operands are strided slices, which
the kernels read in place. Each Weierstrass curve (BLS12-377, BLS12-381
with n = 33, Pallas with n = 22 and 4p > 2^256) the same way. Tolerance: K2
and K9 bit-exact; K1 limb-exact (the Montgomery product is one integer)
where 4p < 2^(32 NW), mod p on Pallas (also on inputs in [2^256, 4p), which
its kernel reduces first); K3-K8 and K10-K12 exact mod p, with operands at
2p - 1 whose sums cross 2^256 on Pallas, and the pass-through lanes of K4m
and K7 bit for bit; the halving layout on int32 CUDA tensors bit-exact
against the CPU; K13 and the K14 variants of K3-K7 on every codec storage
(PackedCodec on each curve, Fma51Codec on Pallas; K13 also on both codecs
of the n = 22 Edwards field) exact mod p with every output below 2p, their
pass-through lanes bit for bit. K4, K4m and K5 on every storage also run
each built instance (G threads a point, as the library lists them) at widths
that cut a group, a warp and a block (1, 5, 33, 4097), on strided operands
with 2p - 1 and 2p - 2 among them, K5 at k = 1, 5 and 12, and every entry
of the kernels' width table through the engines' wrappers; an instance
that is not built (the one-thread K4m everywhere, the one-thread K4 on
12-word shapes) is refused. An Fp22 and a
Pallas launch on the same limbs take different shape IDs, and the C
entries refuse a Pallas field under Fp22's.
"""

import numpy as np
import pytest
import torch

from msm_zprize_tpu_torch import _build
from msm_zprize_tpu_torch.counters import COUNTS
from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
from msm_zprize_tpu_torch.curves.params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from msm_zprize_tpu_torch.curves.weierstrass import ProjectivePoints
from msm_zprize_tpu_torch.fields import cuda_codec, cuda_mul
from msm_zprize_tpu_torch.fields.codec import Fma51Codec, PackedCodec
from msm_zprize_tpu_torch.fields.cuda_scalar import glv_digits, glv_digits_plain, simple_digits
from msm_zprize_tpu_torch.fields.scalar import signed_digits
from msm_zprize_tpu_torch.msm.common import halving_layout
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
from msm_zprize_tpu_torch.submission import compute_msm
from msm_zprize_tpu_torch.testing.points import (
    ed_expected_msm, ed_points_with_logs, expected_msm, points_with_logs,
)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

WIDTH = 4099


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _elems(dev, rng, width=WIDTH, rows=32):
    """Random field limbs with value < 2^376 < p (rows = 32) or < 2^252 < p
    (rows = 22)."""
    limbs = rng.integers(0, 1 << 12, size=(rows, width), dtype=np.int32)
    limbs[-1] &= 0xF if rows == 32 else 0
    return torch.as_tensor(limbs, device=dev)


def _rows_equal(F, codec, got, want):
    """Equal mod p, and every output below 2p."""
    g = codec.to_digits(F, got)
    return (torch.equal(F.fully_reduce(g), F.fully_reduce(codec.to_digits(F, want)))
            and torch.equal(F._sub_const_select(g, F.two_p_limbs), g))


def _vals(G, dev, rng, width, edges=(), bound=None):
    """(n, width) Montgomery-form limbs of values uniform below ``bound``
    (default p), the ``edges`` first."""
    bound = G.p if bound is None else bound
    vals = list(edges) + [int.from_bytes(rng.bytes(56), "little") % bound
                          for _ in range(width - len(edges))]
    return torch.as_tensor(G.pack(vals, montgomery=False), device=dev)


GROUP_WIDTHS = (1, 5, 33, 4097)  # cut a group, a warp, a block of every G


def _group_checks(F, Wc, codec, a, halves, m, label):
    """Every built instance of K4, K4m and K5 (G threads a point, as
    ``cuda_curve._groups`` reads them from the library) against the twin at
    widths that cut a group or a block, on the strided halves too (K4,
    K4m), K5 at k = 1, 5 and 12, the
    pass-through lanes of K4m bit for bit; the width table's pick at each
    width among them, and an instance that is not built refused."""
    same = ((lambda g, w: torch.equal(F.fully_reduce(g), F.fully_reduce(w))) if codec is None
            else (lambda g, w: _rows_equal(F, codec, g, w)))
    built = {name: cuda_curve._groups(F, name) for name in (cuda_curve.K4, cuda_curve.K4M,
                                                            cuda_curve.K5)}
    reached = set()
    for width in GROUP_WIDTHS:
        ops = [x[:, :width] for x in a]
        strided = [x[:, :width] for x in halves]
        mask = m[:width]
        for name, groups in built.items():
            pick = cuda_curve._group_for(F, name, width)
            assert pick in groups, (label, name, width, pick)
            reached.add((name, pick))
            for G in groups:
                if name == cuda_curve.K5:
                    for k in (1, 5, 12):
                        got = cuda_curve._proj_double_k(Wc, G, *ops[:3], k)
                        want = cuda_curve.proj_double_k_plain(Wc, *ops[:3], k)
                        assert all(map(same, got, want)), (label, name, G, width, k)
                    continue
                kw = {} if name == cuda_curve.K4 else {"mask": mask}
                for args in (ops, strided):
                    got = cuda_curve._proj_add(Wc, G, *args, **kw)
                    want = cuda_curve.proj_add_plain(Wc, *args, **kw)
                    assert all(map(same, got, want)), (label, name, G, width)
                    if kw:  # masked-off lanes are P1's rows, bit for bit
                        for g, x1 in zip(got, args[:3]):
                            assert torch.equal(g[:, mask == 0], x1[:, mask == 0]), (label, G, width)
    # every entry of the width table, through the engines' wrappers, at the
    # first width (powers of two and their neighbours up to 2^20) that picks it
    first = {}
    for e in range(21):
        for width in (max(1, (1 << e) - 1), 1 << e, (1 << e) + 1):
            for name in built:
                first.setdefault((name, cuda_curve._group_for(F, name, width)), width)
    for (name, G), width in sorted(first.items()):
        if (name, G) in reached:
            continue
        assert G in built[name], (label, name, width, G)
        ops = [_tile(x, width) for x in a]
        if name == cuda_curve.K5:
            got = cuda_curve.proj_double_k(Wc, *ops[:3], 5)
            want = cuda_curve.proj_double_k_plain(Wc, *ops[:3], 5)
        else:
            kw = {} if name == cuda_curve.K4 else {"mask": _tile(m, width)}
            got, want = cuda_curve.proj_add(Wc, *ops, **kw), cuda_curve.proj_add_plain(Wc, *ops, **kw)
        assert all(map(same, got, want)), (label, name, G, width)
    # the one-thread K4 only on 8-word shapes, where the table picks it
    nw = _build.FIELD_SHAPES[_build.field_shape(F)][1]
    assert (1 in built[cuda_curve.K4]) == (nw == 8) and 1 not in built[cuda_curve.K4M], label
    for G, kw in ((7, {}), (1, {"mask": m})) + (() if nw == 8 else ((1, {}),)):
        with pytest.raises(RuntimeError):
            cuda_curve._proj_add(Wc, G, *a, **kw)
    with pytest.raises(RuntimeError):
        cuda_curve._proj_double_k(Wc, 1, *a[:3], 2)


def _tile(x, width):
    """x's lanes repeated to ``width`` lanes."""
    return x.repeat(*([1] * (x.dim() - 1)), -(-width // x.shape[-1]))[..., :width].contiguous()


def _weierstrass_checks(dev, rng, params):
    """One Weierstrass curve: K1 (also on a strided operand; limb-exact on
    the shapes with 4p < 2^(32 NW), mod p on Pallas, whose kernel reduces
    inputs of 2p and above), K8, K2 at two window sizes, K3-K7 on limbs and
    on each codec storage (K4 and K4m also on strided halves of one slot
    block; 2p - 1 and 2p - 2 among the operands, sums past 2^256 on Pallas),
    K13 on each codec; then every mode's 2^10 MSM against its
    known-discrete-log result with its path's launches, and
    ``random_points_fast``."""
    cv = Weierstrass.create(params)
    W, F, S = cv.ops, cv.ops.F, cv.scalar
    p = F.p
    carry = _build.FIELD_SHAPES[_build.field_shape(F)][2]
    edges = (2 * p - 1, 2 * p - 2, p, 1, 0)
    x, y = _vals(F, dev, rng, WIDTH, edges), _vals(F, dev, rng, WIDTH, edges[::-1])
    wide = torch.cat([x, y], dim=1)
    big = _vals(F, dev, rng, WIDTH, (4 * p - 1, (1 << 256) + 5), bound=4 * p)  # K1 takes < 4p
    for a, b in ((x, y), (wide[:, :WIDTH], y), (big, x), (big, big)):
        got, want = cuda_mul.montmul(F, a, b), F.montmul_plain(a, b)
        if carry:
            got, want = F.fully_reduce(got), F.fully_reduce(want)
        assert torch.equal(got, want), params.label
    with pytest.raises(ValueError):
        cuda_mul.montmul(F, x.to(torch.int64), y)
    for e in (0, 5, p - 2):
        assert torch.equal(F.fully_reduce(cuda_mul.exp_const(F, x[:, :64], e)),
                           F.fully_reduce(F.exp_const_plain(x[:, :64], e))), e
    for c in (8, 12):
        s = cv.random_scalars(WIDTH, seed=c, device=dev)
        K = -(-(S.max_bits + 1) // c)
        got, want = glv_digits(S, s, c, K), glv_digits_plain(S, s, c, K)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), c

    f = [torch.as_tensor(rng.integers(0, 2, size=WIDTH, dtype=np.int32), device=dev) for _ in range(4)]
    m, inf = f[0], f[1]
    storages = [(W, None)] + [(Wc, Wc.codec) for Wc in (cv.ops_packed,) + (
        (cv.ops51,) if params is PALLAS else ())]
    for Wc, codec in storages:
        enc = (lambda a: a) if codec is None else Wc.from_native
        a = [enc(_vals(F, dev, rng, WIDTH, edges[i % 2:])) for i in range(6)]
        slot = enc(_vals(F, dev, rng, 2 * WIDTH, edges))
        halves = (slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:])
        pairs = {
            "K3": (cuda_curve.aff_pair_add(Wc, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3]),
                   cuda_curve.aff_pair_add_plain(Wc, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3])),
            "K4": (cuda_curve.proj_add(Wc, *a), cuda_curve.proj_add_plain(Wc, *a)),
            "K4 strided": (cuda_curve.proj_add(Wc, *halves), cuda_curve.proj_add_plain(Wc, *halves)),
            "K4m strided": (cuda_curve.proj_add(Wc, *halves, mask=m),
                            cuda_curve.proj_add_plain(Wc, *halves, mask=m)),
            "K5": (cuda_curve.proj_double_k(Wc, *a[:3], 5), cuda_curve.proj_double_k_plain(Wc, *a[:3], 5)),
            "K6": (cuda_curve.proj_double(Wc, *a[:3]), cuda_curve.proj_double_plain(Wc, *a[:3])),
            "K7": (cuda_curve.proj_add_mixed(Wc, *a[:5], inf),
                   cuda_curve.proj_add_mixed_plain(Wc, *a[:5], inf)),
        }
        for name, (got, want) in pairs.items():
            for g, w in zip(got, want):
                ok = (torch.equal(F.fully_reduce(g), F.fully_reduce(w)) if codec is None
                      else _rows_equal(F, codec, g, w))
                assert ok, (params.label, type(codec).__name__, name)
        for name, keep, p1 in (("K4m strided", m == 0, halves[:3]), ("K7", inf == 1, a[:3])):
            for g, x1 in zip(pairs[name][0], p1):
                assert torch.equal(g[:, keep], x1[:, keep]), (params.label, name)
        _group_checks(F, Wc, codec, a, halves, m, params.label)
        if codec is not None:  # K13: beta * x of the codec mode, counted under its codec's key
            key = cuda_codec.K13_FMA51 if isinstance(codec, Fma51Codec) else cuda_codec.K13
            before = COUNTS[key]
            assert _rows_equal(F, codec, cuda_codec.montmul_rows(F, codec, a[0], a[1]),
                               cuda_codec.montmul_rows_plain(F, codec, a[0], a[1])), codec
            assert COUNTS[key] == before + 1, codec

    N = 1 << 10
    pts, logs = points_with_logs(params, N, seed=14)
    scalars = cv.random_scalars(N, seed=14, device=dev)
    points = cv.points_from_ints(pts, dev)
    want = expected_msm(params, cv.scalar.unpack(scalars), logs)
    z = _vals(F, dev, rng, N, (1,))  # random Z: msm_projective on the same points
    proj = ProjectivePoints(F.montmul(points.x, z), F.montmul(points.y, z), z)
    k14 = tuple(cuda_curve.K14[k] for k in (cuda_curve.K3, cuda_curve.K4, cuda_curve.K5))
    runs = {
        "projective": (lambda: cv.msm(scalars, points),
                       ("k1_montmul", "k2_glv_digits", "k3_aff_pair_add", "k4_proj_add", "k5_proj_double_k")),
        "affine": (lambda: cv.msm(scalars, points, mode="affine"),
                   ("k1_montmul", "k2_glv_digits", "k8_exp_const", "k7_proj_add_mixed", "k4_proj_add")),
        "unsafe": (lambda: cv.msm_unsafe(scalars, points, mode="affine"), ("k7_proj_add_mixed",)),
        "halving": (lambda: cv.msm(scalars, points, mode="halving"),
                    ("k2_glv_digits", "k4m_proj_add_masked", "k4_proj_add", "k5_proj_double_k")),
        "msm_projective": (lambda: cv.msm_projective(scalars, proj),
                           ("k9_simple_digits", "k4_proj_add", "k5_proj_double_k")),
        "packed": (lambda: cv.msm(scalars, points, mode="packed"), ("k13_montmul_rows",) + k14),
        "unsafe packed": (lambda: cv.msm_unsafe(scalars, points, mode="packed"), k14),
    }
    if params is PALLAS:
        runs["fma51"] = (lambda: cv.msm(scalars, points, mode="fma51"), ("k13_montmul_rows_fma51",)
                         + tuple(cuda_curve.K14_FMA51[k] for k in (cuda_curve.K3, cuda_curve.K4,
                                                                     cuda_curve.K5)))
    for name, (run, keys) in runs.items():
        before = dict(COUNTS)
        assert cv.result_to_int(run()) == want, (params.label, name)
        for key in keys:
            assert COUNTS[key] > before.get(key, 0), (params.label, name, key)
        if name in ("packed", "fma51"):  # the endomorphism ran on K13, not K1
            assert COUNTS["k1_montmul"] == before.get("k1_montmul", 0), (params.label, name)
    rp = cv.random_points_fast(N, seed=3, device=dev)
    assert bool(W.affine_is_on_curve(rp).all()), params.label
    return pts, scalars, logs


def test_kernels_match_plain_twins(dev):
    """Each kernel against its twin and a 2^10 MSM of each curve and each
    mode on the card that launches every kernel of its path and equals its
    known-discrete-log result, and random_points_fast on every curve (one
    test item: the CPU suite's wall time follows its item count)."""
    rng = np.random.default_rng(1)
    for params in (BLS12_381, PALLAS):
        _weierstrass_checks(dev, rng, params)
    pts, scalars, logs = _weierstrass_checks(dev, rng, BLS12_377)
    curve = Weierstrass.create(BLS12_377)
    scs = curve.scalar.unpack(scalars[:, :64])
    assert compute_msm(pts[:64], scs, mode="packed", device=dev) == expected_msm(BLS12_377, scs, logs[:64])

    # the halving layout's scatter-min/max and cumulative min/max on int32
    counts = torch.as_tensor(rng.integers(0, 9, size=(3, 64), dtype=np.int32))
    for width, cur in ((400, 512), (128, 400)):
        got = halving_layout(counts.to(dev), width, cur)
        want = halving_layout(counts, width, cur)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), width

    # ed-on-bls12-377: K1 on the 22-limb field, K8, K9, K10-K12 (K11 with
    # and without a mask, on strided halves of one slot block), K13 on both
    # codecs of its field
    ed = TwistedEdwards.create(ED_ON_BLS12_377)
    E, FE = ed.ops, ed.ops.F
    N = 1 << 10
    f = [torch.as_tensor(rng.integers(0, 2, size=WIDTH, dtype=np.int32), device=dev) for _ in range(4)]
    for codec in (Fma51Codec(FE.p), PackedCodec(FE.p)):
        x, y = (codec.from_digits(FE, _elems(dev, rng, rows=22)) for _ in range(2))
        assert _rows_equal(FE, codec, cuda_codec.montmul_rows(FE, codec, x, y),
                           cuda_codec.montmul_rows_plain(FE, codec, x, y)), codec
    x, y = _elems(dev, rng, rows=22), _elems(dev, rng, rows=22)
    assert torch.equal(cuda_mul.montmul(FE, x, y), FE.montmul_plain(x, y))
    for e in (0, 1, 5, FE.p - 2):
        assert torch.equal(FE.fully_reduce(cuda_mul.exp_const(FE, x[:, :64], e)),
                           FE.fully_reduce(FE.exp_const_plain(x[:, :64], e))), e
    for c in (6, 11):
        s = ed.random_scalars(WIDTH, seed=c, device=dev)
        K = -(-(ed.scalar.bits + 1) // c)
        got, want = simple_digits(s, c, K), signed_digits(s, c, K, 12)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), c
    a = [_elems(dev, rng, rows=22) for _ in range(8)]
    slot = _elems(dev, rng, width=2 * WIDTH, rows=22)
    m = f[0]
    pairs = {
        "K10": (cuda_edwards.ed_pair_add(E, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3]),
                cuda_edwards.ed_pair_add_plain(E, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3])),
        "K11": (cuda_edwards.ed_add(E, *a), cuda_edwards.ed_add_plain(E, *a)),
        "K11 masked strided": (
            cuda_edwards.ed_add(E, slot[:, :WIDTH], *a[1:4], slot[:, WIDTH:], *a[5:], mask=m),
            cuda_edwards.ed_add_plain(E, slot[:, :WIDTH], *a[1:4], slot[:, WIDTH:], *a[5:], mask=m)),
        "K12": (cuda_edwards.ed_double_k(E, *a[:4], 5), cuda_edwards.ed_double_k_plain(E, *a[:4], 5)),
    }
    for name, (got, want) in pairs.items():
        for g, w in zip(got, want):
            assert torch.equal(FE.fully_reduce(g), FE.fully_reduce(w)), name

    pts, logs = ed_points_with_logs(ED_ON_BLS12_377, N, seed=13)
    scalars = ed.random_scalars(N, seed=13, device=dev)
    before = dict(COUNTS)
    points = ed.points_from_ints(pts, dev)
    res = ed.msm(scalars, points)
    want = ed_expected_msm(ED_ON_BLS12_377, ed.scalar.unpack(scalars), logs)
    assert ed.result_to_int(res) == want
    for key in ("k1_montmul", "k8_exp_const", "k9_simple_digits", "k10_ed_pair_add", "k11_ed_add",
                "k12_ed_double_k"):
        assert COUNTS[key] > before.get(key, 0), key
    assert ed.result_to_int(ed.msm(scalars, points, mode="basic")) == want
    assert bool(E.is_on_curve(ed.random_points_fast(N, seed=3, device=dev)).all())

    # ed-on-bls12-377 and Pallas both have n = 22: their launches take
    # different shape IDs and give different products of the same limbs,
    # each its own twin's; the entry refuses Pallas's constants under
    # Fp22's ID
    FP = Weierstrass.create(PALLAS).ops.F
    assert FE.n == FP.n and _build.field_shape(FE) != _build.field_shape(FP)
    x, y = _elems(dev, rng, rows=22), _elems(dev, rng, rows=22)
    got_e, got_p = cuda_mul.montmul(FE, x, y), cuda_mul.montmul(FP, x, y)
    assert torch.equal(got_e, FE.montmul_plain(x, y))
    assert torch.equal(FP.fully_reduce(got_p), FP.fully_reduce(FP.montmul_plain(x, y)))
    assert not torch.equal(got_e, got_p)
    lib, _ = _build.library()
    out = torch.empty_like(x)
    code = lib.msm_montmul(_build.ptrs(x, y, out), _build.ints([WIDTH] * 3), WIDTH,
                           _build.field_shape(FE), _build.field_words(FP), _build.stream_of(x))
    assert code != 0
