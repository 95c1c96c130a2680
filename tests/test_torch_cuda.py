"""The port's CUDA kernels on the card, against their plain twins.

This file imports nothing of JAX or the JAX package (the machine with the
card has no JAX), so run it there without the suite's conftest, which
configures JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False (decided inside the fixture). Widths
are odd (ragged last block) and some operands are strided slices, which
the kernels read in place. Tolerance: K2 and K9 bit-exact; K1 limb-exact
(the Montgomery product is one integer) on both field shapes; K3-K8 and
K10-K12 exact mod p, and the pass-through lanes of K4m and K7 bit for bit;
the halving layout on int32 CUDA tensors bit-exact against the CPU; K13
on PackedCodec (n = 32 and 22) and Fma51Codec (n = 22) rows and the K14
variants of K3-K7 on PackedCodec rows exact mod p with every output below
2p, their pass-through lanes bit for bit.
"""

import numpy as np
import pytest
import torch

from msm_zprize_tpu_torch.counters import COUNTS
from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
from msm_zprize_tpu_torch.curves.params import BLS12_377, ED_ON_BLS12_377
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


@pytest.fixture(scope="module")
def curve():
    return Weierstrass.create(BLS12_377)


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


def test_kernels_match_plain_twins(dev, curve):
    """Each kernel against its twin, then a 2^10 MSM of each curve and each
    mode on the card that launches every kernel of its path and equals its
    known-discrete-log result, and random_points_fast on both curves (one
    test item: the CPU suite's wall time follows its item count)."""
    W = curve.ops
    F, S = W.F, curve.scalar
    rng = np.random.default_rng(1)

    # K1, also on a strided operand; a wrong dtype is refused
    x, y = _elems(dev, rng), _elems(dev, rng)
    assert torch.equal(cuda_mul.montmul(F, x, y), F.montmul_plain(x, y))
    wide = torch.cat([x, y], dim=1)
    assert torch.equal(cuda_mul.montmul(F, wide[:, :WIDTH], y), F.montmul_plain(x, y))
    with pytest.raises(ValueError):
        cuda_mul.montmul(F, x.to(torch.int64), y)

    # K2 at two window sizes
    for c in (8, 12):
        s = curve.random_scalars(WIDTH, seed=c, device=dev)
        K = -(-(S.max_bits + 1) // c)
        got, want = glv_digits(S, s, c, K), glv_digits_plain(S, s, c, K)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), c

    # K3-K5; K4 also on the two halves of one slot row block
    a = [_elems(dev, rng) for _ in range(6)]
    f = [torch.as_tensor(rng.integers(0, 2, size=WIDTH, dtype=np.int32), device=dev) for _ in range(4)]
    slot = _elems(dev, rng, width=2 * WIDTH)
    pairs = {
        "K4": (cuda_curve.proj_add(W, *a), cuda_curve.proj_add_plain(W, *a)),
        "K4 strided": (cuda_curve.proj_add(W, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:]),
                       cuda_curve.proj_add_plain(W, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:])),
        "K5": (cuda_curve.proj_double_k(W, *a[:3], 5), cuda_curve.proj_double_k_plain(W, *a[:3], 5)),
        "K3": (cuda_curve.aff_pair_add(W, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3]),
               cuda_curve.aff_pair_add_plain(W, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3])),
    }
    # K4m, K6, K7; K4m on strided halves, its masked-off lanes and K7's
    # infinity lanes bit for bit P1
    m, inf = f[0], f[1]
    pairs.update({
        "K4m strided": (cuda_curve.proj_add(W, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:], mask=m),
                        cuda_curve.proj_add_plain(W, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:],
                                                  mask=m)),
        "K6": (cuda_curve.proj_double(W, *a[:3]), cuda_curve.proj_double_plain(W, *a[:3])),
        "K7": (cuda_curve.proj_add_mixed(W, *a[:5], inf), cuda_curve.proj_add_mixed_plain(W, *a[:5], inf)),
    })
    for name, (got, want) in pairs.items():
        for g, w in zip(got, want):
            assert torch.equal(F.fully_reduce(g), F.fully_reduce(w)), name
    for name, keep, p1 in (("K4m strided", m == 0, (slot[:, :WIDTH], *a[1:3])), ("K7", inf == 1, a[:3])):
        for g, x in zip(pairs[name][0], p1):
            assert torch.equal(g[:, keep], x[:, keep]), name

    # the halving layout's scatter-min/max and cumulative min/max on int32
    counts = torch.as_tensor(rng.integers(0, 9, size=(3, 64), dtype=np.int32))
    for width, cur in ((400, 512), (128, 400)):
        got = halving_layout(counts.to(dev), width, cur)
        want = halving_layout(counts, width, cur)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), width

    N = 1 << 10
    pts, logs = points_with_logs(BLS12_377, N, seed=12)
    scalars = curve.random_scalars(N, seed=12, device=dev)
    points = curve.points_from_ints(pts, dev)
    want = expected_msm(BLS12_377, curve.scalar.unpack(scalars), logs)
    z = _elems(dev, rng, width=N)  # random Z: msm_projective on the same points
    proj = ProjectivePoints(F.montmul(points.x, z), F.montmul(points.y, z), z)
    runs = {
        "projective": (lambda: curve.msm(scalars, points),
                       ("k1_montmul", "k2_glv_digits", "k3_aff_pair_add", "k4_proj_add", "k5_proj_double_k")),
        "affine": (lambda: curve.msm(scalars, points, mode="affine"),
                   ("k1_montmul", "k2_glv_digits", "k8_exp_const", "k7_proj_add_mixed", "k4_proj_add")),
        "unsafe": (lambda: curve.msm_unsafe(scalars, points, mode="affine"), ("k7_proj_add_mixed",)),
        "halving": (lambda: curve.msm(scalars, points, mode="halving"),
                    ("k2_glv_digits", "k4m_proj_add_masked", "k4_proj_add", "k5_proj_double_k")),
        "msm_projective": (lambda: curve.msm_projective(scalars, proj),
                           ("k9_simple_digits", "k4_proj_add", "k5_proj_double_k")),
    }
    k14 = tuple(cuda_curve.K14[k] for k in (cuda_curve.K3, cuda_curve.K4, cuda_curve.K5))
    runs.update({
        "packed": (lambda: curve.msm(scalars, points, mode="packed"), ("k13_montmul_rows",) + k14),
        "unsafe packed": (lambda: curve.msm_unsafe(scalars, points, mode="packed"), k14),
    })
    for name, (run, keys) in runs.items():
        before = dict(COUNTS)
        assert curve.result_to_int(run()) == want, name
        for key in keys:
            assert COUNTS[key] > before.get(key, 0), (name, key)
        if "packed" in name:  # the endomorphism ran on K13, not K1
            assert COUNTS["k1_montmul"] == before.get("k1_montmul", 0), name
    assert compute_msm(pts[:64], curve.scalar.unpack(scalars[:, :64]), mode="packed", device=dev) == \
        expected_msm(BLS12_377, curve.scalar.unpack(scalars[:, :64]), logs[:64])

    # K13 on both codecs and both field shapes; K14 (K3-K7 on PackedCodec
    # rows), K4m on strided halves, pass-through lanes bit for bit
    Wp = curve.ops_packed
    F22 = TwistedEdwards.create(ED_ON_BLS12_377).ops.F
    for G, codec, rows in ((F, Wp.codec, 32), (F22, Fma51Codec(F22.p), 22), (F22, PackedCodec(F22.p), 22)):
        x, y = (codec.from_digits(G, _elems(dev, rng, rows=rows)) for _ in range(2))
        key = cuda_codec.K13_FMA51 if isinstance(codec, Fma51Codec) else cuda_codec.K13
        before = COUNTS[key]
        assert _rows_equal(G, codec, cuda_codec.montmul_rows(G, codec, x, y),
                           cuda_codec.montmul_rows_plain(G, codec, x, y)), codec
        assert COUNTS[key] == before + 1, codec  # each codec counted under its own key
    a = [Wp.from_native(_elems(dev, rng)) for _ in range(6)]
    slot = Wp.from_native(_elems(dev, rng, width=2 * WIDTH))
    m, inf = f[0], f[1]
    pairs = {
        "K14-K3": (cuda_curve.aff_pair_add(Wp, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3]),
                   cuda_curve.aff_pair_add_plain(Wp, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3])),
        "K14-K4": (cuda_curve.proj_add(Wp, *a), cuda_curve.proj_add_plain(Wp, *a)),
        "K14-K4m strided": (
            cuda_curve.proj_add(Wp, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:], mask=m),
            cuda_curve.proj_add_plain(Wp, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:], mask=m)),
        "K14-K5": (cuda_curve.proj_double_k(Wp, *a[:3], 5), cuda_curve.proj_double_k_plain(Wp, *a[:3], 5)),
        "K14-K6": (cuda_curve.proj_double(Wp, *a[:3]), cuda_curve.proj_double_plain(Wp, *a[:3])),
        "K14-K7": (cuda_curve.proj_add_mixed(Wp, *a[:5], inf), cuda_curve.proj_add_mixed_plain(Wp, *a[:5], inf)),
    }
    for name, (got, want) in pairs.items():
        for g, w in zip(got, want):
            assert _rows_equal(F, Wp.codec, g, w), name
    for name, keep, p1 in (("K14-K4m strided", m == 0, (slot[:, :WIDTH], *a[1:3])),
                           ("K14-K7", inf == 1, a[:3])):
        for g, x in zip(pairs[name][0], p1):
            assert torch.equal(g[:, keep], x[:, keep]), name
    rp = curve.random_points_fast(N, seed=3, device=dev)
    assert bool(W.affine_is_on_curve(rp).all())

    # ed-on-bls12-377: K1 on the 22-limb field, K8, K9, K10-K12 (K11 with
    # and without a mask, on strided halves of one slot block)
    ed = TwistedEdwards.create(ED_ON_BLS12_377)
    E, FE = ed.ops, ed.ops.F
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
