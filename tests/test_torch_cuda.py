"""The port's CUDA kernels on the card, against their plain twins.

This file imports nothing of JAX or the JAX package (the machine with the
card has no JAX), so run it there without the suite's conftest, which
configures JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False (decided inside the fixture). Widths
are odd (ragged last block) and some operands are strided slices, which
the kernels read in place. Each Weierstrass curve (BLS12-377, BLS12-381
with n = 33, Pallas with n = 22 and 4p > 2^256) the same way. K8 (one warp
a lane) on all four field shapes at W = 1, 3, 64 and 1000 on strided limb
rows, at ten exponents from 0 to a random 350-bit one, with 0, 1, p - 1
and 4p - 1 among its inputs, and its one-thread probe; K6 (K5's group
instance at k = 1) on every storage at W = 1, 256 and 1000; K2 at c = 8,
12, 21, 22 and 30 (the widest, ``cuda_scalar.MAX_C``), W = 1, 1000, 4099
and 2^16, without and with an infinity mask, the scalars 0, 1, q - 1 and
q // 2 among its inputs, and K9 at c = 6, 11, 21, 22 and 30 at the same
widths; c = 31 refused by both wrappers; a BLS12-377 and an
ed-on-bls12-377 MSM at N = 16 and c = 22 against the known logs. Tolerance: K2
and K9 bit-exact; K1 limb-exact (the Montgomery product is one integer)
where 4p < 2^(32 NW), mod p on Pallas (also on inputs in [2^256, 4p), which
its kernel reduces first); K3-K8 and K10-K12 exact mod p, with operands at
2p - 1 whose sums cross 2^256 on Pallas, and the pass-through lanes of K4m
and K7 bit for bit; the halving layout on int32 CUDA tensors bit-exact
against the CPU; K13 and the K14 variants of K3-K7 on every codec storage
(PackedCodec on each curve, Fma51Codec on Pallas; K13 also on both codecs
of the n = 22 Edwards field) exact mod p with every output below 2p, their
pass-through lanes bit for bit. K3, K4, K4m and K5 on every storage also
run each built instance (G threads a point, as the library lists them):
K3 at W = 1, at a block's points +- 1 and at the main round's 901,120
lanes, with invalid lanes on either side or both; K4, K4m and K5 at widths
that cut a group, a warp and a block (1, 5, 33, 4097), on strided operands
with 2p - 1 and 2p - 2 among them, K5 at k = 1, 5 and 12; and every entry
of the kernels' width table through the engines' wrappers, the table's
picks equal to the built lists; an instance that is not built (the
one-thread K4m everywhere, the one-thread K4 on 12-word shapes) is
refused. K7 the same way on every storage, at W = 1, a block's points +- 1
and its path widths (704 and 65,536), its inf2 lanes bit for bit. K11
(G = 4, unmasked and masked) at W = 1, a block's points +- 1 and the
Edwards padded path's widths (23 to 471,040), its masked-off lanes bit for
bit. The Edwards K12 (one instance) at W = 1 and 23, k = 1, 5 and 11.
Every curve kernel's outputs lie below 2p. An Fp22 and a
Pallas launch on the same limbs take different shape IDs, and the C
entries refuse a Pallas field under Fp22's. The fields outside the four
main shapes (secp256k1, goldilocks, babybear, n = 1, n = 63) take shapes
made on demand: K1 limb for limb and K8 mod p against the twins, K4 and K5
with 3b by a product. The widest: K2 on BN462's scalar module (a library of
its own) bit for bit and K9 on its 39-limb scalars, at c = 8, 13, 22 and 30,
W = 1, 1000 and 4099, with and without the mask; K3-K7 and K4m on limbs and
on PackedCodec rows of n = 39 (BN462's field) and n = 63 and on goldilocks's
Fma51Codec rows, K13 on those rows, K10-K12 at n = 63, at widths that cut a
group, a warp and a block, the pass-through lanes bit for bit; BN462's MSM
at N = 64 in every mode and ed25519's in both against the known logs. The
sharded MSM on two rank
processes sharing the card over gloo (``testing/mesh_ranks.card_ranks``):
every rank's result equals the known logs, and each run launched every
kernel of its path.
"""

import types

import numpy as np
import pytest
import torch

from msm_zprize_tpu_torch import _build
from msm_zprize_tpu_torch.counters import COUNTS
from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
from msm_zprize_tpu_torch.curves.example_fields import EXAMPLE_FIELDS
from msm_zprize_tpu_torch.curves.params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from msm_zprize_tpu_torch.curves.weierstrass import ProjectivePoints
from msm_zprize_tpu_torch.fields import cuda_codec, cuda_mul, cuda_scalar
from msm_zprize_tpu_torch.fields.codec import Fma51Codec, PackedCodec
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.fields.cuda_scalar import glv_digits, glv_digits_plain, simple_digits
from msm_zprize_tpu_torch.fields.scalar import signed_digits
from msm_zprize_tpu_torch.msm.common import halving_layout
from msm_zprize_tpu_torch.parallel import launch
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
from msm_zprize_tpu_torch.submission import compute_msm
from msm_zprize_tpu_torch.testing import mesh_ranks
from msm_zprize_tpu_torch.testing.points import (
    ed_expected_msm, ed_points_with_logs, expected_msm, points_with_logs,
)
from msm_zprize_tpu_torch.testing.wide_curves import BN462, ED25519, TOY63_P

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
K3_MAIN = 901_120  # K3's main-round width in the 2^16 MSMs
K7_AFFINE, K7_POINTS = 704, 65_536  # K7's widths: the affine reduction, random_points_fast
K11_PATH = (23, 736, 23_552, 471_040)  # K11's widths on the Edwards padded path at 2^16
K10_PATH = (32_768, 942_080)  # K10's widths there: the residual's level 1, the main round's
K10_ED25519 = (32_768, 983_040)  # and on ed25519's padded path


def _below_2p(F, g):
    """Every value of the limb tensor g is below 2p."""
    return torch.equal(F._sub_const_select(g, F.two_p_limbs), g)


def _block_points(G):
    """Points a 128-thread block of G threads a point holds."""
    return 128 if G == 1 else 32 // G * 4


def _group_checks(F, Wc, codec, a, halves, f, label):
    """Every built instance of K3, K4, K4m, K5 and K7 (G threads a point, as
    ``cuda_curve._groups`` reads them from the library) against the twin:
    K3 at W = 1, at one block's points +- 1 of each instance and at the main
    round's width, its first lanes invalid on either side or both (flags
    f: s1 v1 s2 v2); K7 at W = 1, one block's points +- 1 and its path
    widths; K4, K4m, K5 and K7 at widths that cut a group or a block, on the
    strided halves too (K4, K4m, K7), K5 at k = 1, 5 and 12, the
    pass-through lanes of K4m and K7 bit for bit; every output below 2p; the
    width table's picks equal to the built lists, and an instance that is
    not built refused."""
    m, inf = f[0], f[1]
    same = ((lambda g, w: torch.equal(F.fully_reduce(g), F.fully_reduce(w)) and _below_2p(F, g))
            if codec is None else (lambda g, w: _rows_equal(F, codec, g, w)))
    built = {name: cuda_curve._groups(Wc, name) for name in (cuda_curve.K3, cuda_curve.K4,
                                                            cuda_curve.K4M, cuda_curve.K5,
                                                            cuda_curve.K7)}
    reached = set()

    def k7_check(G, args, flag, width):
        """One K7 instance against the twin, its inf2 lanes P1's rows bit for bit."""
        got = cuda_curve._proj_add_mixed(Wc, G, *args[:5], flag)
        want = cuda_curve.proj_add_mixed_plain(Wc, *args[:5], flag)
        assert all(map(same, got, want)), (label, "K7", G, width)
        for g, x1 in zip(got, args[:3]):
            assert torch.equal(g[:, flag == 1], x1[:, flag == 1]), (label, "K7", G, width)

    k7_widths = {1, K7_AFFINE, K7_POINTS} | {_block_points(G) + d for G in built[cuda_curve.K7]
                                             for d in (-1, 0, 1)}
    for width in sorted(k7_widths):
        ops, flag = [_tile(x, width) for x in a[:5]], _tile(inf, width)
        reached.add((cuda_curve.K7, cuda_curve._group_for(Wc, cuda_curve.K7, width)))
        for G in built[cuda_curve.K7]:
            k7_check(G, ops, flag, width)
    v1, v2 = f[1].clone(), f[3].clone()
    v1[:4] = torch.tensor([0, 1, 0, 1], dtype=v1.dtype)
    v2[:4] = torch.tensor([0, 0, 1, 1], dtype=v2.dtype)
    k3_ops = (a[0], a[1], f[0], v1, a[2], a[3], f[2], v2)
    k3_widths = {1, K3_MAIN} | {_block_points(G) + d for G in built[cuda_curve.K3] for d in (-1, 0, 1)}
    for width in sorted(k3_widths):
        ops = [_tile(x, width) for x in k3_ops]
        want = cuda_curve.aff_pair_add_plain(Wc, *ops)
        reached.add((cuda_curve.K3, cuda_curve._group_for(Wc, cuda_curve.K3, width)))
        for G in built[cuda_curve.K3]:
            got = cuda_curve._aff_pair_add(Wc, G, *ops)
            assert all(map(same, got, want)), (label, "K3", G, width)
    for width in GROUP_WIDTHS:
        ops = [x[:, :width] for x in a]
        strided = [x[:, :width] for x in halves]
        mask = m[:width]
        for name, groups in built.items():
            if name == cuda_curve.K3:
                continue
            pick = cuda_curve._group_for(Wc, name, width)
            assert pick in groups, (label, name, width, pick)
            reached.add((name, pick))
            for G in groups:
                if name == cuda_curve.K7:
                    for args in (ops, strided):
                        k7_check(G, args, inf[:width], width)
                    continue
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
    # first width (powers of two and their neighbours up to 2^20) that picks
    # it; the table picks every built instance and no other
    first = {}
    for e in range(21):
        for width in (max(1, (1 << e) - 1), 1 << e, (1 << e) + 1):
            for name in built:
                first.setdefault((name, cuda_curve._group_for(Wc, name, width)), width)
    for name, groups in built.items():
        assert {G for nm, G in first if nm == name} == set(groups), (label, name, groups)
    for (name, G), width in sorted(first.items()):
        if (name, G) in reached:
            continue
        ops = [_tile(x, width) for x in (k3_ops if name == cuda_curve.K3 else a)]
        if name == cuda_curve.K7:
            flag = _tile(inf, width)
            got = cuda_curve.proj_add_mixed(Wc, *ops[:5], flag)
            want = cuda_curve.proj_add_mixed_plain(Wc, *ops[:5], flag)
        elif name == cuda_curve.K3:
            got, want = cuda_curve.aff_pair_add(Wc, *ops), cuda_curve.aff_pair_add_plain(Wc, *ops)
        elif name == cuda_curve.K5:
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
    for G in {1, 2, 3, 6, 7} - set(built[cuda_curve.K3]):
        with pytest.raises(RuntimeError):
            cuda_curve._aff_pair_add(Wc, G, *k3_ops)
    for G in {1, 2, 3, 4, 6, 7} - set(built[cuda_curve.K7]):
        with pytest.raises(RuntimeError):
            cuda_curve._proj_add_mixed(Wc, G, *a[:5], inf)


def _k11_checks(E, a, m, strided):
    """K11 (G = 4 threads a point), unmasked and masked, against the twin
    at widths that cut a group, a warp and a block, at one block's points
    +- 1 and at the Edwards padded path's widths, and on ``strided``
    (halves of one slot block, read in place); the masked-off lanes P1's
    limbs bit for bit, every output below 2p."""
    FE = E.F
    for masked in (False, True):
        for width in sorted(set(GROUP_WIDTHS) | set(K11_PATH) | {_block_points(4) + d for d in (-1, 0, 1)}):
            ops = [_tile(x, width) for x in a]
            kw = {"mask": _tile(m, width)} if masked else {}
            got, want = cuda_edwards.ed_add(E, *ops, **kw), cuda_edwards.ed_add_plain(E, *ops, **kw)
            assert all(torch.equal(FE.fully_reduce(g), FE.fully_reduce(w)) and _below_2p(FE, g)
                       for g, w in zip(got, want)), ("K11", width, masked)
            if masked:
                off = kw["mask"] == 0
                for g, x1 in zip(got, ops[:4]):
                    assert torch.equal(g[:, off], x1[:, off]), ("K11", width)
        kw = {"mask": m} if masked else {}
        got, want = cuda_edwards.ed_add(E, *strided, **kw), cuda_edwards.ed_add_plain(E, *strided, **kw)
        assert all(torch.equal(FE.fully_reduce(g), FE.fully_reduce(w))
                   for g, w in zip(got, want)), ("K11 strided", masked)


def _tile(x, width):
    """x's lanes repeated to ``width`` lanes."""
    return x.repeat(*([1] * (x.dim() - 1)), -(-width // x.shape[-1]))[..., :width].contiguous()


def _k10_checks(E, dev, rng, path_widths, label):
    """Every built K10 instance (G threads a point, as
    ``cuda_edwards._k10_groups`` reads them from the library; 1: the
    one-thread kernel) against the twin at W = 1, one block's points +- 1 of
    each instance, WIDTH and the padded path's widths, the first lanes
    invalid on either side or both and negated: equal mod p, every output
    below 2p; the width table picks every built instance and no other."""
    G = E.F
    built = cuda_edwards._k10_groups(E)
    x = [_vals(G, dev, rng, WIDTH, (2 * G.p - 1, 2 * G.p - 2, 0, 1)) for _ in range(4)]
    f = [torch.as_tensor(rng.integers(0, 2, size=WIDTH, dtype=np.int32), device=dev) for _ in range(4)]
    f[1][:4] = torch.tensor([0, 1, 0, 1], dtype=f[1].dtype)
    f[3][:4] = torch.tensor([0, 0, 1, 1], dtype=f[3].dtype)
    f[0][:4] = f[2][:4] = 1
    slots = (x[0], x[1], f[0], f[1], x[2], x[3], f[2], f[3])
    widths = {1, WIDTH, *path_widths} | {_block_points(g) + d for g in built for d in (-1, 0, 1)}
    for width in sorted(widths):
        ops = [_tile(t, width) for t in slots]
        want = cuda_edwards.ed_pair_add_plain(E, *ops)
        assert cuda_edwards._k10_group_for(E, width) in built, (label, width)
        for g in built:
            got = cuda_edwards._ed_pair_add(E, g, *ops)
            assert all(torch.equal(G.fully_reduce(a), G.fully_reduce(b)) and _below_2p(G, a)
                       for a, b in zip(got, want)), (label, "K10", g, width)
    picked = {cuda_edwards._k10_group_for(E, w) for e in range(21)
              for w in (max(1, (1 << e) - 1), 1 << e, (1 << e) + 1, *path_widths)}
    assert picked == set(built), (label, picked, built)


K6_WIDTHS = (1, 256, 1000)  # K6 (K5's group instance at k = 1): a lane, the subgroup check's width
K8_WIDTHS = (1, 3, 64, 1000)


def _k8_checks(F, dev, rng):
    """K8 on F's shape at widths 1, 3, 64 and 1000 (prefixes of one strided
    operand: limb rows 2000 apart) and at e in {0, 1, 2, 15, 16, 17,
    2^64 - 1, p - 2, (p - 1) / 2, a random 350-bit e}, the inputs 0, 1,
    p - 1 and 4p - 1 (the largest the contract admits; on Pallas above
    2^256) among the lanes: equal to the twin mod p and below 2p; K8's
    probe (one thread a lane, binary square-and-multiply) the same at W =
    64, e = 0 and p - 2."""
    p = F.p
    x = _vals(F, dev, rng, 2 * max(K8_WIDTHS), (0, 1, p - 1, 4 * p - 1), bound=4 * p)[:, :max(K8_WIDTHS)]
    exps = (0, 1, 2, 15, 16, 17, (1 << 64) - 1, p - 2, (p - 1) // 2,
            int.from_bytes(rng.bytes(44), "little") % (1 << 350) | 1 << 349)
    for e in exps:
        want = F.fully_reduce(F.exp_const_plain(x, e))
        for width in K8_WIDTHS:
            got = cuda_mul.exp_const(F, x[:, :width], e)
            assert torch.equal(F.fully_reduce(got), want[:, :width]) and _below_2p(F, got), (width, e)
    for e in (0, p - 2):
        got = cuda_mul._exp_probe(F, x[:, :64], e)
        assert torch.equal(F.fully_reduce(got), F.fully_reduce(F.exp_const_plain(x[:, :64], e))), e
    with pytest.raises(ValueError):
        cuda_mul.exp_const(F, x, 1 << 384)


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
    _k8_checks(F, dev, rng)
    s_edges = torch.as_tensor(S.pack([0, 1, S.q - 1, S.q // 2]), device=dev)
    for c in (8, 12, 21, 22, cuda_scalar.MAX_C):
        K = -(-(S.max_bits + 1) // c)
        for width in (1, 1000, WIDTH, 1 << 16):
            s = cv.random_scalars(width, seed=c, device=dev)
            s[:, :4] = s_edges[:, :width]
            mask = torch.as_tensor(np.random.default_rng(width).integers(0, 2, size=2 * width, dtype=np.int32),
                                   device=dev)
            for inf in (None, mask):
                got, want = glv_digits(S, s, c, K, inf), glv_digits_plain(S, s, c, K, inf)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (c, width, inf is None)
    with pytest.raises(ValueError):
        glv_digits(S, s, 12, K, inf=mask.bool())
    with pytest.raises(ValueError, match="1..30"):  # refused before any launch
        glv_digits(S, s, cuda_scalar.MAX_C + 1, K)

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
            **{f"K6 W={w}": (cuda_curve.proj_double(Wc, *[x[:, :w] for x in halves[:3]]),
                             cuda_curve.proj_double_plain(Wc, *[x[:, :w] for x in halves[:3]]))
               for w in K6_WIDTHS},
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
        _group_checks(F, Wc, codec, a, halves, f, params.label)
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
    _k8_checks(FE, dev, rng)
    for c in (6, 11, 21, 22, cuda_scalar.MAX_C):
        K = -(-(ed.scalar.bits + 1) // c)
        for width in (1, 1000, WIDTH, 1 << 16):
            s = ed.random_scalars(width, seed=c, device=dev)
            got, want = simple_digits(s, c, K), signed_digits(s, c, K, 12)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (c, width)
    with pytest.raises(ValueError, match="1..30"):
        simple_digits(s, cuda_scalar.MAX_C + 1, K)
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
    _k11_checks(E, a, m, (slot[:, :WIDTH], *a[1:4], slot[:, WIDTH:], *a[5:]))
    _k10_checks(E, dev, rng, K10_PATH, "ed-on-bls12-377")
    # K12 (G = 4 threads a point) at its MSM widths and k's, every output
    # below 2p
    for width in (1, 23):
        ops = [x[:, :width] for x in a[:4]]
        for k in (1, 5, 11):
            got = cuda_edwards.ed_double_k(E, *ops, k)
            want = cuda_edwards.ed_double_k_plain(E, *ops, k)
            assert all(torch.equal(FE.fully_reduce(g), FE.fully_reduce(w)) and _below_2p(FE, g)
                       for g, w in zip(got, want)), ("K12", width, k)

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
    # windows past 20 bits (L = 2^21 buckets): N = 16 MSMs at c = 22 on both
    # curves; the Edwards one has windows with few distinct digits, where the
    # padded engine's fold indexes past int32 before clamping
    for cv, params, with_logs, expected in ((curve, BLS12_377, points_with_logs, expected_msm),
                                            (ed, ED_ON_BLS12_377, ed_points_with_logs, ed_expected_msm)):
        pts16, logs16 = with_logs(params, 16, seed=22)
        s16 = cv.random_scalars(16, seed=22, device=dev)
        got = cv.result_to_int(cv.msm(s16, cv.points_from_ints(pts16, dev), c=22))
        assert got == expected(params, cv.scalar.unpack(s16.cpu()), logs16), params.label
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

    # queue 3's fault 3: the fields outside the four main shapes take shapes
    # made on demand; K1 limb for limb and K8 / inverse mod p against the
    # twins, and the curve kernels (3b by a product) on each, n = 63 among
    # them
    for p in (EXAMPLE_FIELDS["secp256k1-fp"], EXAMPLE_FIELDS["goldilocks"],
              EXAMPLE_FIELDS["babybear"], 97, TOY63_P):
        G = make_field(p)
        assert _build.field_shape(G) >= _build.DYN_ID_BASE
        a, b = _vals(G, dev, rng, WIDTH, (4 * p - 1, 1)), _vals(G, dev, rng, WIDTH, (2 * p - 1, 3))
        assert torch.equal(cuda_mul.montmul(G, a, b), G.montmul_plain(a, b)), p
        assert _below_2p(G, cuda_mul.exp_const(G, a, p - 2))
        assert torch.equal(G.fully_reduce(cuda_mul.exp_const(G, a, p - 2)),
                           G.fully_reduce(G.exp_const_plain(a, p - 2))), p
        Wd = types.SimpleNamespace(F=G, b3_mont=123457 * G.R % p, b3_small=None,
                                   storage=cuda_curve.Storage(G.n))
        P1 = [_vals(G, dev, rng, WIDTH) for _ in range(3)]
        P2 = [_vals(G, dev, rng, WIDTH) for _ in range(3)]
        for got, want in ((cuda_curve.proj_add(Wd, *P1, *P2), cuda_curve.proj_add_plain(Wd, *P1, *P2)),
                          (cuda_curve.proj_double_k(Wd, *P1, 2),
                           cuda_curve.proj_double_k_plain(Wd, *P1, 2))):
            assert all(torch.equal(G.fully_reduce(g), G.fully_reduce(w)) for g, w in zip(got, want))
    _wide_checks(dev, rng)


def _wide_checks(dev, rng):
    """Queue 3's last kernels: K2 on BN462's scalar module (its own
    library) bit for bit, K9 on its 39-limb scalars; every curve kernel on
    limbs and on the PackedCodec rows of n = 39 (BN462's field, 15 rows) and
    n = 63 (25 rows) at widths that cut a group, a warp and a block, and on
    goldilocks's Fma51Codec rows, with K13 on each; BN462's MSM at N = 64 in
    every mode and ed25519's in both, against the known logs."""
    cv = Weierstrass.create(BN462)
    S = cv.scalar
    for width in (1, 1000, WIDTH):
        s = cv.random_scalars(width, seed=width, device=dev)
        s[:, :4] = torch.as_tensor(S.pack([0, 1, BN462.order - 1, BN462.order // 2]),
                                   device=dev)[:, :width]
        inf = torch.as_tensor(rng.integers(0, 2, size=2 * width, dtype=np.int32), device=dev)
        for c in (8, 13, 22, cuda_scalar.MAX_C):
            K = -(-(S.max_bits + 1) // c)
            for mask in (None, inf):
                got, want = glv_digits(S, s, c, K, mask), glv_digits_plain(S, s, c, K, mask)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), ("K2", width, c)
            K9 = -(-(S.bits + 1) // c)
            got, want = simple_digits(s, c, K9), signed_digits(s, c, K9, 12)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), ("K9", width, c)
    gold = make_field(EXAMPLE_FIELDS["goldilocks"])
    for G, codec in ((cv.ops.F, None), (cv.ops.F, PackedCodec(BN462.modulus)), (make_field(TOY63_P), None),
                     (make_field(TOY63_P), PackedCodec(TOY63_P)), (gold, Fma51Codec(gold.p))):
        st = cuda_curve.Storage(G.n) if codec is None else cuda_curve.Storage.of_codec(codec)
        Wd = types.SimpleNamespace(F=G, b3_mont=15 * G.R % G.p, b3_small=15, storage=st)
        enc = (lambda t: t) if codec is None else (lambda t: codec.from_digits(G, t))
        err = ((lambda g, w: torch.equal(G.fully_reduce(g), G.fully_reduce(w))) if codec is None
               else (lambda g, w: _rows_equal(G, codec, g, w)))
        for width in GROUP_WIDTHS:
            P1, P2 = ([enc(_vals(G, dev, rng, width, (2 * G.p - 1,))) for _ in range(3)]
                      for _ in range(2))
            f = [torch.as_tensor(rng.integers(0, 2, size=width, dtype=np.int32), device=dev)
                 for _ in range(4)]
            slots = (P1[0], P1[1], f[0], f[1], P2[0], P2[1], f[2], f[3])
            for name, got, want, keep in (
                ("K3", cuda_curve.aff_pair_add(Wd, *slots), cuda_curve.aff_pair_add_plain(Wd, *slots), None),
                ("K4", cuda_curve.proj_add(Wd, *P1, *P2), cuda_curve.proj_add_plain(Wd, *P1, *P2), None),
                ("K4m", cuda_curve.proj_add(Wd, *P1, *P2, mask=f[0]),
                 cuda_curve.proj_add_plain(Wd, *P1, *P2, mask=f[0]), f[0] == 0),
                ("K5", cuda_curve.proj_double_k(Wd, *P1, 5), cuda_curve.proj_double_k_plain(Wd, *P1, 5), None),
                ("K6", cuda_curve.proj_double(Wd, *P1), cuda_curve.proj_double_plain(Wd, *P1), None),
                ("K7", cuda_curve.proj_add_mixed(Wd, *P1, P2[0], P2[1], f[1]),
                 cuda_curve.proj_add_mixed_plain(Wd, *P1, P2[0], P2[1], f[1]), f[1] == 1),
            ):
                assert all(err(g, w) for g, w in zip(got, want)), (G.n, codec, name, width)
                if keep is not None:  # pass-through lanes: P1's rows bit for bit
                    assert all(torch.equal(g[:, keep], a[:, keep]) for g, a in zip(got, P1)), name
            if codec is not None:
                assert _rows_equal(G, codec, cuda_codec.montmul_rows(G, codec, P1[0], P2[0]),
                                   cuda_codec.montmul_rows_plain(G, codec, P1[0], P2[0])), (G.n, "K13")
            elif G.n == 63:
                E = types.SimpleNamespace(F=G, k_mont=12345 * G.R % G.p, two_mont=2 * G.R % G.p)
                Q = [_vals(G, dev, rng, width) for _ in range(8)]
                for got, want in ((cuda_edwards.ed_add(E, *Q, mask=f[0]), cuda_edwards.ed_add_plain(E, *Q, mask=f[0])),
                                  (cuda_edwards.ed_double_k(E, *Q[:4], 3),
                                   cuda_edwards.ed_double_k_plain(E, *Q[:4], 3)),
                                  (cuda_edwards.ed_pair_add(E, Q[0], Q[1], f[0], f[1], Q[2], Q[3], f[2], f[3]),
                                   cuda_edwards.ed_pair_add_plain(E, Q[0], Q[1], f[0], f[1], Q[2], Q[3], f[2], f[3]))):
                    assert all(torch.equal(G.fully_reduce(g), G.fully_reduce(w)) for g, w in zip(got, want))

    # the MSMs through the entry points: BN462 in every mode, ed25519 in both
    N = 64
    pts, logs = points_with_logs(BN462, N, seed=462)
    s = cv.random_scalars(N, seed=462, device=dev)
    want = expected_msm(BN462, S.unpack(s.cpu()), logs)
    P = cv.points_from_ints(pts, dev)
    for mode in ("projective", "packed", "affine", "halving"):
        assert cv.result_to_int(cv.msm(s, P, mode=mode)) == want, mode
    assert cv.result_to_int(cv.msm_unsafe(s, P, mode="packed")) == want
    assert cv.result_to_int(cv.msm_projective(s, cv.ops.from_affine(P))) == want
    ed = TwistedEdwards.create(ED25519)
    _k10_checks(ed.ops, dev, rng, K10_ED25519, "ed25519")
    epts, elogs = ed_points_with_logs(ED25519, N, seed=25519)
    es = ed.random_scalars(N, seed=25519, device=dev)
    ewant = ed_expected_msm(ED25519, ed.scalar.unpack(es.cpu()), elogs)
    for mode in ("padded", "basic"):
        assert ed.result_to_int(ed.msm(es, ed.points_from_ints(epts, dev), mode=mode)) == ewant, mode


def test_mesh_two_ranks_on_one_card(dev):
    """BLS12-377 on the 1-D mesh and both 2-D ones, ed-on-bls12-377 on the
    1-D one (N = 2^10) and ``compute_msm`` with ``mesh=`` (N = 256), on two
    ranks sharing the card over gloo (NCCL refuses two ranks on one card)."""
    N, seed = 1 << 10, 31
    pts, logs = points_with_logs(BLS12_377, N, seed=seed)
    epts, elogs = ed_points_with_logs(ED_ON_BLS12_377, N, seed=seed)
    W, E = Weierstrass.create(BLS12_377), TwistedEdwards.create(ED_ON_BLS12_377)
    scs = W.scalar.unpack(W.random_scalars(256, seed=seed + 1, device="cpu"))
    inputs = {"N": N, "seed": seed, "bls12-377": pts, "ed-on-bls12-377": epts,
              "compute_msm": (scs, pts[:256])}
    want = {
        "bls12-377": expected_msm(BLS12_377, W.scalar.unpack(W.random_scalars(N, seed, "cpu")), logs),
        "ed-on-bls12-377": ed_expected_msm(ED_ON_BLS12_377,
                                           E.scalar.unpack(E.random_scalars(N, seed, "cpu")), elogs),
        "compute_msm": expected_msm(BLS12_377, scs, logs[:256]),
    }
    results = launch.spawn(mesh_ranks.card_ranks, 2, device="cuda", backend="gloo", args=(inputs,))
    mesh_ranks.check_card_ranks(results, want)
    assert all(res["bls12-377 msm 1-D"]["counts"]["exchange_bytes"] > 0 for res in results)
