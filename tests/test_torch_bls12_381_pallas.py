"""The port's BLS12-381 and Pallas curves against the JAX package, on the CPU.

* Parameters: the port's ``BLS12_381`` and ``PALLAS`` equal the JAX
  package's field for field (Pallas's lambda and beta derived at import).
  The word-level model of their field shapes (K0) is in
  ``tests/test_torch_edwards.py`` with the other shapes', and their plain
  field ops against the JAX field in ``tests/test_torch_fields.py``.
* K2's twin against ``glv_digits_pallas(..., interpret=True)`` on both
  curves' scalars: bit-exact; the compiled K2 kernel's limb sizes
  (``csrc/glv_digits.cu``) are both curves' scalar sizes, and ``_consts``
  packs the word count the kernel takes (its constants in 32-bit words).
* K3-K7's twins on both curves: K4 against ``CurveKernels(...,
  interpret=True)``, every one against the JAX ``WeierstrassOps`` jnp ops,
  on curve points with random Z, identity, doubling and cancelling lanes
  and coordinates at 2p - 1: exact mod p, the pass-through lanes of K4m
  and K7 bit for bit.
* K13's twin on (Pallas, ``Fma51Codec``) against ``montmul51_pallas(...,
  interpret=True)`` and the bigint product; K14's on ``Fma51Codec`` against
  ``Fma51WeierstrassOps(PALLAS, interpret=True).kernels`` (K4) and the
  native twins (K3, K5, K4m, K6, K7): mod p, outputs below 2p, pass-through
  rows bit for bit.
* Every mode of both curves (``"projective"``, ``"packed"``, Pallas's
  ``"fma51"``, ``"affine"``, ``msm_unsafe``, ``"halving"``,
  ``msm_projective``) at N in {1, 8, 64} and on an edge input against the
  bigint Pippenger oracle (``bigint/msm.py``) and the known discrete logs,
  on inputs packed by the JAX package; ``random_points_fast``'s bases are
  the JAX oracle's and its lanes the host sums of their picks.

Tolerance: K2 bit-exact; field values exact mod p (limb for limb where both
sides compute the same integer); pass-through lanes bit for bit; MSM
results exact affine points. No whole-MSM JAX run on XLA:CPU (minutes of
compile). ONE test item (~140 s serial): the CPU suite's wall time follows
its item count, and a replay of pytest-xdist's scheduler (``PERF.md``) put
one item at the lowest predicted wall. The CUDA kernels run on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import random
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.bigint.weierstrass import AffineCurve, ProjectiveCurve
from msm_zprize_tpu.curves import params as jax_params
from msm_zprize_tpu.curves import weierstrass51 as J51
from msm_zprize_tpu.curves.pallas_curve import CurveKernels
from msm_zprize_tpu.curves.weierstrass import AffinePoints as JaxAffine
from msm_zprize_tpu.curves.weierstrass import ProjectivePoints as JaxProj
from msm_zprize_tpu.fields import fma51_pallas as JF
from msm_zprize_tpu.fields.pallas_scalar import glv_digits_pallas
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch import _build
from msm_zprize_tpu_torch.curves import cuda_curve
from msm_zprize_tpu_torch.curves import params as port_params
from msm_zprize_tpu_torch.fields import cuda_scalar
from msm_zprize_tpu_torch.fields.codec import Fma51Codec
from msm_zprize_tpu_torch.fields.cuda_codec import montmul_rows_plain
from msm_zprize_tpu_torch.parallel.api import Weierstrass
from msm_zprize_tpu_torch.testing.points import expected_msm, naive_msm, points_with_logs
from msm_zprize_tpu_torch.utils.convert import affine_from_jax, proj_from_jax, scalars_from_jax

torch.set_num_threads(1)

CURVES = {"bls12-381": jax_params.BLS12_381, "pallas": jax_params.PALLAS}
B = 8


def _ints(rng, bound, count, edges=()):
    vals = [v for v in edges if v < bound]
    return vals + [int.from_bytes(rng.bytes(56), "little") % bound for _ in range(count - len(vals))]


def _values(F, arrs):
    return [F.unpack(np.asarray(a)) for a in arrs]


def _check_params():
    """The port's parameters are the JAX package's; beta and lambda are
    cube roots of one, and the endomorphism acts as lambda on G."""
    for label, J in CURVES.items():
        T = port_params.WEIERSTRASS_CURVES[label]
        assert dataclasses.asdict(T) == dataclasses.asdict(J), label
        p, q = T.modulus, T.order
        assert pow(T.beta, 3, p) == 1 != T.beta and pow(T.lambda_, 3, q) == 1 != T.lambda_, label
        O = AffineCurve(T)
        assert O.scale(T.lambda_, T.generator) == (T.beta * T.generator[0] % p, T.generator[1])


# ---- K2 ----------------------------------------------------------------------------


def _check_k2(monkeypatch):
    src = (Path(_build.CSRC) / "glv_digits.cu").read_text()
    baked = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("NS", "NH", "NACC", "K0L", "NM", "MW", "VW")}
    words = 5 + 4 + 2 * baked.pop("MW") + 4 * baked.pop("VW")  # GlvConsts: dims, sg, m0, m1, v
    fake = types.SimpleNamespace(msm_glv_const_words=lambda: words)  # the kernel's count
    rng = np.random.default_rng(2)
    for label, J in CURVES.items():
        cv, jv = Weierstrass.create(port_params.WEIERSTRASS_CURVES[label]), JaxWeierstrass.create(J)
        S, q = cv.scalar, J.order
        assert (S.n, S.n_half, S.n_acc, S.K0_limbs, len(S.m0)) == tuple(baked.values()), label
        with monkeypatch.context() as mp:
            mp.setattr(_build, "library", lambda: (fake, None))
            assert len(cuda_scalar._consts.__wrapped__(S)) == words, label
        scs = _ints(rng, q, 64, (0, 1, q - 1, q // 2))
        c = 12 if label == "bls12-381" else 8  # one interpret-mode compile (~10 s) each
        K = -(-(S.max_bits + 1) // c)
        got = cuda_scalar.glv_digits_plain(S, torch.as_tensor(S.pack(scs)), c, K)
        want = glv_digits_pallas(jv.scalar, jnp.asarray(S.pack(scs)), c, K, interpret=True)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (label, c)


# ---- K3-K7 --------------------------------------------------------------------------


def _check_curve_twins(label):
    """K3-K7's twins against the JAX jnp ops (one jit) and K4's against
    the interpret-mode TPU kernel."""
    J = CURVES[label]
    p = J.modulus
    W_port, W_jax = Weierstrass.create(port_params.WEIERSTRASS_CURVES[label]), JaxWeierstrass.create(J)
    W, JW = W_port.ops, W_jax.ops
    F = W.F
    rng = np.random.default_rng(3)
    pts, _ = points_with_logs(port_params.WEIERSTRASS_CURVES[label], 2 * B, seed=3)
    zs = _ints(rng, p, 2 * B, (1, 2 * p - 1))
    proj = [(x * z % (2 * p), y * z % (2 * p), z) for (x, y), z in zip(pts, zs)]
    Ps, Qs = proj[:B], proj[B:]
    Ps[1] = (0, 1, 0)                               # identity + Q
    Qs[2] = Ps[2]                                   # P + P
    Qs[3] = (Ps[3][0], (-Ps[3][1]) % p, Ps[3][2])   # P + (-P)
    Ps[4] = (2 * p - 1, 2 * p - 2, 2 * p - 1)       # stored values at 2p - 1: sums past 2^256
    a = [F.pack([pt[i] for pt in Ps], montgomery=False) for i in range(3)]
    b = [F.pack([pt[i] for pt in Qs], montgomery=False) for i in range(3)]
    x = F.pack([pt[0] for pt in pts[B:]])
    y = F.pack([pt[1] for pt in pts[B:]])
    x[:, 0], y[:, 0] = F.pack([2 * p - 1], montgomery=False)[:, 0], F.pack([2 * p - 2], montgomery=False)[:, 0]
    fl = [np.array(f, np.int32) for f in ([1, 0, 1, 1, 0, 0, 1, 0], [1, 1, 0, 1, 0, 1, 1, 0],
                                          [0, 1, 1, 0, 1, 1, 0, 1], [1, 1, 1, 0, 0, 1, 0, 1])]
    aff = (a[0], a[1], fl[0], fl[1], x, y, fl[2], fl[3])
    mask, inf = fl[0], fl[1]

    def jax_side(a, b, aff, x, y, mask, inf):
        Pa, Pb = JaxProj(*a), JaxProj(*b)
        return (JW.proj_add(Pa, Pb), JW.proj_add(Pa, Pb, mask=mask.astype(bool)),
                JW.proj_double(Pa), JW.proj_double_k(Pa, 3), JW.aff_pair_add(*aff),
                JW.proj_add_affine(Pa, JaxAffine(x, y, inf)))

    j = lambda arrs: tuple(map(jnp.asarray, arrs))
    want = jax.jit(jax_side)(j(a), j(b), j(aff), jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(mask), jnp.asarray(inf))
    t = lambda arrs: [torch.as_tensor(v) for v in arrs]
    ta, tb, tm, ti = t(a), t(b), torch.as_tensor(mask), torch.as_tensor(inf)
    got = (cuda_curve.proj_add_plain(W, *ta, *tb), cuda_curve.proj_add_plain(W, *ta, *tb, mask=tm),
           cuda_curve.proj_double_plain(W, *ta), cuda_curve.proj_double_k_plain(W, *ta, 3),
           cuda_curve.aff_pair_add_plain(W, *t(aff)),
           cuda_curve.proj_add_mixed_plain(W, *ta, torch.as_tensor(x), torch.as_tensor(y), ti))
    names = ("K4", "K4m", "K6", "K5", "K3", "K7")
    for name, g, w in zip(names, got, want):
        assert [[v % p for v in c] for c in _values(F, g)] == \
            [[v % p for v in c] for c in _values(F, w)], (label, name)
    for name, g, keep in (("K4m", got[1], mask == 0), ("K7", got[5], inf == 1)):
        for gc, ac in zip(g, ta):
            assert torch.equal(gc[:, keep], ac[:, keep]), (label, name)
    C = ProjectiveCurve(J)
    for i, R in enumerate(zip(*_values(F, got[0]))):
        if i != 4:  # the group law on the curve lanes
            assert C.eq(R, C.add(Ps[i], Qs[i])), (label, i)
    kern = CurveKernels(p, F.w, F.n, W.b3_mont, W.b3_small, interpret=True)
    want = kern.proj_add(*j(a), *j(b))
    assert [[v % p for v in c] for c in _values(F, got[0])] == \
        [[v % p for v in c] for c in _values(F, want)], (label, "K4 interpret")


# ---- K13, K14 on Pallas's Fma51Codec -------------------------------------------------


def _check_fma51_kernels():
    J = CURVES["pallas"]
    p = J.modulus
    Wf = Weierstrass.create(port_params.PALLAS).ops51
    F, codec = Wf.F, Wf.codec
    assert isinstance(codec, Fma51Codec) and codec.rows == 10
    jc = JF.Fma51Codec(p)
    r_inv = pow(F.R, -1, p)
    rng = np.random.default_rng(4)
    xs, ys = _ints(rng, 2 * p, 12, (0, 2 * p - 1, 2 * p - 2)), _ints(rng, 2 * p, 12, (5, 2 * p - 1, 1))
    xr, yr = codec.pack(xs), codec.pack(ys)
    got = codec.unpack(montmul_rows_plain(F, codec, torch.as_tensor(xr), torch.as_tensor(yr)))
    want = jc.unpack(JF.montmul51_pallas(p, jnp.asarray(xr), jnp.asarray(yr), interpret=True, codec=jc))
    assert all(g < 2 * p for g in got)
    assert [g % p for g in got] == [w % p for w in want] == [a * b * r_inv % p for a, b in zip(xs, ys)]

    vals = [codec.pack(_ints(rng, 2 * p, B, (2 * p - 1 - i,))) for i in range(6)]
    tv = [torch.as_tensor(v) for v in vals]
    kern = J51.Fma51WeierstrassOps(J, interpret=True).kernels
    got = cuda_curve.proj_add_plain(Wf, *tv)
    want = kern.proj_add(*map(jnp.asarray, vals))
    for g, w in zip(got, want):
        assert [v * r_inv % p for v in codec.unpack(g)] == [v * r_inv % p for v in jc.unpack(np.asarray(w))]
        assert all(v < 2 * p for v in codec.unpack(g))
    # the other K14 twins on the rows against the native twins on their digits
    W = Weierstrass.create(port_params.PALLAS).ops
    nat = [Wf.to_native(v) for v in tv]
    fv = [torch.as_tensor(rng.integers(0, 2, size=B, dtype=np.int32)) for _ in range(4)]
    m, inf = fv[0], fv[1]
    run = {
        "K3": lambda W_, a: (cuda_curve.aff_pair_add_plain(W_, a[0], a[1], fv[0], fv[1], a[2], a[3],
                                                           fv[2], fv[3]), None),
        "K5": lambda W_, a: (cuda_curve.proj_double_k_plain(W_, *a[:3], 2), None),
        "K4m": lambda W_, a: (cuda_curve.proj_add_plain(W_, *a, mask=m), m == 0),
        "K6": lambda W_, a: (cuda_curve.proj_double_plain(W_, *a[:3]), None),
        "K7": lambda W_, a: (cuda_curve.proj_add_mixed_plain(W_, *a[:5], inf), inf == 1),
    }
    for name, fn in run.items():
        (g_rows, passed), (g_nat, _) = fn(Wf, tv), fn(W, nat)
        for g, w in zip(g_rows, g_nat):
            assert torch.equal(F.fully_reduce(Wf.to_native(g)), F.fully_reduce(w)), name
            assert all(v < 2 * p for v in codec.unpack(g)), name
        if passed is not None:
            for g, a in zip(g_rows, tv[:3]):
                assert torch.equal(g[:, passed], a[:, passed]), name


# ---- the MSMs and point generation --------------------------------------------------


def _check_msms(label):
    J = CURVES[label]
    T = port_params.WEIERSTRASS_CURVES[label]
    p, q = J.modulus, J.order
    W_port, W_jax = Weierstrass.create(T), JaxWeierstrass.create(J)
    F = W_port.ops.F
    C = ProjectiveCurve(J)
    oracle = lambda scs, pts: C.to_affine(msm_oracle(C, scs, [C.from_affine(pt) for pt in pts],
                                                     q.bit_length()))
    rng = np.random.default_rng(5)
    four, _ = points_with_logs(T, 4, seed=5)
    # duplicates (doubling in a bucket), a cancelling pair, infinity points
    # and zero scalars in one input
    edge_pts = [four[0], four[0], four[1], four[1], None, four[2], None, four[3]]
    edge_scs = [5, 5, 3, q - 3, 77, 0, 0, 11]
    inputs = []
    for N in (1, 8, 64):
        pts, logs = points_with_logs(T, N, seed=N)
        scs = _ints(rng, q, N)
        inputs.append((f"N={N}", pts, scs, expected_msm(T, scs, logs)))
    inputs.append(("edge", edge_pts, edge_scs, naive_msm(T, edge_scs, edge_pts)))
    modes = ("projective", "packed", "affine", "halving") + (("fma51",) if label == "pallas" else ())
    for name, pts, scs, known in inputs:
        want = oracle(scs, pts)
        assert want == known, name
        points = affine_from_jax(*(np.asarray(a) for a in W_jax.points_from_ints(pts)), F, "cpu")
        scalars = scalars_from_jax(np.asarray(W_jax.scalars_from_ints(scs)), W_port.scalar, "cpu")
        for mode in modes:
            assert W_port.result_to_int(W_port.msm(scalars, points, mode=mode)) == want, (label, name, mode)
        if name != "edge":  # msmUnsafe's contract: all effective points distinct
            assert W_port.result_to_int(W_port.msm_unsafe(scalars, points, mode="affine")) == want, name
        zs = _ints(rng, p - 1, len(pts))
        proj = [(0, 1, 0) if pt is None else (pt[0] * (z + 1) % p, pt[1] * (z + 1) % p, z + 1)
                for pt, z in zip(pts, zs)]
        ppts = proj_from_jax(*(np.asarray(a) for a in W_jax.ops.pack_projective(proj)), F, "cpu")
        assert W_port.result_to_int(W_port.msm_projective(scalars, ppts)) == want, (label, name)
    if label == "bls12-381":
        with pytest.raises(ValueError, match="255-bit ceiling"):
            W_port.msm(scalars, points, mode="fma51")


def _check_random_points():
    """The bases: the JAX oracle's for the same seed, in the prime-order
    subgroup; the lanes: the host sums of their picks, on the curve."""
    seed = 6
    for label, J in CURVES.items():
        port = Weierstrass.create(port_params.WEIERSTRASS_CURVES[label])
        oracle = AffineCurve(J)
        rows, picks = port.random_points_table(16, seed=seed)
        rng, port_rng = random.Random(seed ^ 0x9E3779B9), random.Random(seed ^ 0x9E3779B9)
        bases = [oracle.random(rng) for _ in rows]
        assert [port.oracle.random(port_rng) for _ in rows] == bases, label
        assert all(oracle.eq(row[1], b) and oracle.scale(J.order, b) is None
                   for row, b in zip(rows, bases)), label
        pts = port.random_points_fast(16, seed=seed, device="cpu")
        got = port.ops.unpack_affine(pts)
        for i in range(16):
            acc = oracle.zero
            for k, row in enumerate(rows):
                acc = oracle.add(acc, row[int(picks[k, i])])
            assert got[i] == acc, (label, i)
        assert port.ops.affine_is_on_curve(pts).all(), label


def test_new_curves_match_jax_and_oracles(monkeypatch):
    """Every check of the module docstring (one test item)."""
    _check_params()
    _check_k2(monkeypatch)
    for label in CURVES:
        _check_curve_twins(label)
    _check_fma51_kernels()
    _check_random_points()
    for label in CURVES:
        _check_msms(label)
