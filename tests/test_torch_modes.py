"""The port's halving-engine MSM modes and point generation against the JAX
package, on the CPU.

* K4m, K6, K7's twins (``proj_add_plain(mask=)``, ``proj_double_plain``,
  ``proj_add_mixed_plain``) against ``CurveKernels(..., interpret=True)`` on
  goldilocks, and against the jnp ``WeierstrassOps`` ops (``proj_add(mask=)``,
  ``proj_double``, ``proj_add_affine``) and the bigint group law on
  BLS12-377, with identity, doubling, cancellation and infinity lanes.
* ``halving_layout`` and ``_fill_runs`` against JAX: bit-exact.
* ``batch_add`` (safe and unsafe) and ``to_affine`` against JAX on 16 lanes.
* ``accumulate_buckets`` (the halving engine) and ``reduce_buckets`` on the
  integer model of ``tests/test_torch_engine.py``, against the JAX engine
  (jitted: integers compile in about a second) and a plain loop.
* Every new mode's MSM (``msm(mode="affine")``, ``msm_unsafe``,
  ``msm(mode="halving")``, ``msm_projective``, Edwards ``msm(mode="basic")``)
  at N in {1, 8, 64} and on an edge-case input against the bigint Pippenger
  oracle and the known discrete logs; inputs packed by the JAX package.
* The port's ``bigint/`` draws the JAX oracle's random bases for the same
  seed, cofactor-cleared; ``random_points_fast`` lanes equal the host sums
  of their table picks.

Tolerance: exact equality mod p of field values, bit-exact for layouts and
pass-through lanes, exact equality of affine points. No whole-MSM JAX jit:
its XLA:CPU compile takes minutes.

ONE test item: the CPU suite's wall time follows its item count (the replay
of pytest-xdist's scheduler in ``PERF.md`` chose it). The CUDA kernels
themselves run on the card in ``tests/test_torch_cuda.py``.
"""

import random
import types
from typing import NamedTuple

import numpy as np
import torch

import jax
import jax.numpy as jnp

import msm_zprize_tpu.msm.common as JC
import msm_zprize_tpu.msm.engine as JE
from msm_zprize_tpu.bigint.edwards import EdwardsCurve
from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.bigint.weierstrass import AffineCurve, ProjectiveCurve
from msm_zprize_tpu.curves import pallas_curve as pc
from msm_zprize_tpu.curves.example_fields import EXAMPLE_FIELDS
from msm_zprize_tpu.curves.params import BLS12_377, ED_ON_BLS12_377
from msm_zprize_tpu.curves.weierstrass import AffinePoints as JaxAffine
from msm_zprize_tpu.curves.weierstrass import ProjectivePoints as JaxProj
from msm_zprize_tpu.parallel.api import TwistedEdwards as JaxTwistedEdwards
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch.counters import COUNTS
from msm_zprize_tpu_torch.curves import cuda_curve
from msm_zprize_tpu_torch.curves import params as port_params
from msm_zprize_tpu_torch.curves.weierstrass import ProjectivePoints
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.msm import common as TC
from msm_zprize_tpu_torch.msm import engine as TE
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
from msm_zprize_tpu_torch.testing.points import (
    ed_expected_msm, ed_naive_msm, ed_points_with_logs, expected_msm, naive_msm, points_with_logs,
)
from msm_zprize_tpu_torch.utils.convert import (
    affine_from_jax, ext_from_jax, proj_from_jax, scalars_from_jax,
)

torch.set_num_threads(1)

P = BLS12_377.modulus
Q = BLS12_377.order
B = 8


def _values(F, arrs):
    return [F.unpack(np.asarray(a)) for a in arrs]


def _t(arrs):
    return [torch.as_tensor(np.asarray(a)) for a in arrs]


def _rand_z(rng):
    return int.from_bytes(rng.bytes(48), "little") % P or 1


# ---- K4m, K6, K7 twins ---------------------------------------------------------


def _check_twins_vs_tpu_kernels():
    """Against CurveKernels(interpret=True) on goldilocks (the formulas are
    polynomial identities, so arbitrary field values compare)."""
    p = EXAMPLE_FIELDS["goldilocks"]
    F = make_field(p)
    b3 = 9
    W = types.SimpleNamespace(F=F, b3_mont=b3 * F.R % p, b3_small=b3, storage=cuda_curve.Storage(F.n))
    kern = pc.CurveKernels(p, F.w, F.n, b3 * F.R % p, b3, interpret=True)
    rng = np.random.default_rng(11)
    vals = [F.pack([int(v) for v in rng.integers(0, p, size=B, dtype=np.uint64)]) for _ in range(6)]
    flag = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
    tv, jv = _t(vals), [jnp.asarray(v) for v in vals]
    cases = {
        "K4m": (cuda_curve.proj_add_plain(W, *tv, mask=torch.as_tensor(flag)),
                kern.proj_add(*jv, mask=jnp.asarray(flag)), flag == 0),
        "K6": (cuda_curve.proj_double_plain(W, *tv[:3]), kern.proj_double(*jv[:3]), None),
        "K7": (cuda_curve.proj_add_mixed_plain(W, *tv[:5], torch.as_tensor(flag)),
               kern.proj_add_mixed(*jv[:5], jnp.asarray(flag)), flag == 1),
    }
    for name, (got, want, passed) in cases.items():
        assert _values(F, got) == _values(F, want), name
        if passed is not None:  # pass-through lanes: P1's limbs, bit for bit
            for g, a in zip(got, vals[:3]):
                assert np.array_equal(g.numpy()[:, passed], a[:, passed]), name


def _check_twins_vs_jax_ops(W, J):
    """Against the jnp WeierstrassOps ops and the bigint group law on
    BLS12-377: identity, doubling and cancelling lanes, infinity in K7."""
    F = W.F
    rng = np.random.default_rng(12)
    pts, _ = points_with_logs(BLS12_377, 2 * B, seed=12)
    proj = [(x * z % P, y * z % P, z) for (x, y), z in zip(pts, (_rand_z(rng) for _ in pts))]
    Ps, Qs = proj[:B], proj[B:]
    Ps[1] = (0, 1, 0)
    Qs[2] = Ps[2]
    Qs[3] = (Ps[3][0], (-Ps[3][1]) % P, Ps[3][2])
    C = ProjectiveCurve(BLS12_377)
    aff = list(pts[B:])
    aff[2] = C.to_affine(Ps[2])                     # P + P
    aff[3] = C.to_affine(C.neg(Ps[3]))              # P + (-P)
    aff[4] = None                                   # P + infinity
    mask = np.array([1, 1, 1, 1, 0, 1, 0, 1], np.int32)
    a = [F.pack([pt[i] for pt in Ps]) for i in range(3)]
    b = [F.pack([pt[i] for pt in Qs]) for i in range(3)]
    A = W.pack_affine(aff, "cpu")

    def fn(a, b, A, m):
        Pa = JaxProj(*a)
        return J.proj_add(Pa, JaxProj(*b), mask=m), J.proj_double(Pa), J.proj_add_affine(Pa, JaxAffine(*A))

    tree = (tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)),
            tuple(jnp.asarray(x.numpy()) for x in A), jnp.asarray(mask) == 1)
    j_add, j_dbl, j_mix = jax.jit(fn)(*tree)
    Pt, Qt = ProjectivePoints(*_t(a)), ProjectivePoints(*_t(b))
    got_add = W.proj_add(Pt, Qt, mask=torch.as_tensor(mask))
    got_dbl = W.proj_double(Pt)
    got_mix = W.proj_add_affine(Pt, A)
    assert _values(F, got_add) == _values(F, j_add)
    assert _values(F, got_dbl) == _values(F, j_dbl)
    assert _values(F, got_mix) == _values(F, j_mix)
    for g, x in zip(got_add, Pt):  # masked-off lanes are P1 bit for bit
        assert torch.equal(g[:, mask == 0], x[:, mask == 0])
    for g, x in zip(got_mix, Pt):  # so are infinity lanes of K7
        assert torch.equal(g[:, 4], x[:, 4])
    for i in range(B):
        want = C.add(Ps[i], Qs[i]) if mask[i] else Ps[i]
        assert C.eq(W.unpack_projective(got_add)[i], want), i
        assert C.eq(W.unpack_projective(got_dbl)[i], C.double(Ps[i])), i
        assert C.eq(W.unpack_projective(got_mix)[i], C.add(Ps[i], C.from_affine(aff[i]))), i
    # proj_sub, proj_eq, proj_scale_const (K6 + K4) and the curve predicates
    assert W.proj_eq(W.proj_sub(W.proj_add(Pt, Qt), Qt), Pt).all()
    assert W.proj_eq(W.proj_scale_const(5, Pt), ProjectivePoints(*W.pack_projective(
        [C.scale(5, pt) for pt in Ps], "cpu"))).all()
    assert W.proj_is_on_curve(Pt).all() and W.affine_is_on_curve(A).all()
    bad = ProjectivePoints(Pt.X, F.add(Pt.Y, F.ones_mont(B, device="cpu")), Pt.Z)
    assert W.proj_is_on_curve(bad).tolist() == [i == 1 for i in range(B)]  # identity passes
    assert W.unpack_affine(W.to_affine(got_dbl))[1] is None


# ---- halving layout --------------------------------------------------------------


def _check_layout_vs_jax():
    rng = np.random.default_rng(13)
    layout = jax.jit(JC.halving_layout, static_argnums=(1, 2))
    for K, L, B_, dist in ((3, 8, 64, "uniform"), (2, 16, 64, "one_bucket"), (4, 32, 100, "sparse"),
                           (1, 8, 1, "uniform")):
        ids = {"uniform": lambda: rng.integers(0, L + 1, (K, B_)),
               "one_bucket": lambda: np.full((K, B_), 3),
               "sparse": lambda: rng.choice([0, 5, L - 1, L], (K, B_))}[dist]()
        counts = np.stack([np.bincount(r, minlength=L + 1)[:L] for r in ids]).astype(np.int32)
        width, cur = B_, counts
        for _ in range(2):  # the first levels of the engine's schedule
            nxt = max((width + L) // 2 + 1, 1)
            got = TC.halving_layout(torch.as_tensor(cur), nxt, width)
            want = layout(jnp.asarray(cur), nxt, width)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w)), (K, L, dist)
            width, cur = nxt, got[3].numpy()
        starts = np.cumsum(counts, axis=1) - counts
        vals = np.sort(rng.integers(0, 50, (K, L)), axis=1).astype(np.int32)
        for kind, v in (("max", vals), ("min", vals[:, ::-1].copy())):
            got = TC._fill_runs(torch.as_tensor(v), torch.as_tensor(starts.astype(np.int32)), B_, kind)
            want = JC._fill_runs(jnp.asarray(v), jnp.asarray(starts.astype(np.int32)), B_, kind)
            assert np.array_equal(got.numpy(), np.asarray(want)), (kind, dist)


# ---- batch_add and to_affine -------------------------------------------------------


def _check_batch_add_vs_jax(W, J):
    """16 lanes: generic, doubling, cancellation, P or Q or both at infinity,
    and inactive lanes whose garbage (x1 == x2, y1 = -y2 = 0) would poison
    an unmasked inversion. Unsafe adds take the generic and infinity lanes."""
    F = W.F
    A = AffineCurve(BLS12_377)
    pts, _ = points_with_logs(BLS12_377, 32, seed=14)
    Ps, Qs = list(pts[:16]), list(pts[16:])
    Qs[1] = Ps[1]                                   # doubling
    Qs[2] = A.neg(Ps[2])                            # cancellation
    Ps[3] = None                                    # P infinite
    Qs[4] = None                                    # Q infinite
    Ps[5] = Qs[5] = None                            # both
    active = np.ones(16, bool)
    active[6:8] = False
    Pb, Qb = W.pack_affine(Ps, "cpu"), W.pack_affine(Qs, "cpu")
    Pb.x[:, 6:8] = Qb.x[:, 6:8]                     # garbage lanes: equal x, y = 0
    Pb.y[:, 6:8] = 0
    Qb.y[:, 6:8] = 0
    safe_lanes = active
    unsafe_lanes = active & ~np.isin(np.arange(16), [1, 2])
    R = W.proj_add(W.from_affine(Pb), W.from_affine(Qb))

    def fn(Pj, Qj, act, act_u, Rj):
        Pj, Qj = JaxAffine(*Pj), JaxAffine(*Qj)
        return (J.batch_add(Pj, Qj, safe=True, active=act), J.batch_add(Pj, Qj, safe=False, active=act_u),
                J.to_affine(JaxProj(*Rj)))

    js = lambda pt: tuple(jnp.asarray(a.numpy()) for a in pt)
    j_safe, j_unsafe, j_aff = jax.jit(fn)(js(Pb), js(Qb), jnp.asarray(safe_lanes),
                                          jnp.asarray(unsafe_lanes), js(R))
    got_safe = W.batch_add(Pb, Qb, safe=True, active=torch.as_tensor(safe_lanes))
    got_unsafe = W.batch_add(Pb, Qb, safe=False, active=torch.as_tensor(unsafe_lanes))
    for got, want, lanes in ((got_safe, j_safe, safe_lanes), (got_unsafe, j_unsafe, unsafe_lanes)):
        assert np.array_equal(got.inf.numpy()[lanes], np.asarray(want.inf)[lanes])
        for g, w in zip(_values(F, got[:2]), _values(F, want[:2])):
            assert [v for v, a in zip(g, lanes) if a] == [v for v, a in zip(w, lanes) if a]
        for i in np.flatnonzero(lanes):
            assert W.unpack_affine(got)[i] == A.add(Ps[i], Qs[i]), i
    got_aff = W.to_affine(R)
    assert np.array_equal(got_aff.inf.numpy(), np.asarray(j_aff.inf))
    assert _values(F, got_aff[:2]) == _values(F, j_aff[:2])


# ---- the halving engine and the sequential reduction, integer model ------------------


class _Pt(NamedTuple):
    v: object


MOD = 65521


def _check_engine_vs_jax():
    for K, B_, L, dist in ((3, 64, 8, "uniform"), (2, 64, 16, "all_equal"), (2, 64, 16, "top_heavy"),
                           (5, 100, 16, "uniform"), (1, 1, 8, "uniform"), (2, 2048, 32, "uniform")):
        rng = np.random.default_rng(K * 1000 + B_ + L)
        digits = {"uniform": lambda: rng.integers(0, L + 1, (K, B_)),
                  "all_equal": lambda: np.full((K, B_), 3),
                  "top_heavy": lambda: rng.integers(0, 3, (K, B_))}[dist]().astype(np.int32)
        signs = np.where(digits == 0, 0, rng.integers(0, 2, (K, B_))).astype(np.int32)
        vals = rng.integers(1, 1000, (B_,)).astype(np.int32)

        before = COUNTS["host_sync"]
        sums, empty = TE.accumulate_buckets(
            _Pt(torch.as_tensor(vals)), torch.as_tensor(digits), torch.as_tensor(signs), L,
            lambda a, b, hp, v: TE.select(hp, _Pt(a.v + b.v), a),
            lambda a, sg: _Pt(torch.where(sg.bool(), -a.v, a.v)),
            lambda K_, L_: _Pt(torch.zeros((K_, L_), dtype=torch.int32)),
        )
        syncs = COUNTS["host_sync"] - before

        @jax.jit
        def jax_side(d, s, v):
            return JE.accumulate_buckets(
                _Pt(v), d, s, L,
                lambda a, b, hp, valid: JE._select(hp, _Pt(a.v + b.v), a),
                lambda a, sg: _Pt(jnp.where(sg, -a.v, a.v)),
                lambda K_, L_: _Pt(jnp.zeros((K_, L_), jnp.int32)),
            )

        j_sums, j_empty = jax_side(jnp.asarray(digits), jnp.asarray(signs), jnp.asarray(vals))
        want = np.zeros((K, L), np.int64)
        for k in range(K):
            for i in range(B_):
                if digits[k, i]:
                    want[k, digits[k, i] - 1] += (-1 if signs[k, i] else 1) * int(vals[i])
        assert np.array_equal(sums.v.numpy(), want) and np.array_equal(np.asarray(j_sums.v), want), dist
        assert np.array_equal(empty.numpy(), np.asarray(j_empty))
        counts = np.stack([np.bincount(r, minlength=L + 1)[1:] for r in digits])
        assert np.array_equal(empty.numpy(), counts == 0)
        assert syncs <= max((B_ - 1).bit_length(), 0), syncs  # the plateau's bound

    # reduce_buckets (acc + bucket: the mask is the mixed add's infinity flag,
    # which the integer model's zero buckets stand for) then Horner
    class Acc:
        def __init__(self, xp):
            self.xp = xp

        def zero(self, *batch):
            return _Pt(self.xp.zeros((1,) + batch, dtype=self.xp.int32))

        def add_point(self, acc, pt, nonempty):
            return _Pt((acc.v + pt.v) % MOD)

        def add(self, a, b):
            return _Pt((a.v + b.v) % MOD)

        def double(self, a):
            return _Pt((a.v << 1) % MOD)

        def double_k(self, a, k):
            return _Pt((a.v << k) % MOD)

    for K, c in ((3, 4), (11, 6), (2, 1)):
        L = 1 << (c - 1)
        c0 = max((c - 1) // 2, 1)
        rng = np.random.default_rng(K + c)
        buckets = rng.integers(0, MOD, (1, K, L)).astype(np.int32)
        empty = rng.integers(0, 2, (K, L)).astype(bool)
        buckets[0][empty] = 0
        t_acc = Acc(torch)
        t_win = TE.reduce_buckets(_Pt(torch.as_tensor(buckets)), torch.as_tensor(empty), c0, t_acc)
        t_res = TE.horner(t_win, c, t_acc.add, t_acc.double_k)

        @jax.jit
        def jax_side(b, e):
            j_acc = Acc(jnp)
            j_win = JE.reduce_buckets(_Pt(b), e, c0, j_acc)
            return j_win, JE.horner(j_win, c, j_acc.add, j_acc.double, None, double_k=j_acc.double_k)

        j_win, j_res = jax_side(jnp.asarray(buckets), jnp.asarray(empty))
        weights = np.arange(1, L + 1, dtype=object)
        S = [int((buckets[0, k].astype(object) * weights).sum()) % MOD for k in range(K)]
        assert t_win.v.numpy()[0].tolist() == np.asarray(j_win.v)[0].tolist() == S
        total = sum(pow(2, k * c, MOD) * s for k, s in enumerate(S)) % MOD
        assert t_res.v.numpy().tolist() == np.asarray(j_res.v).tolist() == [[total]]


# ---- the MSMs ---------------------------------------------------------------------


def _ints(rng, bound, count):
    return [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(count)]


def _check_weierstrass_msms(W_port, W_jax):
    F = W_port.ops.F
    C = ProjectiveCurve(BLS12_377)
    oracle = lambda scs, pts: C.to_affine(msm_oracle(C, scs, [C.from_affine(p) for p in pts], Q.bit_length()))
    rng = np.random.default_rng(15)
    three, _ = points_with_logs(BLS12_377, 4, seed=15)
    # duplicates (doubling in a bucket), a cancelling pair, infinity points
    # and zero scalars in one input
    edge_pts = [three[0], three[0], three[1], three[1], None, three[2], None, three[3]]
    edge_scs = [5, 5, 3, Q - 3, 77, 0, 0, 11]
    inputs = []
    for N in (1, 8, 64):
        pts, logs = points_with_logs(BLS12_377, N, seed=N)
        scs = _ints(rng, Q, N)
        inputs.append((f"N={N}", pts, scs, expected_msm(BLS12_377, scs, logs)))
    inputs.append(("edge", edge_pts, edge_scs, naive_msm(BLS12_377, edge_scs, edge_pts)))
    for name, pts, scs, known in inputs:
        want = oracle(scs, pts)
        assert want == known, name
        jp = W_jax.points_from_ints(pts)
        points = affine_from_jax(*(np.asarray(a) for a in jp), F, "cpu")
        scalars = scalars_from_jax(np.asarray(W_jax.scalars_from_ints(scs)), W_port.scalar, "cpu")
        for mode in ("affine", "halving"):
            assert W_port.result_to_int(W_port.msm(scalars, points, mode=mode)) == want, (name, mode)
        if name != "edge":  # msmUnsafe's contract: all effective points distinct
            assert W_port.result_to_int(W_port.msm_unsafe(scalars, points, mode="affine")) == want, name
        # msm_projective on the same points with random Z (Z = 0 at infinity)
        zs = [_rand_z(rng) for _ in pts]
        proj = [(0, 1, 0) if pt is None else (pt[0] * z % P, pt[1] * z % P, z) for pt, z in zip(pts, zs)]
        jpp = W_jax.ops.pack_projective(proj)
        ppts = proj_from_jax(*(np.asarray(a) for a in jpp), F, "cpu")
        assert W_port.result_to_int(W_port.msm_projective(scalars, ppts)) == want, name
    unsafe_edge = ([three[0], None, three[1], three[2]], [9, 4, 0, 6])
    assert W_port.result_to_int(W_port.msm_unsafe(
        W_port.scalars_from_ints(unsafe_edge[1], "cpu"), W_port.points_from_ints(unsafe_edge[0], "cpu"),
        mode="affine")) == oracle(unsafe_edge[1], unsafe_edge[0])


def _check_edwards_msms(E_port, E_jax):
    Qe = ED_ON_BLS12_377.order
    C = EdwardsCurve(ED_ON_BLS12_377)
    oracle = lambda scs, pts: C.to_affine(msm_oracle(C, scs, [C.from_affine(p) for p in pts], Qe.bit_length()))
    rng = np.random.default_rng(16)
    params = port_params.ED_ON_BLS12_377
    three, _ = ed_points_with_logs(params, 4, seed=16)
    edge_pts = [three[0], three[0], three[1], three[1], (0, 1), three[2], (0, 1), three[3]]
    edge_scs = [5, 5, 3, Qe - 3, 77, 0, 0, 11]
    inputs = []
    for N in (1, 8, 64):
        pts, logs = ed_points_with_logs(params, N, seed=N)
        scs = _ints(rng, Qe, N)
        inputs.append((f"N={N}", pts, scs, ed_expected_msm(params, scs, logs)))
    inputs.append(("edge", edge_pts, edge_scs, ed_naive_msm(params, edge_scs, edge_pts)))
    for name, pts, scs, known in inputs:
        want = oracle(scs, pts)
        assert want == known, name
        jp = E_jax.points_from_ints(pts)
        points = ext_from_jax(*(np.asarray(a) for a in jp), E_port.ops.F, "cpu")
        scalars = scalars_from_jax(np.asarray(E_jax.scalars_from_ints(scs)), E_port.scalar, "cpu")
        assert E_port.result_to_int(E_port.msm(scalars, points, mode="basic")) == want, name


# ---- random points -----------------------------------------------------------------


def _check_random_points(W_port, E_port):
    """The bases: the JAX oracle's for the same seed, in the prime-order
    subgroup; the device lanes: the host sums of their picks."""
    seed = 5
    for port, oracle, in_subgroup in (
        (W_port, AffineCurve(BLS12_377), lambda O, b: O.scale(Q, b) is None),
        (E_port, EdwardsCurve(ED_ON_BLS12_377),
         lambda O, b: O.is_zero(O.scale(ED_ON_BLS12_377.order, b))),
    ):
        rows, picks = port.random_points_table(16, seed=seed)
        K = len(rows)
        rng, port_rng = random.Random(seed ^ 0x9E3779B9), random.Random(seed ^ 0x9E3779B9)
        bases = [oracle.random(rng) for _ in range(K)]
        assert [port.oracle.random(port_rng) for _ in range(K)] == bases, port.label
        assert all(oracle.eq(row[1], b) for row, b in zip(rows, bases)), port.label
        assert all(in_subgroup(oracle, b) for b in bases), port.label
        pts = port.random_points_fast(16, seed=seed, device="cpu")
        for i in range(16):
            acc = oracle.zero
            for k, row in enumerate(rows):
                acc = oracle.add(acc, row[int(picks[k, i])])
            if port is W_port:
                assert port.ops.unpack_affine(pts)[i] == acc, i
            else:
                assert port.result_to_int(type(pts)(*(a[:, i:i + 1] for a in pts))) == oracle.to_affine(acc)
        on_curve = port.ops.affine_is_on_curve(pts) if port is W_port else port.ops.is_on_curve(pts)
        assert on_curve.all(), port.label


def test_modes_match_jax_and_oracles():
    """Every module of the slice against its JAX counterpart or the bigint
    oracle (one test item; see the module docstring)."""
    W_port, W_jax = Weierstrass.create(port_params.BLS12_377), JaxWeierstrass.create(BLS12_377)
    E_port, E_jax = TwistedEdwards.create(port_params.ED_ON_BLS12_377), JaxTwistedEdwards.create(ED_ON_BLS12_377)
    _check_twins_vs_tpu_kernels()
    _check_twins_vs_jax_ops(W_port.ops, W_jax.ops)
    _check_layout_vs_jax()
    _check_batch_add_vs_jax(W_port.ops, W_jax.ops)
    _check_engine_vs_jax()
    _check_random_points(W_port, E_port)
    _check_weierstrass_msms(W_port, W_jax)
    _check_edwards_msms(E_port, E_jax)
