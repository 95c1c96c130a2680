"""The port's bigint layer, testing harness and phase counts against the JAX
package, on the CPU.

* ``bigint/``: the field functions (every ``EXAMPLE_FIELDS`` modulus,
  ``montgomery_params`` against ``MontgomeryFp``'s n and R), the affine and
  projective Weierstrass oracles and the Edwards oracle (group law, the
  same ``random`` draws, ``eq`` / ``neg`` / ``sub`` / ``is_on_curve`` /
  ``is_in_subgroup``), the GLV basis and split (``fields/scalar.py::
  glv_basis`` reads the one derivation), and ``msm`` / ``msm_naive`` against
  JAX ``bigint/msm.py`` on N = 8 points of each curve: exact equality.
* ``testing/``: ``Random``'s samples for one seed, ``test_property`` (its
  budget, its failure report, ``negative``) and ``equivalent`` in the four
  cases of ``tests/test_equivalence_harness.py``, as loops, on CPU tensors
  (the plain twins): the field ops on ed25519, secp256k1, goldilocks and
  babybear, inverse(0) throwing on one side only, the negative property,
  the generator combinators.
* ``utils/phases.py``'s product counts against JAX ``phases.py:101-117``
  restated, its table on the CPU, and ``utils/timing.py``'s ``Log``.

Three test items (the suite's wall time follows its item count).
"""

import io
import math
import random
from dataclasses import astuple

import pytest
import torch

import msm_zprize_tpu.bigint.edwards as jax_be
import msm_zprize_tpu.bigint.field as jax_bf
import msm_zprize_tpu.bigint.glv as jax_glv
import msm_zprize_tpu.bigint.msm as jax_msm
import msm_zprize_tpu.bigint.weierstrass as jax_bw
from msm_zprize_tpu.curves import params as jax_params
from msm_zprize_tpu.testing import Random as JaxRandom
from msm_zprize_tpu_torch.bigint import edwards as be
from msm_zprize_tpu_torch.bigint import field as bf
from msm_zprize_tpu_torch.bigint import glv as bglv
from msm_zprize_tpu_torch.bigint import msm as bmsm
from msm_zprize_tpu_torch.bigint import weierstrass as bw
from msm_zprize_tpu_torch.curves import params as port_params
from msm_zprize_tpu_torch.curves.example_fields import EXAMPLE_FIELDS
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.fields.scalar import glv_basis
from msm_zprize_tpu_torch.msm.common import default_windows
from msm_zprize_tpu_torch.msm.engine import slot_count
from msm_zprize_tpu_torch.parallel.api import Weierstrass
from msm_zprize_tpu_torch.testing import Random, Spec, equivalent
from msm_zprize_tpu_torch.testing import test_property as run_property
from msm_zprize_tpu_torch.testing.equivalent import field_spec, id_spec, scalar_spec
from msm_zprize_tpu_torch.utils import phases
from msm_zprize_tpu_torch.utils.timing import Log, tic_toc, wait_for

torch.set_num_threads(1)

WEIER = ("BLS12_377", "BLS12_381", "PALLAS")


def test_bigint_layer_matches_jax():
    """Field, curve, GLV and MSM oracles of the port equal the JAX package's."""
    rng = random.Random(7)
    for name, p in EXAMPLE_FIELDS.items():
        xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(6)]
        for x in xs:
            assert bf.is_square(x, p) == jax_bf.is_square(x, p), name
            assert bf.sqrt(x, p) == jax_bf.sqrt(x, p), name
            assert bf.field_exp(x, 12345, p) == jax_bf.field_exp(x, 12345, p)
            assert bf.egcd(x, p) == jax_bf.egcd(x, p) and bf.mod(x + p, p) == jax_bf.mod(x + p, p)
            if x:
                assert bf.inverse(x, p) == jax_bf.inverse(x, p)
        with pytest.raises(ZeroDivisionError):
            bf.inverse(p, p)
        assert bf.two_adicity(p) == jax_bf.two_adicity(p), name
        assert bf.roots_of_unity(p) == jax_bf.roots_of_unity(p), name
        for w, extra in ((12, 2), (12, 4), (16, 2), (29, 3)):
            assert astuple(bf.montgomery_params(p, w, extra)) == astuple(
                jax_bf.montgomery_params(p, w, extra))
        mp = bf.montgomery_params(p, 12, 4)
        F = make_field(p)
        assert (mp.n, mp.R, mp.R_mod_p, mp.R2) == (F.n, F.R, F.mont_one, F.R2), name
        assert bf.to_limbs(p, 12, mp.n) == jax_bf.to_limbs(p, 12, mp.n) == mp.limbs_p
        assert bf.from_limbs(mp.limbs_2p, 12) == jax_bf.from_limbs(mp.limbs_2p, 12) == 2 * p
        r1, r2 = random.Random(3), random.Random(3)
        assert bf.random_fields(p, 5, r1) == jax_bf.random_fields(p, 5, r2)
        Fp, Fj = bf.Field(p), jax_bf.Field(p)
        a, b = xs[-2:]
        for op in ("add", "sub", "mul"):
            assert getattr(Fp, op)(a, b) == getattr(Fj, op)(a, b)
        assert (Fp.square(a), Fp.neg(a), Fp.inv(a), Fp.exp(a, 7), Fp.sqrt(a), Fp.is_square(a),
                Fp.mod(a + p), Fp.bit_length) == (
                Fj.square(a), Fj.neg(a), Fj.inv(a), Fj.exp(a, 7), Fj.sqrt(a), Fj.is_square(a),
                Fj.mod(a + p), Fj.bit_length)
    assert bf.next_prime(90) == 97 and bf.is_probable_prime(97) and not bf.is_probable_prime(91)

    for curve in WEIER:
        P, J = getattr(port_params, curve), getattr(jax_params, curve)
        A, JA = bw.AffineCurve(P), jax_bw.AffineCurve(J)
        C, JC = bw.ProjectiveCurve(P), jax_bw.ProjectiveCurve(J)
        r1, r2 = random.Random(11), random.Random(11)
        pts = [A.random(r1) for _ in range(3)]
        assert pts == [JA.random(r2) for _ in range(3)], curve
        proj = [C.random(r1) for _ in range(3)]
        assert proj == [JC.random(r2) for _ in range(3)], curve
        P0, P1, P2 = pts
        assert A.add(P0, P1) == JA.add(P0, P1) and A.double(P2) == JA.double(P2)
        assert A.neg(P0) == JA.neg(P0) and A.add(P0, A.neg(P0)) is None
        assert A.endomorphism(P0) == JA.endomorphism(P0) == A.scale(P.lambda_, P0)
        assert A.is_in_subgroup(P0) and A.is_on_curve(P0) and A.is_zero(None) and A.eq(P0, P0)
        Q0, Q1, Q2 = proj
        for got, want in ((C.add(Q0, Q1), JC.add(Q0, Q1)), (C.double(Q2), JC.double(Q2)),
                          (C.sub(Q0, Q1), JC.sub(Q0, Q1)), (C.scale(12345, Q0), JC.scale(12345, Q0)),
                          (C.add(Q0, C.neg(Q0)), JC.add(Q0, JC.neg(Q0))), (C.add(Q1, Q1), JC.double(Q1))):
            assert got == want and C.is_on_curve(got), curve
        assert C.eq(C.from_affine(C.to_affine(Q0)), Q0) and not C.eq(Q0, Q1)
        assert C.to_affine(Q2) == JC.to_affine(Q2) and C.is_zero(C.zero) and C.to_affine(C.zero) is None
        g = bglv.glv_params(P.order, P.lambda_)
        assert astuple(g) == astuple(jax_glv.glv_params(J.order, J.lambda_))
        assert glv_basis(P.order, P.lambda_) == ((g.v00, g.v01), (g.v10, g.v11), g.det, g.max_bits)
        assert bglv.egcd_stop_early(P.lambda_, P.order) == jax_glv.egcd_stop_early(J.lambda_, J.order)
        for s in [0, 1, P.order - 1] + [rng.randrange(P.order) for _ in range(8)]:
            assert bglv.decompose(s, g) == jax_glv.decompose(s, g), (curve, s)
        scs = [rng.randrange(P.order) for _ in range(8)]
        pts8 = [C.from_affine(A.random(rng)) for _ in range(8)]
        want = JC.to_affine(jax_msm.msm(JC, scs, pts8, P.order.bit_length()))
        assert C.to_affine(bmsm.msm(C, scs, pts8, P.order.bit_length())) == want, curve
        assert C.to_affine(bmsm.msm(C, scs, pts8, P.order.bit_length(), c=3)) == want, curve
        assert C.to_affine(bmsm.msm_naive(C, scs, pts8)) == want, curve

    P, J = port_params.ED_ON_BLS12_377, jax_params.ED_ON_BLS12_377
    E, JE = be.EdwardsCurve(P), jax_be.EdwardsCurve(J)
    r1, r2 = random.Random(13), random.Random(13)
    pts = [E.random(r1) for _ in range(8)]
    assert pts == [JE.random(r2) for _ in range(8)]
    a, b = pts[:2]
    assert E.add(a, b) == JE.add(a, b) and E.sub(a, b) == JE.sub(a, b) and E.neg(a) == JE.neg(a)
    assert E.is_on_curve(a) and E.is_in_subgroup(a) and E.eq(E.double(a), E.add(a, a))
    assert not E.is_on_curve((a[0] + 1, *a[1:])) and E.is_zero(E.sub(a, a))
    scs = [rng.randrange(P.order) for _ in range(8)]
    want = JE.to_affine(jax_msm.msm(JE, scs, pts, P.order.bit_length()))
    assert E.to_affine(bmsm.msm(E, scs, pts, P.order.bit_length())) == want
    assert E.to_affine(bmsm.msm_naive(E, scs, pts)) == want


def test_harness_matches_jax():
    """Random's samples, the property runner and the equivalence harness:
    the JAX harness test's four cases, on CPU tensors."""
    p = EXAMPLE_FIELDS["goldilocks"]
    gens = {
        "field": lambda R: R.field(p), "invalid": lambda R: R.field(p).invalid,
        "x2": lambda R: R.fieldx2(p), "x4": lambda R: R.fieldx4(p),
        "bits": lambda R: R.biguint(70), "special": lambda R: R.special(p),
        "array": lambda R: R.array(R.int_range(3, 9), lambda rng: rng.randrange(1, 4)),
        "record": lambda R: R.record(a=R.constant(5), b=R.tuple_(R.int_range(0, 3), R.field(97))),
        "one_of": lambda R: R.one_of(R.constant("a"), R.field(11).map(str)),
    }
    for name, make in gens.items():
        r1, r2 = random.Random(21), random.Random(21)
        got, want = make(Random), make(JaxRandom)
        assert [got(r1) for _ in range(20)] == [want(r2) for _ in range(20)], name
    with pytest.raises(ValueError, match="no invalid variant"):
        Random.fieldx2(p).invalid

    seen = []
    run_property(Random.field(97), seed=3, min_runs=5, max_runs=5)(lambda x: seen.append(x))
    assert len(seen) == 5 and seen == [random.Random(3).randrange(97) for _ in range(1)] + seen[1:]
    with pytest.raises(AssertionError, match="property failed; inputs"):
        run_property(Random.field(97), min_runs=3, max_runs=3)(lambda x: (_ for _ in ()).throw(
            AssertionError("no")))

    # case 1: field ops on the four fields no other harness test covers
    for name in ("ed25519-fp", "secp256k1-fp", "goldilocks", "babybear"):
        q = EXAMPLE_FIELDS[name]
        F = make_field(q)
        spec = field_spec(F, Random.field(q), batch=4, device="cpu")
        runs = dict(min_runs=8, max_runs=8)
        equivalent(frm=[spec, spec], to=spec, label=f"{name} mul", **runs)(
            lambda a, b: a * b % q, F.montmul)
        equivalent(frm=[spec, spec], to=spec, label=f"{name} add", **runs)(
            lambda a, b: (a + b) % q, F.add)
        equivalent(frm=[spec, spec], to=spec, label=f"{name} sub", **runs)(
            lambda a, b: (a - b) % q, F.sub)
        equivalent(frm=[spec], to=spec, label=f"{name} inverse", min_runs=4, max_runs=4)(
            lambda a: bf.inverse(a, q), F.inverse)
    # a wrong implementation is caught
    F = make_field(EXAMPLE_FIELDS["babybear"])
    spec = field_spec(F, Random.field(F.p), device="cpu")
    with pytest.raises(AssertionError, match="property failed"):
        equivalent(frm=[spec, spec], to=spec, min_runs=4, max_runs=4)(
            lambda a, b: (a + b) % F.p, F.sub)

    # case 2: must throw together. inverse(0) returns 0 on the port's side
    zero = Spec(lambda rng: 0, spec.there, spec.back)
    with pytest.raises(AssertionError, match="property failed"):
        equivalent(frm=[zero], to=spec, label="inv0", min_runs=1, max_runs=1)(
            lambda a: pow(a, -1, F.p), F.inverse)
    # both throwing is agreement
    equivalent(frm=[zero], to=spec, min_runs=1, max_runs=1)(
        lambda a: bf.inverse(a, F.p), lambda x: bf.inverse(0, F.p))
    S = Weierstrass.create(port_params.BLS12_377).simple_scalar
    sspec = scalar_spec(S, Random.field(S.q), batch=3, device="cpu")
    equivalent(frm=[sspec], to=sspec, min_runs=4, max_runs=4)(lambda s: s, lambda t: t)
    equivalent(frm=[id_spec(Random.biguint(8))], to=id_spec(), min_runs=4, max_runs=4)(
        lambda v: v + 1, lambda v: v + 1)

    # case 3: test.negative
    g = EXAMPLE_FIELDS["goldilocks"]
    run_property(Random.field(g).invalid, min_runs=10, max_runs=10, negative=True)(
        lambda x: (_ for _ in ()).throw(AssertionError()) if x >= g else None)
    with pytest.raises(AssertionError, match="negative property held"):
        run_property(Random.field(g), min_runs=10, max_runs=10, negative=True)(lambda x: None)

    # case 4: the combinators
    rng = random.Random(0)
    v = Random.record(xs=Random.array(Random.biguint(16), 3),
                      t=Random.tuple_(Random.constant(7), Random.int_range(1, 5)),
                      e=Random.one_of(Random.constant("a"), Random.constant("b")))(rng)
    assert len(v["xs"]) == 3 and all(0 <= x < 65536 for x in v["xs"])
    assert v["t"][0] == 7 and 1 <= v["t"][1] < 5 and v["e"] in ("a", "b")
    vals = {Random.special(97)(rng) for _ in range(200)}
    assert 0 in vals and 96 in vals


def test_phase_counts_and_timing_log():
    """utils/phases.py's product counts equal JAX phases.py:101-117
    restated; its table on CPU tensors; Log's tic / toc / span / lines."""
    for N, max_bits, c in ((1 << 16, 128, 12), (1 << 10, 129, 8), (8, 130, 6), (1 << 20, 128, 13)):
        K = default_windows(max_bits, c)
        L = 1 << (c - 1)
        M = slot_count(2 * N, L)
        slots = M * K * L
        m_prep = N / 1e6
        m_accum = (9 * (slots // 2) + 12 * (slots // 2 - K * L) + 12 * K * L
                   + 12 * (L // 2) * K * math.ceil(math.log2(max(L, 2)))) / 1e6
        c0 = max((c - 1) // 2, 1)
        block = 1 << c0
        D = L // block
        m_fin = ((12 + 12) * block * K * D + 12 * (D + 2 * c0) * K + (K - 1) * (8 * c + 12)) / 1e6
        got = phases.mul_counts(N, max_bits, c)
        assert got["prep"] == m_prep and math.isclose(got["accumulation"], m_accum, rel_tol=1e-12)
        assert math.isclose(got["finalize"], m_fin, rel_tol=1e-12), (N, c)

    W = Weierstrass.create(port_params.BLS12_377)
    N = 8
    scalars = W.random_scalars(N, seed=1, device="cpu")
    points = W.random_points_fast(N, seed=2, device="cpu")
    rows = phases.profile_msm(W, scalars, points, c=4, reps=1)
    assert [r.label for r in rows] == ["prep (decompose+endo+digits)", "bucket accumulation",
                                       "reduce + horner", "TOTAL (stage-timed)"]
    assert all(r.ms >= 0 for r in rows) and math.isclose(rows[-1].ms, sum(r.ms for r in rows[:3]))
    assert rows[-1].mmuls == sum(phases.mul_counts(N, W.scalar.max_bits, 4).values())
    out = io.StringIO()
    phases.print_phase_table(rows, N, out)
    assert "ns/point over 8 points" in out.getvalue()

    log = Log()
    log.tic("outer")
    with log.span("inner", torch.ones(3)):
        pass
    assert log.toc((torch.zeros(2), {"a": [torch.ones(1)]})) >= 0
    assert [label for label, _ in log.entries] == ["inner", "outer"]
    assert all(line.endswith(" ms") for line in log.lines())
    quiet = Log(active=False)
    quiet.tic("x")
    assert quiet.toc() == 0.0 and quiet.entries == []
    wait_for([torch.zeros(1)])  # CPU values are ready
    with tic_toc("noop"):
        pass
