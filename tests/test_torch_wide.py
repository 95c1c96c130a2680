"""The port on fields wider than the main library's shapes, against the JAX
package, on the CPU: BN462 (n = 39 limbs, a 462-bit p and q), the toy field
of n = 63 limbs (751 bits, the widest the limb code takes) and ed25519
(``testing/wide_curves.py``). On the card the same paths run on the shapes
and the scalar module made on demand (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 20); here every wrapper takes its plain twin.

Inputs are made with numpy from a seed and given to both sides, batch 8;
equality is exact: field values mod p (outputs below 2p), digit planes bit
for bit, points as points.

* BN462: ``MontgomeryFp.montmul`` (K1's twin) against the JAX field's;
  ``GlvScalar.decompose`` + ``signed_digits`` (K2's twin) against JAX's on
  q at c = 8, 13 and 22; the curve twins (K3, K4, K4m, K5, K6, K7) against
  the JAX package's bigint ``ProjectiveCurve``, on points with random Z and
  an identity, a doubling and a cancelling lane; K13's twin against
  ``montmul51_pallas(interpret=True)`` and K14-K4's against the
  interpret-mode TPU kernel, both on 15 ``PackedCodec`` rows; the N = 8 MSM
  in ``"projective"`` and ``"packed"`` (zero scalars, q - 1, a duplicated
  point, a point at infinity) against the JAX package's bigint Pippenger
  oracle and the known discrete logs.
* n = 63 and ed25519: K1's twin and the curve twins at n = 63 against JAX,
  as above, on points of y^2 = x^3 + 7; the Edwards unified add (K11's
  twin) at n = 63 against the bigint ``EdwardsCurve.add`` (the same
  formula, on any values); ``TwistedEdwards.create(ED25519).msm`` at N = 8
  in ``"padded"`` against the JAX package's bigint Edwards oracle and the
  known logs.

Two test items, each looping over its checks: the CPU suite's wall time
follows its item count (``PERF.md``). No whole JAX MSM is jitted on XLA:CPU.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from msm_zprize_tpu.bigint.edwards import EdwardsCurve
from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.bigint.weierstrass import ProjectiveCurve
from msm_zprize_tpu.curves import weierstrass51 as J51
from msm_zprize_tpu.fields import fma51_pallas as JF
from msm_zprize_tpu.fields.fp import make_field as jax_make_field
from msm_zprize_tpu.fields.scalar import make_glv_scalar as jax_glv_scalar
from msm_zprize_tpu.fields.scalar import signed_digits as jax_signed_digits
from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
from msm_zprize_tpu_torch.curves.weierstrass import WeierstrassOps
from msm_zprize_tpu_torch.fields.cuda_codec import montmul_rows_plain
from msm_zprize_tpu_torch.fields.cuda_scalar import glv_digits_plain
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
from msm_zprize_tpu_torch.testing.points import (
    ed_expected_msm, ed_points_with_logs, expected_msm, points_with_logs,
)
from msm_zprize_tpu_torch.testing.wide_curves import BN462, ED25519, TOY63_B, TOY63_P, toy63_points

torch.set_num_threads(1)

B = 8


def _ints(rng, bound, count, edges=()):
    vals = [v % bound for v in edges]
    return vals + [int.from_bytes(rng.bytes(100), "little") % bound for _ in range(count - len(vals))]


def _mod(F, arrs):
    """The values of Montgomery limb arrays (torch or JAX), mod p."""
    return [F.unpack(np.asarray(a)) for a in arrs]


def _below_2p(F, arrs):
    """Whether every stored value lies below 2p."""
    return all(v < 2 * F.p for a in arrs
               for v in F.unpack(np.asarray(a), montgomery=False, reduce=False))


def _check_montmul(p, rng):
    """K1's twin against the JAX field's montmul: equal mod p, below 2p."""
    F, J = make_field(p), jax_make_field(p)
    xs, ys = _ints(rng, p, B, (0, 1, p - 1)), _ints(rng, p, B, (5, p - 1, p - 1))
    x, y = F.pack(xs, montgomery=False), F.pack(ys, montgomery=False)
    got = F.montmul(torch.as_tensor(x), torch.as_tensor(y))
    want = jax.jit(J.montmul)(jnp.asarray(x), jnp.asarray(y))
    assert _mod(F, [got]) == _mod(F, [want]) and _below_2p(F, [got]), p.bit_length()


def _proj_lanes(p, pts, rng):
    """(P_i, Q_i) with random Z: the points, then an identity, a doubling and
    a cancelling lane."""
    zs = _ints(rng, p - 1, 2 * B)
    proj = [(x * (z + 1) % p, y * (z + 1) % p, z + 1) for (x, y), z in zip(pts, zs)]
    Ps, Qs = proj[:B], proj[B:2 * B]
    Ps[1] = (0, 1, 0)
    Qs[2] = Ps[2]
    Qs[3] = (Ps[3][0], (-Ps[3][1]) % p, Ps[3][2])
    return Ps, Qs


def _check_curve_twins(params, pts, rng):
    """The curve twins against the JAX package's bigint group law
    (``ProjectiveCurve``, its own formulas), point for point: K4, K4m (a
    mask), K5 (k = 2), K6, K7 (an affine operand at infinity on some lanes)
    and K3 (signed/valid slots). The jnp path's formulas, which the twins
    follow op for op, are held at n = 32 and 6 in ``test_torch_curve.py``;
    an XLA:CPU compile of them takes 40-55 s at n = 39 and 63."""
    W, C = WeierstrassOps(params), ProjectiveCurve(params)
    F, p = W.F, params.modulus
    Ps, Qs = _proj_lanes(p, pts, rng)
    t = lambda vals: torch.as_tensor(F.pack(vals))
    a = [t([pt[i] for pt in Ps]) for i in range(3)]
    b = [t([pt[i] for pt in Qs]) for i in range(3)]
    ax, ay = t([pt[0] for pt in pts[:B]]), t([pt[1] for pt in pts[:B]])
    bx, by = t([pt[0] for pt in pts[B:2 * B]]), t([pt[1] for pt in pts[B:2 * B]])
    mask, inf, s1, v1, s2, v2 = rng.integers(0, 2, size=(6, B), dtype=np.int32)
    v1[:2] = v2[:2] = 1  # both slots valid on the first lanes
    affs = [(x, y, 1) for x, y in pts[:2 * B]]
    slot = lambda P, s, v: C.neg(P) if s and v else P if v else C.zero
    twice = lambda P: C.double(P)
    want = {
        "K4": [C.add(P, Q) for P, Q in zip(Ps, Qs)],
        "K4m": [C.add(P, Q) if m else P for P, Q, m in zip(Ps, Qs, mask)],
        "K5": [twice(twice(P)) for P in Ps],
        "K6": [twice(P) for P in Ps],
        "K7": [P if i else C.add(P, Q) for P, Q, i in zip(Ps, affs[B:], inf)],
        "K3": [C.add(slot(P, *f1), slot(Q, *f2)) for P, Q, f1, f2
               in zip(affs[:B], affs[B:], zip(s1, v1), zip(s2, v2))],
    }
    T = lambda arr: torch.as_tensor(arr)
    got = {
        "K4": cuda_curve.proj_add_plain(W, *a, *b),
        "K4m": cuda_curve.proj_add_plain(W, *a, *b, mask=T(mask)),
        "K5": cuda_curve.proj_double_k_plain(W, *a, 2),
        "K6": cuda_curve.proj_double_plain(W, *a),
        "K7": cuda_curve.proj_add_mixed_plain(W, *a, bx, by, T(inf)),
        "K3": cuda_curve.aff_pair_add_plain(W, ax, ay, T(s1), T(v1), bx, by, T(s2), T(v2)),
    }
    for name, out in got.items():
        pts_out = list(zip(*_mod(F, out)))
        assert all(C.eq(g, w) for g, w in zip(pts_out, want[name])), (p.bit_length(), name)
        assert name == "K3" or _below_2p(F, out), (p.bit_length(), name)
    return W


def test_bn462_matches_jax():
    """BN462 (n = 39): the field, GLV scalar, curve and codec twins against
    the JAX package, and the N = 8 MSM in two modes against the bigint
    oracle and the known discrete logs."""
    rng = np.random.default_rng(14)
    p, q = BN462.modulus, BN462.order
    _check_montmul(p, rng)

    # K2's twin: GLV decomposition + signed windows, bit for bit
    cv = Weierstrass.create(BN462)
    S, JS = cv.scalar, jax_glv_scalar(q, BN462.lambda_)
    assert (S.n, S.n_half, S.n_acc, S.K0_limbs, len(S.m0)) == (39, 20, 22, 40, 21)
    s = S.pack(_ints(rng, q, B, (0, 1, q - 1, q // 2)))

    sg0, u0, sg1, u1 = jax.jit(JS.decompose)(jnp.asarray(s))
    for c in (8, 13, 22):
        K = -(-(S.max_bits + 1) // c)
        got = glv_digits_plain(S, torch.as_tensor(s), c, K)
        m0, s0 = jax_signed_digits(u0, c, K, JS.w, scalar_sign=sg0)
        m1, s1 = jax_signed_digits(u1, c, K, JS.w, scalar_sign=sg1)
        want = (jnp.concatenate([m0, m1], axis=-1), jnp.concatenate([s0, s1], axis=-1))
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want)), c

    pts, logs = points_with_logs(BN462, 2 * B, seed=14)
    _check_curve_twins(BN462, pts, rng)

    # K13 and K14-K4 on 15 PackedCodec rows against the interpret-mode TPU kernels
    Wp = cv.ops_packed
    F, codec, jc = Wp.F, Wp.codec, JF.PackedCodec(p)
    assert codec.rows == jc.rows == 15
    r_inv = pow(F.R, -1, p)
    xs, ys = _ints(rng, 2 * p, B, (0, 2 * p - 1)), _ints(rng, 2 * p, B, (5, 2 * p - 1))
    x, y = codec.pack(xs), codec.pack(ys)
    got = codec.unpack(montmul_rows_plain(F, codec, torch.as_tensor(x), torch.as_tensor(y)))
    want = jc.unpack(JF.montmul51_pallas(p, jnp.asarray(x), jnp.asarray(y), interpret=True,
                                         codec=jc))
    assert all(g < 2 * p for g in got)
    assert [g % p for g in got] == [w % p for w in want] == [a * b * r_inv % p for a, b in zip(xs, ys)]
    vals = [codec.pack(_ints(rng, p, B)) for _ in range(6)]
    got = cuda_curve.proj_add_plain(Wp, *map(torch.as_tensor, vals))
    want = J51.PackedWeierstrassOps(BN462, interpret=True).kernels.proj_add(*map(jnp.asarray, vals))
    for g, w in zip(got, want):
        assert [v % p for v in codec.unpack(g)] == [v % p for v in jc.unpack(np.asarray(w))]
        assert all(v < 2 * p for v in codec.unpack(g))

    # the N = 8 MSMs: zero scalars, q - 1, a duplicated point, infinity
    scs = _ints(rng, q, B, (0, q - 1, 1, 0))
    mpts, mlogs = list(pts[:B]), list(logs[:B])
    mpts[5], mlogs[5] = mpts[4], mlogs[4]
    scs[6] = 12345  # on the point at infinity
    mpts[6] = None
    C = ProjectiveCurve(BN462)
    live = [(sc, pt) for sc, pt in zip(scs, mpts) if pt is not None]
    oracle = C.to_affine(msm_oracle(C, [sc for sc, _ in live], [C.from_affine(pt) for _, pt in live],
                                    q.bit_length()))
    known = expected_msm(BN462, [sc for sc, pt in zip(scs, mpts) if pt is not None],
                         [a for a, pt in zip(mlogs, mpts) if pt is not None])
    assert oracle == known
    sc_t, pt_t = cv.scalars_from_ints(scs, "cpu"), cv.points_from_ints(mpts, "cpu")
    for mode in ("projective", "packed"):
        assert cv.result_to_int(cv.msm(sc_t, pt_t, mode=mode)) == oracle, mode


def test_n63_and_ed25519_match_jax():
    """n = 63 (24 words): K1's twin, the curve twins and the Edwards add
    against JAX; ed25519's N = 8 padded MSM against the bigint Edwards
    oracle and the known logs."""
    rng = np.random.default_rng(63)
    _check_montmul(TOY63_P, rng)
    toy = types.SimpleNamespace(modulus=TOY63_P, b=TOY63_B, beta=None)
    W = _check_curve_twins(toy, toy63_points(2 * B, seed=63), rng)

    # K11's twin at n = 63 against the JAX package's bigint Edwards add (the
    # same 2008-hwcd-3 formula): equal mod p on any values
    F, p = W.F, TOY63_P
    d = int.from_bytes(rng.bytes(96), "little") % p
    E = types.SimpleNamespace(F=F, k_mont=2 * d * F.R % p)
    C = EdwardsCurve(types.SimpleNamespace(modulus=p, d=d))
    P1, P2 = ([_ints(rng, p, B) for _ in range(4)] for _ in range(2))
    got = cuda_edwards.ed_add_plain(E, *(torch.as_tensor(F.pack(v)) for v in P1 + P2))
    want = [C.add(P, Q) for P, Q in zip(zip(*P1), zip(*P2))]
    assert [list(v) for v in zip(*_mod(F, got))] == [list(w) for w in want] and _below_2p(F, got)

    # ed25519: the padded MSM, zero scalars and l - 1 among the scalars
    q = ED25519.order
    cv = TwistedEdwards.create(ED25519)
    pts, logs = ed_points_with_logs(ED25519, B, seed=25519)
    scs = _ints(rng, q, B, (0, q - 1, 1))
    C = EdwardsCurve(ED25519)
    oracle = C.to_affine(msm_oracle(C, scs, [C.from_affine(pt) for pt in pts], q.bit_length()))
    assert oracle == ed_expected_msm(ED25519, scs, logs)
    got = cv.msm(cv.scalars_from_ints(scs, "cpu"), cv.points_from_ints(pts, "cpu"), mode="padded")
    assert cv.result_to_int(got) == oracle
