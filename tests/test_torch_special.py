"""The port's Barrett reduction, special GLV split, 51x5 engine and bytes
codec against the JAX package, on the CPU.

Inputs are made with numpy from a seed and given to both sides; equality is
exact: limb, digit and byte arrays bit for bit, decoded values mod p, and
affine points.

* ``BarrettReducer.reduce`` against JAX's (jitted) on x < p^2.
* ``GlvScalarSpecial.decompose`` / ``decompose_no_msb`` and
  ``GlvScalarSpecialMsm.decompose`` against JAX's (jitted) on BLS12-381 and
  BLS12-377, ``glv_prep``'s branch for a scalar module other than
  ``GlvScalar`` against JAX ``glv_prep`` (jitted), and an N = 8
  ``msm_batched_affine`` on the special split against the bigint Pippenger
  oracle (``bigint/msm.py``) and the known discrete logs.
* The digit window limit of K2 and K9 (``cuda_scalar.MAX_C``): the twins at
  c = 21, 22, 30 against JAX ``signed_digits``, and c outside 1..30 refused.
* ``Fma51Field``'s ops against JAX's on a lazy and a strict field, and
  ``montmul_fma_model`` against JAX's and the engine.
* The bytes codec against JAX ``bytes_codec``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.bigint.weierstrass import ProjectiveCurve
from msm_zprize_tpu.curves.params import BLS12_377, BLS12_381, PALLAS
from msm_zprize_tpu.fields import bytes_codec as jax_codec
from msm_zprize_tpu.fields import fma51 as jax_fma51
from msm_zprize_tpu.fields import scalar as jax_scalar
from msm_zprize_tpu.fields.barrett import BarrettReducer as JaxBarrett
from msm_zprize_tpu.fields.limbs import LimbScheme as JaxScheme
from msm_zprize_tpu.msm.batched_affine import glv_prep as jax_glv_prep
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch.curves import params as port_params
from msm_zprize_tpu_torch.fields import bytes_codec, cuda_scalar, fma51, scalar
from msm_zprize_tpu_torch.fields import limbs as TL
from msm_zprize_tpu_torch.fields.barrett import BarrettReducer
from msm_zprize_tpu_torch.msm.batched_affine import glv_prep, msm_batched_affine
from msm_zprize_tpu_torch.parallel.api import Weierstrass
from msm_zprize_tpu_torch.testing.points import expected_msm, points_with_logs

torch.set_num_threads(1)


def _ints(seed, bound, count, edges=()):
    rng = np.random.default_rng(seed)
    vals = [v % bound for v in edges]
    vals += [int.from_bytes(rng.bytes(96), "little") % bound for _ in range(count - len(vals))]
    return vals


def _same(got, want):
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_barrett_matches_jax():
    """x mod p for x < p^2 (0, p - 1, p, p^2 - 1 among them) on BLS12-377's
    base field: the port's limbs equal JAX's, and x % p."""
    p = BLS12_377.modulus
    R, JR = BarrettReducer(p), JaxBarrett(p)
    xs = _ints(1, p * p, 8, edges=(0, p - 1, p, p * p - 1))
    x = TL.pack(xs, TL.LimbScheme(12, 2 * R.n))
    got = R.reduce(torch.as_tensor(x))
    _same(got, jax.jit(JR.reduce)(jnp.asarray(x)))
    assert TL.unpack(got, R.scheme) == [v % p for v in xs]
    with pytest.raises(ValueError, match="limbs"):
        R.reduce(torch.as_tensor(x[: R.n]))


SPECIAL = {"bls12-381": (BLS12_381, port_params.BLS12_381), "bls12-377": (BLS12_377, port_params.BLS12_377)}


@pytest.mark.parametrize("name", list(SPECIAL))
def test_glv_special_matches_jax(name):
    """decompose, decompose_no_msb (the special split by the ~sqrt(q)
    eigenvalue) and the MSM adapter's decompose: every limb and sign plane
    equal to JAX's, and the identities they promise hold."""
    J, P = SPECIAL[name]
    q = P.order
    lam = min(P.lambda_, q - P.lambda_)
    S, JS = scalar.GlvScalarSpecial(q, lam), jax_scalar.GlvScalarSpecial(q, lam)
    SM, JSM = scalar.GlvScalarSpecialMsm(q, P.lambda_), jax_scalar.GlvScalarSpecialMsm(q, P.lambda_)
    for a in ("half_bits", "n_half", "K_limbs"):
        assert getattr(S, a) == getattr(JS, a)
    _same(S.m, JS.m)
    _same(S.l_limbs, JS.l_limbs)
    assert (SM.max_bits, SM.n_half, SM._neg1) == (JSM.max_bits, JSM.n_half, JSM._neg1)
    scs = _ints(2, q, 8, edges=(0, 1, q - 1, lam, lam - 1))
    s = S.pack(scs)
    got = (S.decompose(torch.as_tensor(s)), S.decompose_no_msb(torch.as_tensor(s)),
           SM.decompose(torch.as_tensor(s)))
    want = jax.jit(lambda a: (JS.decompose(a), JS.decompose_no_msb(a), JSM.decompose(a)))(jnp.asarray(s))
    for g, w in zip(got, want):
        for gg, ww in zip(g, w):
            _same(gg, ww)
    half = TL.LimbScheme(12, S.n_half)
    u0, u1 = (TL.unpack(u, half) for u in got[0])
    assert all(a + lam * b == v and a < lam for v, a, b in zip(scs, u0, u1))
    g0, v0, v1 = got[1]
    assert all((-a if sg else a) + lam * b == v and a < 1 << (S.half_bits - 1)
               for v, sg, a, b in zip(scs, g0.tolist(), TL.unpack(v0, half), TL.unpack(v1, half)))


def test_glv_prep_special_branch_matches_jax():
    """glv_prep with GlvScalarSpecialMsm (BLS12-381, c = 6, a point at
    infinity): the 2N points, digit magnitudes and signs bit for bit against
    JAX glv_prep (its jnp branch for non-GlvScalar modules), K and L."""
    port, jc = Weierstrass.create(port_params.BLS12_381), JaxWeierstrass.create(BLS12_381)
    q = BLS12_381.order
    S, JS = scalar.GlvScalarSpecialMsm(q, BLS12_381.lambda_), jax_scalar.GlvScalarSpecialMsm(q, BLS12_381.lambda_)
    pts, _ = points_with_logs(port_params.BLS12_381, 8, seed=3)
    pts[5] = None
    scs = _ints(4, q, 8, edges=(0, q - 1))
    s = S.pack(scs)
    p = port.points_from_ints(pts, "cpu")
    got = glv_prep(port.ops, S, torch.as_tensor(s), p, 6)
    jp = jc.points_from_ints(pts)
    want = jax.jit(lambda a, x, y, inf: jax_glv_prep(jc.ops, JS, a, type(jp)(x, y, inf), 6)[:3])(
        jnp.asarray(s), *jp)
    for g, w in zip(got[0], want[0]):
        _same(g, w)
    _same(got[1], want[1])
    _same(got[2], want[2])
    assert got[1][:, [5, 13]].eq(0).all()  # the point at infinity and its image
    assert got[3:] == (-(-(S.max_bits + 1) // 6), 32)


def test_special_msm_matches_oracle():
    """msm_batched_affine on the special split (BLS12-381, N = 8, scalars 0
    and q - 1 among them, default c) against the bigint Pippenger oracle and
    the known discrete logs."""
    P = port_params.BLS12_381
    port = Weierstrass.create(P)
    S = scalar.GlvScalarSpecialMsm(P.order, P.lambda_)
    pts, logs = points_with_logs(P, 8, seed=5)
    scs = _ints(6, P.order, 8, edges=(0, P.order - 1))
    res = msm_batched_affine(port.ops, S, torch.as_tensor(S.pack(scs)),
                             port.points_from_ints(pts, "cpu"), mode="projective")
    C = ProjectiveCurve(BLS12_381)
    want = C.to_affine(msm_oracle(C, scs, [C.from_affine(pt) for pt in pts], 255))
    assert port.result_to_int(res) == want == expected_msm(P, scs, logs)


def test_digit_window_limit():
    """c up to MAX_C = 30, the widest window the int32 recoding holds:
    the twins of K9 and K2 bit for bit against JAX signed_digits at c = 21,
    22 and 30; c = 31 and c = 0 refused by both wrappers before any work;
    the C source's MAX_C the same."""
    src = (Path(cuda_scalar.__file__).parent.parent / "csrc" / "glv_digits.cu").read_text()
    assert int(re.search(r"constexpr int MAX_C = (\d+);", src).group(1)) == cuda_scalar.MAX_C == 30
    P = port_params.BLS12_377
    S = scalar.make_glv_scalar(P.order, P.lambda_)
    JS = jax_scalar.make_glv_scalar(P.order, P.lambda_)
    scs = _ints(7, P.order, 8, edges=(0, 1, P.order - 1))
    s = S.pack(scs)
    inf = torch.tensor([0, 1] * 8, dtype=torch.int32)
    js = jnp.asarray(s)
    jsg0, ju0, jsg1, ju1 = JS.decompose(js)
    for c in (21, 22, 30):
        K = -(-(S.max_bits + 1) // c)
        want = [jax_scalar.signed_digits(js, c, 22, 12)]
        want += [jax_scalar.signed_digits(u, c, K, 12, scalar_sign=g) for u, g in ((ju0, jsg0), (ju1, jsg1))]
        mags, signs = cuda_scalar.simple_digits(torch.as_tensor(s), c, 22)
        _same(mags, want[0][0])
        _same(signs, want[0][1])
        mags, signs = cuda_scalar.glv_digits(S, torch.as_tensor(s), c, K, inf=inf)
        _same(signs, np.concatenate([want[1][1], want[2][1]], axis=-1))
        _same(mags, np.where(inf.numpy()[None] != 0, 0, np.concatenate([want[1][0], want[2][0]], axis=-1)))
    for c in (0, 31):
        with pytest.raises(ValueError, match="1..30"):
            cuda_scalar.simple_digits(torch.as_tensor(s), c, 9)
        with pytest.raises(ValueError, match="1..30"):
            cuda_scalar.glv_digits(S, torch.as_tensor(s), c, 9)


FMA_FIELDS = {"lazy": BLS12_377.order, "strict": PALLAS.modulus}


@pytest.mark.parametrize("mode", list(FMA_FIELDS))
def test_fma51_matches_jax(mode):
    """Every Fma51Field op, limb for limb, against JAX's (int64 under x64):
    on BLS12-377's scalar field (lazy, [0, 2p)) and Pallas's base field
    (strict, canonical); montmul_fma_model against JAX's model and the
    engine."""
    p = FMA_FIELDS[mode]
    F, JF = fma51.make_fma51_field(p), jax_fma51.make_fma51_field(p)
    assert F.lazy == JF.lazy == (mode == "lazy")
    xs = _ints(8, p, 8, edges=(0, 1, p - 1))
    ys = _ints(9, p, 8, edges=(p - 1, 1, p - 1))
    X, Y = F.pack(xs, "cpu"), F.pack(ys, "cpu")
    got = [F.montmul(X, Y), F.montsquare(X), F.add(X, Y), F.sub(X, Y), F.sub(Y, X),
           F.reduce(F.add(X, Y)), F.to_montgomery(X), F.from_montgomery(X),
           F.from_f64(F.montmul_f64(F.to_f64(X), F.to_f64(Y)))]
    with jax.enable_x64(True):
        JX, JY = JF.pack(xs), JF.pack(ys)
        _same(X, JX)
        want = [JF.montmul(JX, JY), JF.montsquare(JX), JF.add(JX, JY), JF.sub(JX, JY),
                JF.sub(JY, JX), JF.reduce(JF.add(JX, JY)), JF.to_montgomery(JX),
                JF.from_montgomery(JX), JF.from_f64(JF.montmul_f64(JF.to_f64(JX), JF.to_f64(JY)))]
        for g, w in zip(got, want):
            _same(g, w)
        assert F.is_equal(X, Y).tolist() == np.asarray(JF.is_equal(JX, JY)).tolist()
    assert F.unpack(got[0]) == [a * b % p for a, b in zip(xs, ys)]
    assert F.unpack(F.pack(xs, "cpu", montgomery=False), montgomery=False) == xs
    r_inv = pow(F.R, -1, p)
    for a, b in zip(xs, ys):
        m = fma51.montmul_fma_model(p, a, b)
        assert m == jax_fma51.montmul_fma_model(p, a, b) and m % p == a * b * r_inv % p


def test_bytes_codec_matches_jax():
    """bytes_to_limbs, limbs_to_bytes, ints_to_bytes, bytes_to_ints,
    _less_than and random_uniform_limbs against JAX bytes_codec."""
    vals = _ints(10, 1 << 384, 16, edges=(0, 1, (1 << 384) - 1))
    for n, nbytes in ((32, 48), (22, 33)):
        ts, js = TL.LimbScheme(12, n), JaxScheme(12, n)
        vs = [v % (1 << (12 * n)) for v in vals]
        data = bytes_codec.ints_to_bytes(vs, nbytes)
        _same(data, jax_codec.ints_to_bytes(vs, nbytes))
        limbs = bytes_codec.bytes_to_limbs(data, ts)
        _same(limbs, jax_codec.bytes_to_limbs(data, js))
        _same(limbs, TL.pack(vs, ts))
        _same(bytes_codec.limbs_to_bytes(limbs, ts), jax_codec.limbs_to_bytes(limbs, js))
        _same(bytes_codec.limbs_to_bytes(limbs, ts), data)
        assert bytes_codec.bytes_to_ints(data) == jax_codec.bytes_to_ints(data) == vs
        bound = np.array(ts.to_limbs(vs[5]), dtype=np.int64)
        _same(bytes_codec._less_than(limbs, bound), jax_codec._less_than(limbs, bound))
        q = BLS12_377.order
        _same(bytes_codec.random_uniform_limbs(np.random.default_rng(11), q, 64, ts),
              jax_codec.random_uniform_limbs(np.random.default_rng(11), q, 64, js))
