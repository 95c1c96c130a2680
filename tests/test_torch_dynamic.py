"""The port's runtime-exponent, square-root and scalar-multiple ops against
the JAX package, on the CPU.

Inputs are made with numpy from a seed and given to both sides; equality is
exact: decoded field values mod p, normalised points, flags bit for bit.

* ``MontgomeryFp.exp_dyn`` and ``left_shift`` against JAX ``MontgomeryFp``.
* ``FieldSqrt.is_square`` and ``sqrt`` on the four curves' base fields:
  against JAX ``FieldSqrt`` on BLS12-381 (M = 1) and Pallas (M = 32); on
  BLS12-377 (M = 46) and ed-on-bls12-377 (M = 47), where the JAX function's
  XLA:CPU compile alone takes 8-9 s, against the JAX package's bigint
  oracle (``bigint/field.py``): the same flags, roots equal up to sign.
* Weierstrass ``proj_scale_dyn``, ``is_in_subgroup``, ``to_subgroup`` and
  ``proj_is_zero``; Edwards ``scale_const``, ``is_in_subgroup`` and
  ``to_subgroup``: against the bigint oracle's double-and-add (the JAX
  scans take 10-19 s to compile here), on subgroup points and on curve
  points off the subgroup (no cofactor clearing). Edwards ``scale_dyn``
  against JAX ``EdwardsOps.scale_dyn`` (jitted).

The kernels these ops launch on the card (K1, K8, K4m, K4, K6, the masked
K11, K11, K12) are held against their twins by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msm_zprize_tpu.bigint import field as jax_bigint_field
from msm_zprize_tpu.bigint.edwards import EdwardsCurve
from msm_zprize_tpu.bigint.weierstrass import AffineCurve
from msm_zprize_tpu.curves.params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from msm_zprize_tpu.fields.fp import make_field as jax_field
from msm_zprize_tpu.fields.sqrt import make_sqrt as jax_sqrt
from msm_zprize_tpu.parallel.api import TwistedEdwards as JaxTwistedEdwards
from msm_zprize_tpu_torch.curves import params as port_params
from msm_zprize_tpu_torch.curves.edwards import EdwardsOps
from msm_zprize_tpu_torch.curves.weierstrass import WeierstrassOps
from msm_zprize_tpu_torch.fields import limbs as TL
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.fields.sqrt import make_sqrt

torch.set_num_threads(1)


def _ints(seed, bound, count, edges=()):
    rng = np.random.default_rng(seed)
    vals = [v % bound for v in edges]
    vals += [int.from_bytes(rng.bytes(64), "little") % bound for _ in range(count - len(vals))]
    return vals


def _limbs(vals, n):
    return TL.pack(vals, TL.LimbScheme(12, n))


def test_fp_dynamic_matches_jax():
    """exp_dyn over a 22-limb runtime exponent (0, 1, 2^264 - 1 among them)
    and left_shift by 0, 1, 13, against the JAX package (jitted)."""
    p = BLS12_377.modulus
    F, JF = make_field(p), jax_field(p)
    xs = _ints(1, p, 6, edges=(0, 1, p - 1))
    es = _ints(2, 1 << 264, 6, edges=(0, 1, (1 << 264) - 1))
    x, e = F.pack(xs), _limbs(es, 22)
    ks = (0, 1, 13)
    want = jax.jit(lambda a, b: (JF.exp_dyn(a, b),) + tuple(JF.left_shift(a, k) for k in ks))(
        jnp.asarray(x), jnp.asarray(e))
    got = (F.exp_dyn(torch.as_tensor(x), torch.as_tensor(e)),) + tuple(
        F.left_shift(torch.as_tensor(x), k) for k in ks)
    for g, w in zip(got, want):
        assert F.unpack(g) == JF.unpack(w)
    assert F.unpack(got[0]) == [pow(a, b, p) for a, b in zip(xs, es)]
    assert [F.unpack(g) for g in got[1:]] == [[(a << k) % p for a in xs] for k in ks]


SQRT_FIELDS = {
    "bls12-381": (BLS12_381.modulus, "jax"),
    "pallas": (PALLAS.modulus, "jax"),
    "bls12-377": (BLS12_377.modulus, "oracle"),
    "ed-on-bls12-377": (ED_ON_BLS12_377.modulus, "oracle"),
}


@pytest.mark.parametrize("name", list(SQRT_FIELDS))
def test_sqrt_and_is_square(name):
    """Squares, non-squares, 0 and 1: the same ok and is_square flags as the
    reference, roots that square back (0 for 0), and roots equal to the JAX
    function's (its chain is the port's) or, against the oracle, up to sign."""
    p, ref = SQRT_FIELDS[name]
    F, S = make_field(p), make_sqrt(p)
    z = 2
    while jax_bigint_field.is_square(z, p):
        z += 1
    vals = _ints(3, p, 8, edges=(0, 1))
    vals[2:5] = [v * v % p for v in vals[2:5]]
    vals[5] = z  # a non-residue
    x = F.pack(vals)
    root, ok = S.sqrt(torch.as_tensor(x))
    sq = S.is_square(torch.as_tensor(x))
    roots = F.unpack(root)
    want_ok = [jax_bigint_field.is_square(v, p) for v in vals]
    assert ok.tolist() == sq.tolist() == want_ok
    assert roots[0] == 0 and want_ok[:6] == [True] * 5 + [False]
    for v, r, o in zip(vals, roots, want_ok):
        if o:
            assert r * r % p == v
            assert r in (jax_bigint_field.sqrt(v, p), (-jax_bigint_field.sqrt(v, p)) % p)
    if ref == "jax":
        JF, JS = jax_field(p), jax_sqrt(p)
        (jroot, jok), jsq = jax.jit(lambda a: (JS.sqrt(a), JS.is_square(a)))(jnp.asarray(x))
        assert np.asarray(jok).tolist() == np.asarray(jsq).tolist() == want_ok
        assert [r for r, o in zip(roots, want_ok) if o] == [
            r for r, o in zip(JF.unpack(jroot), want_ok) if o]


def _weierstrass_points(P, count, seed, subgroup):
    """Affine curve points from numpy-seeded x (x^3 + b a square, the root's
    sign from the seed too), cofactor-cleared or not."""
    p, A = P.modulus, AffineCurve(P)
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        x = int.from_bytes(rng.bytes(64), "little") % p
        y = jax_bigint_field.sqrt((x**3 + P.b) % p, p)
        if y is None:
            continue
        pt = (x, y if rng.integers(2) else (-y) % p)
        if subgroup:
            pt = A.scale(P.cofactor, pt)
        if pt is not None:
            out.append(pt)
    return out


def _affine(W, R):
    p = W.F.p
    return [None if Z == 0 else (X * pow(Z, -1, p) % p, Y * pow(Z, -1, p) % p)
            for X, Y, Z in W.unpack_projective(R)]


@pytest.mark.parametrize("op", ["proj_scale_dyn", "subgroup"])
def test_weierstrass_scale_and_subgroup(op):
    """BLS12-377 against the bigint oracle: proj_scale_dyn with scalars 0,
    1, q - 1 and random ones; is_in_subgroup true on subgroup points, false
    off it; to_subgroup equal to cofactor * P and in the subgroup;
    proj_is_zero on the identity and on points."""
    P = port_params.BLS12_377
    W, A = WeierstrassOps(P), AffineCurve(BLS12_377)
    pts = _weierstrass_points(BLS12_377, 4, seed=4, subgroup=True)
    proj = lambda ps: W.pack_projective([(x, y, 1) for x, y in ps], "cpu")
    if op == "proj_scale_dyn":
        q = P.order
        ks = _ints(5, q, 4, edges=(0, 1, q - 1))
        R = W.proj_scale_dyn(torch.as_tensor(_limbs(ks, 22)), proj(pts))
        assert _affine(W, R) == [A.scale(k, pt) for k, pt in zip(ks, pts)]
        assert W.proj_is_zero(R).tolist() == [True, False, False, False]
        return
    raw = _weierstrass_points(BLS12_377, 3, seed=6, subgroup=False)
    assert not any(A.is_in_subgroup(pt) for pt in raw)
    cleared = W.to_subgroup(proj(raw))
    assert _affine(W, cleared) == [A.scale(P.cofactor, pt) for pt in raw]
    both = type(cleared)(*(torch.cat([a, b], dim=-1) for a, b in zip(proj(pts + raw), cleared)))
    assert W.is_in_subgroup(both).tolist() == [True] * 4 + [False] * 3 + [True] * 3


def _edwards_points(P, count, seed, subgroup):
    """Extended points from numpy-seeded y (x^2 = (y^2 - 1) / (d y^2 + 1)
    a square), cofactor-cleared or not."""
    p, O = P.modulus, EdwardsCurve(P)
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        y = int.from_bytes(rng.bytes(64), "little") % p
        x = jax_bigint_field.sqrt((y * y - 1) * pow(P.d * y * y + 1, -1, p) % p, p)
        if x is None:
            continue
        pt = O.from_affine((x if rng.integers(2) else (-x) % p, y))
        if subgroup:
            pt = O.scale(P.cofactor, pt)
        if not O.is_zero(pt):
            out.append(pt)
    return out


def test_edwards_scale_dyn_matches_jax():
    """scale_dyn (every bit a masked K11 select, K12 doubling) against JAX
    EdwardsOps.scale_dyn (jitted) and the oracle, scalars 0, 1, q - 1 and a
    random one."""
    P = port_params.ED_ON_BLS12_377
    E, O = EdwardsOps(P), EdwardsCurve(ED_ON_BLS12_377)
    JE = JaxTwistedEdwards.create(ED_ON_BLS12_377).ops
    pts = _edwards_points(ED_ON_BLS12_377, 4, seed=7, subgroup=True)
    ks = _ints(8, P.order, 4, edges=(0, 1, P.order - 1))
    k = _limbs(ks, 21)
    got = E.unpack(E.scale_dyn(torch.as_tensor(k), E.pack(pts, "cpu")))
    JP = JE.pack(pts)
    want = JE.unpack(jax.jit(lambda kk, *a: JE.scale_dyn(kk, type(JP)(*a)))(jnp.asarray(k), *JP))
    affine = lambda ps: [O.to_affine(pt) for pt in ps]
    assert affine(got) == affine(want) == affine(O.scale(kk, pt) for kk, pt in zip(ks, pts))


def test_edwards_subgroup_and_scale_const():
    """Against the bigint oracle: scale_const by 0, 1, 2, 5 and a 250-bit
    constant; is_in_subgroup true on subgroup points, false off it;
    to_subgroup equal to cofactor * P and in the subgroup."""
    P = port_params.ED_ON_BLS12_377
    E, O = EdwardsOps(P), EdwardsCurve(ED_ON_BLS12_377)
    pts = _edwards_points(ED_ON_BLS12_377, 3, seed=9, subgroup=True)
    raw = _edwards_points(ED_ON_BLS12_377, 3, seed=10, subgroup=False)
    assert not any(O.is_in_subgroup(pt) for pt in raw)
    affine = lambda ps: [O.to_affine(pt) for pt in ps]
    for k in (0, 1, 2, 5, _ints(11, 1 << 250, 1)[0]):
        got = E.unpack(E.scale_const(k, E.pack(pts, "cpu")))
        assert affine(got) == affine(O.scale(k, pt) for pt in pts)
    cleared = E.to_subgroup(E.pack(raw, "cpu"))
    assert affine(E.unpack(cleared)) == affine(O.scale(P.cofactor, pt) for pt in raw)
    both = type(cleared)(*(torch.cat([a, b], dim=-1) for a, b in zip(E.pack(pts + raw, "cpu"), cleared)))
    assert E.is_in_subgroup(both).tolist() == [True] * 3 + [False] * 3 + [True] * 3
