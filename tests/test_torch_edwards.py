"""The port's ed-on-bls12-377 slice against the JAX package, on the CPU.

* Field core (K0): a pure-Python model of the kernels' words (the load,
  32-bit CIOS rounds, the tail round for R = 2^264 and 2^396, and Pallas's
  carry-aware load and add) against ``montmul_plain`` on every field shape; ``exp_const``,
  ``inverse`` and ``batch_inverse`` against JAX ``MontgomeryFp``, limb for
  limb (the same algorithms, hence the same representatives).
* K9's twin (``signed_digits``) against ``simple_digits_pallas(...,
  interpret=True)`` and JAX ``signed_digits``: bit-exact.
* K10-K12's twins against JAX ``EdwardsOps`` (the jnp path) and against
  ``EdwardsKernels(..., interpret=True)``: exact equality mod p of every
  coordinate (the same formula gives the same field values; the kernels
  keep other representatives below 2p); ``batch_normalize``, ``eq``,
  ``is_on_curve``; the port's parameters and host oracle against
  ``bigint/edwards.py``; ``ext_from_jax``.
* ``TwistedEdwards.msm`` at N in {1, 8, 64} and the edge cases against the
  bigint Pippenger oracle (``bigint/msm.py`` with ``EdwardsCurve``) and the
  known discrete logs: exact equality of affine points.

Ten test items: the CPU suite's wall time follows its item count (the
replay of pytest-xdist's scheduler in ``PERF.md`` chose it).

The CUDA kernels themselves run on the card in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msm_zprize_tpu.bigint.edwards import EdwardsCurve
from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.curves.edwards import EdwardsOps as JaxEdwardsOps
from msm_zprize_tpu.curves.edwards import ExtPoints as JaxExt
from msm_zprize_tpu.curves.pallas_curve import EdwardsKernels
from msm_zprize_tpu.curves.params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from msm_zprize_tpu.fields.fp import make_field as jax_field
from msm_zprize_tpu.fields.pallas_scalar import simple_digits_pallas
from msm_zprize_tpu.fields.scalar import signed_digits as jax_signed_digits
from msm_zprize_tpu.parallel.api import TwistedEdwards as JaxTwistedEdwards
from msm_zprize_tpu_torch import _build
from msm_zprize_tpu_torch.curves import cuda_edwards
from msm_zprize_tpu_torch.curves import params as port_params
from msm_zprize_tpu_torch.curves.edwards import EdwardsOps, ExtPoints
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.fields.scalar import signed_digits
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards
from msm_zprize_tpu_torch.testing.points import (
    ed_add, ed_expected_msm, ed_naive_msm, ed_points_with_logs,
)
from msm_zprize_tpu_torch.utils.convert import ext_from_jax, scalars_from_jax

torch.set_num_threads(1)

P = ED_ON_BLS12_377.modulus
Q = ED_ON_BLS12_377.order
B = 8


def _ints(seed, bound, count, edges=(), nbytes=40):
    rng = np.random.default_rng(seed)
    vals = [v for v in edges if v < bound]
    return vals + [int.from_bytes(rng.bytes(nbytes), "little") % bound
                   for _ in range(count - len(vals))]


def _cios(a: int, b: int, p: int, nw: int, tail: int) -> int:
    """The kernels' Montgomery product (csrc/field.cuh::mont_mul) word for
    word: nw CIOS rounds over 32-bit words, then one tail-bit round."""
    m32 = (1 << 32) - 1
    pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    aw, bw, pw = ([(v >> (32 * i)) & m32 for i in range(nw)] for v in (a, b, p))
    t = [0] * (nw + 1)
    for i in range(nw):
        c = 0
        for j in range(nw):
            c += aw[j] * bw[i] + t[j]
            t[j], c = c & m32, c >> 32
        t[nw] = (t[nw] + c) & m32
        m = (t[0] * pinv) & m32
        c = (m * pw[0] + t[0]) >> 32
        for j in range(1, nw):
            c += m * pw[j] + t[j]
            t[j - 1], c = c & m32, c >> 32
        c += t[nw]
        t[nw - 1], t[nw] = c & m32, c >> 32
    if tail:
        m = (t[0] * pinv) & ((1 << tail) - 1)
        c = 0
        for j in range(nw):
            c += m * pw[j] + t[j]
            t[j], c = c & m32, c >> 32
        t[nw] = (t[nw] + c) & m32
        t = [((t[j] >> tail) | (t[j + 1] << (32 - tail))) & m32 for j in range(nw)]
    return sum(t[j] << (32 * j) for j in range(nw))


def _cond_sub_hi(low: int, hi: int, m: int, nw: int) -> int:
    """csrc/field.cuh::cond_sub_hi: (hi 2^(32 nw) + low) - m if that is >= m,
    else low, in nw words (cond_sub where hi is 0)."""
    return low if low < m and not hi else (low - m) % (1 << (32 * nw))


def _load(v: int, p: int, nw: int, carry: bool) -> int:
    """load_fe of a stored value v < 4p: its words; in a CARRY shape the bit
    above them folded in and the value reduced below 2p (the other shapes
    drop bits above the words, none where 4p < 2^(32 nw))."""
    low, hi = v % (1 << (32 * nw)), v >> (32 * nw)
    return _cond_sub_hi(low, hi, 2 * p, nw) if carry else low


def _f_add(a: int, b: int, p: int, nw: int, carry: bool) -> int:
    """f_add on values < 2p: the word sum, then 2p off, with the carry out of
    the top word in a CARRY shape."""
    s = a + b
    return _cond_sub_hi(s % (1 << (32 * nw)), s >> (32 * nw) if carry else 0, 2 * p, nw)


def test_field_core_and_inverse_match_jax():
    """The kernels' words (csrc/field.cuh), modelled in Python, on every
    field shape: the CIOS rounds and tail round after the load equal
    ``montmul_plain`` limb for limb on inputs below 4p (so R = 2^(12 n)
    exactly; stopping a round early or going one on would not). On Pallas's
    CARRY shape (4p > 2^256) the load folds bit 256 of inputs in [2^256,
    4p) and f_add keeps the carry of sums past 2^256: equal mod p, where
    the carry-free load and add of Fp22 (the other n = 22 shape) are wrong
    on exactly those inputs. Each field takes its own shape ID, and a field
    no shape fits is refused; exp_const, inverse and batch_inverse equal the
    JAX package's limb for limb."""
    shapes = ((BLS12_377.modulus, 12, 0, False), (P, 8, 8, False),
              (BLS12_381.modulus, 12, 12, False), (PALLAS.modulus, 8, 8, True))
    for p, nw, tail, carry in shapes:
        F = make_field(p)
        assert F.n * 12 == 32 * nw + tail
        assert _build.FIELD_SHAPES[_build.field_shape(F)] == (F.n, nw, carry)
        big = ((1 << 256) + 5,) if carry else ()  # past the 8 words, below 4p
        vals = list(zip(_ints(1, 4 * p, 48, edges=(0, 1, 4 * p - 1) + big, nbytes=56),
                        _ints(2, 4 * p, 48, edges=(4 * p - 1, 4 * p - 1, 1) + big, nbytes=56)))
        x, y = (torch.as_tensor(F.pack([v[i] for v in vals], montgomery=False)) for i in range(2))
        want = F.unpack(F.montmul_plain(x, y), montgomery=False, reduce=False)
        got = [_cios(_load(a, p, nw, carry), _load(b, p, nw, carry), p, nw, tail) for a, b in vals]
        assert max(got) < 2 * p, nw
        if carry:  # the load reduces inputs of 2p and above: equal mod p, the
            # same integer where both are below 2p; dropping bit 256 is wrong
            assert [g % p for g in got] == [w % p for w in want]
            assert all(g == w for g, w, (a, b) in zip(got, want, vals) if max(a, b) < 2 * p)
            assert all(_load(a, p, nw, False) % p != a % p for a, _ in vals if a >> 256)
        else:
            assert got == want, nw
        if tail:  # a wrong R is caught: one round less or more gives other integers
            assert [_cios(a, b, p, nw, 0) for a, b in vals] != want
            assert [_cios(a, b, p, nw + 1, 0) for a, b in vals] != want
        # f_add on values < 2p: on Pallas the sums of values past 2^255 cross 2^256
        aa = _ints(3, 2 * p, 32, edges=(2 * p - 1, 2 * p - 2, (1 << 255) + 3), nbytes=56)
        bb = _ints(4, 2 * p, 32, edges=(2 * p - 2, 2 * p - 1, 2 * p - 7), nbytes=56)
        sums = [_f_add(a, b, p, nw, carry) for a, b in zip(aa, bb)]
        assert all(t < 2 * p and t % p == (a + b) % p for t, a, b in zip(sums, aa, bb)), nw
        crossing = [(a, b) for a, b in zip(aa, bb) if (a + b) >> (32 * nw)]
        assert bool(crossing) == carry, nw
        assert all(_f_add(a, b, p, nw, False) % p != (a + b) % p for a, b in crossing)
    # BLS12-381 (n = 33) and Pallas (n = 22 as this field, but 4p > 2^256)
    # take shapes of their own; a field of n = 22 whose 2p exceeds 8 words
    # has none
    ids = [_build.field_shape(make_field(p)) for p in (P, BLS12_381.modulus, PALLAS.modulus)]
    assert ids == [2, 3, 4]
    with pytest.raises(ValueError, match="2p < 2\\^256 <= 4p"):
        _build.field_words(make_field((1 << 255) + 95))

    F, J = make_field(P), jax_field(P)
    x = F.pack(_ints(3, P, 64, edges=(1, P - 1)))
    exps = (0, 1, 2, 5, (1 << 16) + 1, P - 2)
    got = [F.exp_const(torch.as_tensor(x[:, :4]), e) for e in exps]
    got += [F.inverse(torch.as_tensor(x[:, :4]))]
    got += [F.batch_inverse(torch.as_tensor(x[:, :w])) for w in (3, 8, 37, 64)]
    got += [F.batch_inverse(torch.as_tensor(x).reshape(F.n, 8, 8))]

    def jax_side(x):
        out = [J.exp_const(x[:, :4], e) for e in exps] + [J.inverse(x[:, :4])]
        return out + [J.batch_inverse(x[:, :w]) for w in (3, 8, 37, 64)] + [
            J.batch_inverse(x.reshape(J.n, 8, 8))]

    want = jax.jit(jax_side)(jnp.asarray(x))
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), i
    vals = F.unpack(x)
    assert F.unpack(got[-1].reshape(F.n, -1)) == [pow(v, -1, P) for v in vals]


@pytest.fixture(scope="module")
def ed_ops():
    return EdwardsOps(port_params.ED_ON_BLS12_377), JaxEdwardsOps(ED_ON_BLS12_377)


def _ext_lanes():
    """Extended operand pairs (P_i, Q_i) of subgroup points with random Z,
    an identity lane, a doubling lane and a cancelling lane."""
    rng = np.random.default_rng(7)
    pts, _ = ed_points_with_logs(port_params.ED_ON_BLS12_377, 2 * B, seed=7)
    zs = [int.from_bytes(rng.bytes(40), "little") % P or 1 for _ in range(2 * B)]
    ext = [(x * z % P, y * z % P, z, x * y % P * z % P) for (x, y), z in zip(pts, zs)]
    Ps, Qs = ext[:B], ext[B:]
    Ps[1] = (0, 1, 1, 0)
    Qs[2] = Ps[2]
    Qs[3] = ((-Ps[3][0]) % P, Ps[3][1], Ps[3][2], (-Ps[3][3]) % P)
    return Ps, Qs, pts


def test_simple_digits_twin_matches_tpu_kernel():
    """K9's twin (the Edwards scalar prep) bit-exact against the TPU kernel
    in interpret mode and the JAX jnp path, zero digits with sign 0."""
    S = TwistedEdwards.create(port_params.ED_ON_BLS12_377).scalar
    s = S.pack(_ints(5, Q, 64, edges=(0, 1, Q - 1, Q // 2)))
    for c in (6, 11):
        K = -(-(S.bits + 1) // c)
        got = signed_digits(torch.as_tensor(s), c, K, 12)
        want = simple_digits_pallas(jnp.asarray(s), c, K, interpret=True)
        want_jnp = jax.jit(lambda a: jax_signed_digits(a, c, K, 12))(jnp.asarray(s))
        for g, w, wj in zip(got, want, want_jnp):
            assert np.array_equal(g.numpy(), np.asarray(w)) and np.array_equal(g.numpy(), np.asarray(wj)), c
        assert not got[1].numpy()[got[0].numpy() == 0].any()


def test_edwards_twins_match_jax(ed_ops):
    """K10-K12's twins and the curve ops against JAX EdwardsOps and
    EdwardsKernels(interpret=True), mod p; the port's parameters, host
    oracle and JAX carry-over."""
    E, J = ed_ops
    F = E.F
    Ps, Qs, pts = _ext_lanes()
    a = [F.pack([pt[i] for pt in Ps]) for i in range(4)]
    b = [F.pack([pt[i] for pt in Qs]) for i in range(4)]
    ta, tb = [torch.as_tensor(v) for v in a], [torch.as_tensor(v) for v in b]
    rng = np.random.default_rng(8)
    mask = rng.integers(0, 2, size=B, dtype=np.int32)
    flg = rng.integers(0, 2, size=(4, B), dtype=np.int32)
    flg[1, :2] = flg[3, :2] = 1  # both slots valid on the first lanes
    x = F.pack([pt[0] for pt in pts])
    y = F.pack([pt[1] for pt in pts])
    aff = (x[:, :B], y[:, :B], flg[0], flg[1], x[:, B:], y[:, B:], flg[2], flg[3])
    taff = [torch.as_tensor(v) for v in aff]

    def jax_side(a, b, m, aff):
        Pa, Pb = JaxExt(*a), JaxExt(*b)
        return (J.add(Pa, Pb), J.add(Pa, Pb, mask=m.astype(bool)), J.double_k(Pa, 3),
                J.ed_pair_add(*aff), J.batch_normalize(Pb), J.is_on_curve(Pa), J.eq(Pa, Pb))

    j = jax.jit(jax_side)(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), jnp.asarray(mask),
                          tuple(map(jnp.asarray, aff)))
    kern = EdwardsKernels(P, F.w, F.n, E.k_mont, interpret=True)
    kj = kern.ed_add(*map(jnp.asarray, a), *map(jnp.asarray, b), mask=jnp.asarray(mask))
    cases = {
        "K11 twin": (cuda_edwards.ed_add_plain(E, *ta, *tb), j[0]),
        "K11 twin, mask": (cuda_edwards.ed_add_plain(E, *ta, *tb, mask=torch.as_tensor(mask)), j[1]),
        "K11 vs TPU kernel, mask": (cuda_edwards.ed_add_plain(E, *ta, *tb, mask=torch.as_tensor(mask)), kj),
        "K12 twin": (cuda_edwards.ed_double_k_plain(E, *ta, 3), j[2]),
        "K12 via double_k": (E.double_k(ExtPoints(*ta), 3), j[2]),
        "K10 twin": (cuda_edwards.ed_pair_add_plain(E, *taff), j[3]),
        "K10 via ed_pair_add": (E.ed_pair_add(*taff), j[3]),
        "batch_normalize": (E.batch_normalize(ExtPoints(*tb)), j[4]),
    }
    for name, (got, want) in cases.items():
        assert [F.unpack(g) for g in got] == [F.unpack(np.asarray(w)) for w in want], name
    assert E.is_on_curve(ExtPoints(*ta)).tolist() == np.asarray(j[5]).tolist() == [True] * B
    assert E.eq(ExtPoints(*ta), ExtPoints(*tb)).tolist() == np.asarray(j[6]).tolist()
    C = EdwardsCurve(ED_ON_BLS12_377)
    added = E.unpack(E.add(ExtPoints(*ta), ExtPoints(*tb)))
    for i, R in enumerate(added):  # the group law itself
        assert C.eq(R, C.add(Ps[i], Qs[i])), i
    assert E.is_zero(E.add(ExtPoints(*ta), E.neg(ExtPoints(*ta)))).all()

    assert dataclasses.asdict(port_params.ED_ON_BLS12_377) == dataclasses.asdict(ED_ON_BLS12_377)
    for Pa, Qa in zip(pts[:B], pts[B:]):
        assert ed_add(port_params.ED_ON_BLS12_377, Pa, Qa) == C.to_affine(C.add(C.from_affine(Pa), C.from_affine(Qa)))
    scs = _ints(9, Q, 4)
    G = C.from_affine(ED_ON_BLS12_377.generator)
    assert C.is_zero(C.scale(Q, G))  # the walk stays in the generator's subgroup
    _, logs = ed_points_with_logs(port_params.ED_ON_BLS12_377, 2 * B, seed=7)
    want = C.to_affine(msm_oracle(C, scs, [C.from_affine(p) for p in pts[:4]], Q.bit_length()))
    assert ed_naive_msm(port_params.ED_ON_BLS12_377, scs, pts[:4]) == want
    assert ed_expected_msm(port_params.ED_ON_BLS12_377, scs, logs[:4]) == want

    jp = JaxTwistedEdwards.create(ED_ON_BLS12_377).points_from_ints(pts)
    got = ext_from_jax(*(np.asarray(v) for v in jp), F, "cpu")
    assert [F.unpack(g) for g in got] == [F.unpack(np.asarray(v)) for v in jp]
    with pytest.raises(ValueError):
        ext_from_jax(*(np.asarray(v) for v in jp[:3]), np.asarray(jp.T)[:, :3], F, "cpu")
    with pytest.raises(ValueError):
        ext_from_jax(*(np.asarray(v).astype(np.int64) for v in jp), F, "cpu")


@pytest.fixture(scope="module")
def ed_curves():
    return TwistedEdwards.create(port_params.ED_ON_BLS12_377), JaxTwistedEdwards.create(ED_ON_BLS12_377)


def _oracle(scs, pts):
    C = EdwardsCurve(ED_ON_BLS12_377)
    return C.to_affine(msm_oracle(C, scs, [C.from_affine(p) for p in pts], Q.bit_length()))


@pytest.mark.parametrize("N", [1, 8, 64])
def test_edwards_msm_matches_bigint_oracle(ed_curves, N):
    """TwistedEdwards.msm on the CPU against the bigint Pippenger oracle and
    the known logs; inputs packed by the JAX package and carried over."""
    port, jax_curve = ed_curves
    pts, logs = ed_points_with_logs(port_params.ED_ON_BLS12_377, N, seed=N)
    scs = _ints(N, Q, N)
    jp = jax_curve.points_from_ints(pts)
    points = ext_from_jax(*(np.asarray(v) for v in jp), port.ops.F, "cpu")
    scalars = scalars_from_jax(np.asarray(jax_curve.scalars_from_ints(scs)), port.scalar, "cpu")
    got = port.result_to_int(port.msm(scalars, points))
    assert got == _oracle(scs, pts) == ed_expected_msm(port_params.ED_ON_BLS12_377, scs, logs)


EDGE_CASES = {  # scalars and indices into three known points
    "duplicates": ([5, 11], [0, 0]),
    "cancellation": ([3, Q - 3], [1, 1]),
    "zero_scalars": ([0, 0, 0], [0, 1, 2]),
    "single_point": ([987654321], [2]),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edwards_msm_edge_cases(ed_curves, case):
    """The JAX package's MSM edge cases through msm_bigint against the
    oracle (all zero scalars give the identity (0, 1), in the halving mode
    too); an unknown mode raises."""
    port, _ = ed_curves
    pts, _ = ed_points_with_logs(port_params.ED_ON_BLS12_377, 3, seed=5)
    scs, idx = EDGE_CASES[case]
    points = [pts[i] for i in idx]
    got = port.msm_bigint(scs, points, "cpu")
    assert got == _oracle(scs, points) == ed_naive_msm(port_params.ED_ON_BLS12_377, scs, points)
    if case == "zero_scalars":
        assert got == (0, 1)
        args = (port.scalars_from_ints(scs, "cpu"), port.points_from_ints(points, "cpu"))
        assert port.result_to_int(port.msm(*args, mode="basic")) == (0, 1)
        with pytest.raises(ValueError, match="mode"):
            port.msm(*args, mode="halving")
