"""The port's codec storage modes against the JAX package, on the CPU.

* ``fields/codec.py``: widths, offsets, rows, ``pack``/``unpack`` equal the
  JAX ``PackedCodec``/``Fma51Codec`` for BLS12-377, ed-on-bls12-377 and
  Pallas; ``to_digits``/``from_digits`` equal JAX's limb for limb on
  numpy-seeded values with 0, 1, p and 2p - 1 among them (above 2p the
  port reduces into [0, 2p): checked mod p).
* K13's twin (``montmul_rows_plain``) against ``montmul51_pallas(interpret=
  True)`` on both codecs, and the bigint product: equal mod p, below 2p.
* K14's twins on ``PackedCodec`` storage (``cuda_curve.*_plain`` with
  ``PackedWeierstrassOps``): K4's against ``PackedWeierstrassOps(BLS12_377,
  interpret=True).kernels.proj_add``, equal mod p after ``unpack``; those of
  K3, K5 (k = 2), K4m, K6 and K7 against the port's native twins (held
  against the TPU kernels in ``test_torch_curve.py`` and
  ``test_torch_modes.py``) through ``to_native`` (mod p), the pass-through
  lanes of K4m and K7 bit for bit.
* ``coord_cneg``, ``pack_affine`` and the row carry-over against JAX: row
  for row.
* ``msm(mode="packed")`` at N in {1, 8, 64} on inputs packed by the JAX
  package, and ``msm_unsafe(mode="packed")`` on an edge input (zero
  scalars, a duplicated point, infinity), against the bigint Pippenger
  oracle and the known discrete logs, and equal to the default mode;
  ``mode="fma51"`` on BLS12-377 raises.
* ``compute_msm`` with int, bytes and uint8-array inputs, without a
  duplicated point (``msm_unsafe``) and with one (``msm``), against the same
  oracle.

No whole-MSM JAX run in a codec mode: its interpret-mode compiles take tens
of minutes, and one interpret-mode K14 kernel (~12 s) stands for the
template the others share. Twelve test items, one per case: the CPU
suite's wall time follows its item count, and the replay of pytest-xdist's
scheduler in ``PERF.md`` chose the count. The CUDA kernels run on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.bigint.weierstrass import ProjectiveCurve
from msm_zprize_tpu.curves import weierstrass51 as J51
from msm_zprize_tpu.curves.params import BLS12_377, ED_ON_BLS12_377, PALLAS
from msm_zprize_tpu.fields import fma51_pallas as JF
from msm_zprize_tpu.fields.pallas_field import FieldCtx
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch.curves import cuda_curve
from msm_zprize_tpu_torch.fields import codec as TC
from msm_zprize_tpu_torch.fields.cuda_codec import montmul_rows_plain
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.parallel.api import Weierstrass
from msm_zprize_tpu_torch.submission import compute_msm
from msm_zprize_tpu_torch.testing.points import expected_msm, points_with_logs
from msm_zprize_tpu_torch.utils.convert import affine_from_jax, affine_rows_from_jax, scalars_from_jax

torch.set_num_threads(1)

P, Q = BLS12_377.modulus, BLS12_377.order
B = 8
C = ProjectiveCurve(BLS12_377)


def _rand(rng, bound, count):
    return [int.from_bytes(rng.bytes(48), "little") % bound for _ in range(count)]


def _mod_p(codec, p, arr, r_inv=1):
    return [v * r_inv % p for v in codec.unpack(np.asarray(arr))]


def _oracle(scs, pts):
    return C.to_affine(msm_oracle(C, scs, [C.from_affine(Pt) for Pt in pts], Q.bit_length()))


# ---- codecs -----------------------------------------------------------------------


def _check_codecs():
    rng = np.random.default_rng(1)
    cases = [
        (JF.PackedCodec(P), TC.PackedCodec(P)),
        (JF.PackedCodec(ED_ON_BLS12_377.modulus), TC.PackedCodec(ED_ON_BLS12_377.modulus)),
        (JF.Fma51Codec(ED_ON_BLS12_377.modulus), TC.Fma51Codec(ED_ON_BLS12_377.modulus)),
        (JF.Fma51Codec(PALLAS.modulus), TC.Fma51Codec(PALLAS.modulus)),
    ]
    for jc, tc in cases:
        name = (type(tc).__name__, tc.p.bit_length())
        assert (tc.widths, tc.offsets, tc.rows, tc.capacity_bits) == (
            jc.widths, jc.offsets, jc.rows, jc.capacity_bits), name
        p = tc.p
        F = make_field(p)
        vals = [0, 1, p, 2 * p - 1] + _rand(rng, 2 * p, 12)
        rows = tc.pack(vals)
        assert np.array_equal(rows, jc.pack(vals)) and tc.unpack(rows) == vals == jc.unpack(rows), name
        assert (rows >= 0).all() and (rows < (1 << np.array(tc.widths))[:, None]).all(), name
        ctx = FieldCtx(p, 12, F.n)
        digits = np.array([F.scheme.to_limbs(v) for v in vals], dtype=np.int32).T
        got = tc.to_digits(F, torch.as_tensor(rows)).numpy()
        assert np.array_equal(got, np.asarray(jc.to_digits(ctx, jnp.asarray(rows)))), name
        assert np.array_equal(got, digits), name
        got = tc.from_digits(F, torch.as_tensor(digits)).numpy()
        assert np.array_equal(got, np.asarray(jc.from_digits(ctx, jnp.asarray(digits), 2 * p - 1))), name
        # a value up to 4p with vmax = 4p - 1: reduced into [0, 2p)
        vals4 = [2 * p, 3 * p + 5, 4 * p - 1] + _rand(rng, 4 * p, 5)
        dig4 = torch.as_tensor(np.array([F.scheme.to_limbs(v) for v in vals4], dtype=np.int32).T)
        out = tc.unpack(tc.from_digits(F, dig4, 4 * p - 1))
        assert all(o < 2 * p and o % p == v % p for o, v in zip(out, vals4)), name
        if isinstance(tc, TC.Fma51Codec):
            limbs51 = [int(v) for v in rng.integers(0, 1 << 51, size=5, dtype=np.int64)]
            assert tc.pack51(limbs51) == jc.pack51(limbs51), name
    with pytest.raises(ValueError, match="2\\^255"):
        TC.Fma51Codec(P)
    assert TC.codec_id(TC.PackedCodec(P)) == 1 and TC.codec_id(TC.Fma51Codec(PALLAS.modulus)) == 2


# ---- K13 ------------------------------------------------------------------------


def _check_k13():
    """montmul_rows_plain against montmul51_pallas in interpret mode and the
    bigint product x y R^-1 mod p (R = 2^(12 n)), values below 2p."""
    rng = np.random.default_rng(2)
    for p, codecs in ((P, ((JF.PackedCodec(P), TC.PackedCodec(P)),)),
                      (ED_ON_BLS12_377.modulus, ((JF.Fma51Codec(ED_ON_BLS12_377.modulus),
                                                  TC.Fma51Codec(ED_ON_BLS12_377.modulus)),))):
        F = make_field(p)
        r_inv = pow(F.R, -1, p)
        xs, ys = [0, 2 * p - 1] + _rand(rng, 2 * p, 10), [5, 2 * p - 1] + _rand(rng, 2 * p, 10)
        for jc, tc in codecs:
            x, y = tc.pack(xs), tc.pack(ys)
            got = tc.unpack(montmul_rows_plain(F, tc, torch.as_tensor(x), torch.as_tensor(y)))
            want = jc.unpack(JF.montmul51_pallas(p, jnp.asarray(x), jnp.asarray(y), interpret=True,
                                                 codec=jc))
            assert all(g < 2 * p for g in got), type(tc).__name__
            assert [g % p for g in got] == [w % p for w in want] == [
                a * b * r_inv % p for a, b in zip(xs, ys)], type(tc).__name__


# ---- K14 -----------------------------------------------------------------------


def _k14_inputs():
    """Six coordinate row batches (values < p) and four flag vectors, as
    numpy, from one seed."""
    rng = np.random.default_rng(3)
    codec = TC.PackedCodec(P)
    vals = [codec.pack(_rand(rng, P, B)) for _ in range(6)]
    flags = [np.array(f, np.int32) for f in ([1, 0, 1, 1, 0, 0, 1, 0], [1, 1, 0, 1, 0, 1, 1, 0],
                                             [0, 1, 1, 0, 1, 1, 0, 1], [1, 1, 1, 0, 0, 1, 0, 1])]
    return vals, flags


def _check_k14_vs_tpu_kernel(curve):
    """K4's twin on PackedCodec rows against the interpret-mode TPU kernel:
    equal mod p after unpack, outputs below 2p."""
    Wp = curve.ops_packed
    codec = Wp.codec
    r_inv = pow(Wp.F.R, -1, P)
    vals, _ = _k14_inputs()
    kern = J51.PackedWeierstrassOps(BLS12_377, interpret=True).kernels
    got = cuda_curve.proj_add_plain(Wp, *map(torch.as_tensor, vals))
    want = kern.proj_add(*map(jnp.asarray, vals))
    for g, w in zip(got, want):
        assert _mod_p(codec, P, g, r_inv) == _mod_p(codec, P, w, r_inv)
        assert all(v < 2 * P for v in codec.unpack(g))


def _check_k14_vs_native(curve, kernels):
    """The codec twins of ``kernels`` against the native twins on the same
    values: equal mod p through to_native, outputs below 2p, and the
    pass-through lanes of K4m and K7 the caller's rows bit for bit."""
    Wp, W = curve.ops_packed, curve.ops
    F, codec = Wp.F, Wp.codec
    vals, flags = _k14_inputs()
    tv, fv = [torch.as_tensor(v) for v in vals], [torch.as_tensor(f) for f in flags]
    nat = [Wp.to_native(t) for t in tv]
    m, inf = fv[0], fv[1]
    run = {
        "K3": lambda W_, a: (cuda_curve.aff_pair_add_plain(W_, a[0], a[1], fv[0], fv[1], a[2], a[3],
                                                           fv[2], fv[3]), None),
        "K5": lambda W_, a: (cuda_curve.proj_double_k_plain(W_, *a[:3], 2), None),
        "K4m": lambda W_, a: (cuda_curve.proj_add_plain(W_, *a, mask=m), m == 0),
        "K6": lambda W_, a: (cuda_curve.proj_double_plain(W_, *a[:3]), None),
        "K7": lambda W_, a: (cuda_curve.proj_add_mixed_plain(W_, *a[:5], inf), inf == 1),
    }
    for name in kernels:
        (got, passed), (want, _) = run[name](Wp, tv), run[name](W, nat)
        for g, w in zip(got, want):
            assert torch.equal(F.fully_reduce(Wp.to_native(g)), F.fully_reduce(w)), name
            assert all(v < 2 * P for v in codec.unpack(g)), name
        if passed is not None:
            for g, a in zip(got, tv[:3]):
                assert torch.equal(g[:, passed], a[:, passed]), name


def _check_k14_twins_and_glue(curve):
    Wp = curve.ops_packed
    codec = Wp.codec
    r_inv = pow(Wp.F.R, -1, P)
    vals, _ = _k14_inputs()
    _check_k14_vs_native(curve, ("K4m", "K6", "K7"))

    # the glue: coord_cneg (y = 0 stays 0), proj_zeros, pack_affine, the carry-over
    Jp = JaxWeierstrass.create(BLS12_377).ops_packed
    y = vals[0].copy()
    y[:, 3] = 0
    flag = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    got = Wp.coord_cneg(torch.as_tensor(y), torch.as_tensor(flag))
    assert np.array_equal(got.numpy(), np.asarray(Jp.coord_cneg(jnp.asarray(y), jnp.asarray(flag))))
    assert Wp.unpack_projective(Wp.proj_zeros(2, device="cpu")) == [(0, 1, 0)] * 2
    pts = points_with_logs(BLS12_377, B, seed=4)[0] + [None]
    jp = Jp.pack_affine(pts)
    tp = affine_rows_from_jax(np.asarray(jp.x), np.asarray(jp.y), np.asarray(jp.inf), codec, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tp, Wp.pack_affine(pts, "cpu")))
    with pytest.raises(ValueError):
        bad = np.asarray(jp.x).copy()
        bad[0, 0] = -1
        affine_rows_from_jax(bad, np.asarray(jp.y), np.asarray(jp.inf), codec, "cpu")
    # endomorphism (K13's twin on the path): beta x
    bx = Wp.endomorphism(tp)
    got = list(zip(_mod_p(codec, P, bx.x, r_inv), _mod_p(codec, P, bx.y, r_inv)))
    for g, Pt in zip(got, pts):
        assert Pt is None or g == (BLS12_377.beta * Pt[0] % P, Pt[1])


# ---- the packed MSM and compute_msm ----------------------------------------------


def _check_msm(curve, N):
    """msm(mode="packed") on inputs packed by the JAX package; at N = 8 also
    compute_msm on distinct points (msm_unsafe), at N = 64 the default mode."""
    jax_curve = JaxWeierstrass.create(BLS12_377)
    pts, logs = points_with_logs(BLS12_377, N, seed=N)
    rng = np.random.default_rng(N)
    scs = [int.from_bytes(rng.bytes(40), "little") % Q for _ in range(N)]
    jp = jax_curve.points_from_ints(pts)
    points = affine_from_jax(np.asarray(jp.x), np.asarray(jp.y), np.asarray(jp.inf), curve.ops.F, "cpu")
    scalars = scalars_from_jax(np.asarray(jax_curve.scalars_from_ints(scs)), curve.scalar, "cpu")
    want = _oracle(scs, pts)
    assert want == expected_msm(BLS12_377, scs, logs)
    assert curve.result_to_int(curve.msm(scalars, points, mode="packed")) == want, N
    if N == 8:  # ints, bytes scalars
        assert compute_msm(pts, [v.to_bytes(32, "little") for v in scs], mode="packed",
                           device="cpu") == want
    if N == 64:
        assert curve.result_to_int(curve.msm(scalars, points)) == want


def _edge():
    """Zero scalars, a duplicated point, infinity."""
    pts, _ = points_with_logs(BLS12_377, 3, seed=5)
    return [0, 5, 11, 7, 0, 3], [pts[0], pts[1], pts[1], None, pts[2], pts[0]]


def _check_edge_unsafe(curve):
    scs, points = _edge()
    s, p = curve.scalars_from_ints(scs, "cpu"), curve.points_from_ints(points, "cpu")
    assert curve.result_to_int(curve.msm_unsafe(s, p, mode="packed")) == _oracle(scs, points)


def _check_edge_compute_msm(curve):
    """A duplicated point: compute_msm takes the safe msm (bytes points,
    uint8-array scalars; ints in the default mode)."""
    scs, points = _edge()
    as_bytes = [None if Pt is None else (Pt[0].to_bytes(48, "little"), Pt[1].to_bytes(48, "little"))
                for Pt in points]
    sc_array = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in scs), np.uint8).reshape(-1, 32)
    assert compute_msm(as_bytes, sc_array, mode="packed", device="cpu") == _oracle(scs, points)
    assert compute_msm(points[1:4], scs[1:4], device="cpu") == _oracle(scs[1:4], points[1:4])
    assert compute_msm([], [], device="cpu") is None
    with pytest.raises(ValueError):
        compute_msm(points, scs[:2], device="cpu")


def _check_fma51_refused(curve):
    scs, points = _edge()
    s, p = curve.scalars_from_ints(scs, "cpu"), curve.points_from_ints(points, "cpu")
    with pytest.raises(ValueError, match="255-bit ceiling.*only Pallas"):
        curve.msm(s, p, mode="fma51")


# One item per case: the replay of pytest-xdist's scheduler (PERF.md)
# put 12 items of this file at the lowest predicted wall of the CPU suite.
CASES = {
    "codecs": lambda curve: _check_codecs(),
    "k13": lambda curve: _check_k13(),
    "k14_k4_vs_tpu": _check_k14_vs_tpu_kernel,
    "k14_k3_vs_native": lambda curve: _check_k14_vs_native(curve, ("K3",)),
    "k14_k5_vs_native": lambda curve: _check_k14_vs_native(curve, ("K5",)),
    "k14_twins_and_glue": _check_k14_twins_and_glue,
    "msm_n1": lambda curve: _check_msm(curve, 1),
    "msm_n8_compute_msm": lambda curve: _check_msm(curve, 8),
    "msm_n64_default_mode": lambda curve: _check_msm(curve, 64),
    "edge_msm_unsafe": _check_edge_unsafe,
    "edge_compute_msm": _check_edge_compute_msm,
    "fma51_refused": _check_fma51_refused,
}


@pytest.mark.parametrize("case", list(CASES))
def test_codec_modes_match_jax_and_oracles(case):
    CASES[case](Weierstrass.create(BLS12_377))
