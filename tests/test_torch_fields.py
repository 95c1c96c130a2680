"""The port's limb codec and field engine against the JAX package.

Inputs are made with numpy from a seed (plus the edge values 0, p-1, 2p-1,
4p-1 where an op's domain allows them) and given to both sides. Tolerance:
exact equality, limb for limb; both sides return canonical limbs of the
same representative (the Montgomery product is the unique (x*y + q*p)/R).
The K1 kernel itself runs on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msm_zprize_tpu.curves.example_fields import EXAMPLE_FIELDS
from msm_zprize_tpu.curves.params import BLS12_377, BLS12_381
from msm_zprize_tpu.fields import limbs as JL
from msm_zprize_tpu.fields.fp import make_field as jax_field
from msm_zprize_tpu.fields.pallas_mul import _mm_rows
from msm_zprize_tpu_torch import _build
from msm_zprize_tpu_torch.counters import COUNTS
from msm_zprize_tpu_torch.fields import cuda_mul
from msm_zprize_tpu_torch.fields import limbs as TL
from msm_zprize_tpu_torch.fields.fp import make_field

torch.set_num_threads(1)

P = BLS12_377.modulus
B = 64


def _ints(seed, bound, count=B, edges=()):
    rng = np.random.default_rng(seed)
    vals = [v for v in edges if v < bound]
    vals += [int.from_bytes(rng.bytes(56), "little") % bound for _ in range(count - len(vals))]
    return vals


@pytest.fixture(scope="module")
def fields():
    return make_field(P), jax_field(P)


# op name, arity, value bound of its inputs (its domain)
OPS = [
    ("add", 2, 2 * P), ("sub", 2, 2 * P), ("sub_positive", 2, 2 * P),
    ("montmul", 2, 4 * P), ("is_equal", 2, 4 * P),
    ("neg", 1, 2 * P), ("canon", 1, 1 << 384), ("reduce", 1, 2 * P),
    ("fully_reduce", 1, 4 * P), ("is_zero", 1, 4 * P), ("montsquare", 1, 4 * P),
    ("to_montgomery", 1, 2 * P), ("from_montgomery", 1, 2 * P),
]


def test_limbs_and_field_ops_match_jax(fields):
    """Limb codec and helpers, then every MontgomeryFp op of the slice on
    its whole input domain, edge values paired with random ones."""
    scheme_t, scheme_j = TL.LimbScheme(12, 32), JL.LimbScheme(12, 32)
    vals = _ints(1, 1 << 384, edges=(0, 1, (1 << 384) - 1))
    packed = TL.pack(vals, scheme_t)
    assert np.array_equal(packed, JL.pack(vals, scheme_j))
    assert TL.unpack(torch.as_tensor(packed), scheme_t) == JL.unpack(packed, scheme_j) == vals

    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 12, size=(22, B), dtype=np.int32)
    y = rng.integers(0, 1 << 12, size=(13, B), dtype=np.int32)

    def helpers(L, x, y):
        return (
            L.mul_low(x, y, 12, 13), L.mul_shift_floor(x, y, 12, 23, 12),
            L.add_mod_pow2(x, x, 12, 13), L.sub_mod_pow2(y, x, 12, 13),
            L.negate_mod_pow2(x, 12, 13), L.extract_bits(x, 29, 12, 12),
        )

    got = helpers(TL, torch.as_tensor(x), torch.as_tensor(y))
    want = jax.jit(lambda a, b: helpers(JL, a, b))(jnp.asarray(x), jnp.asarray(y))
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), i

    F, J = fields
    edges = (0, P - 1, 2 * P - 1, 4 * P - 1)
    args = {}
    for name, arity, bound in OPS:
        a = [F.pack(_ints(10 + i, bound, edges=edges), montgomery=False) for i in range(arity)]
        a[-1] = a[-1][:, ::-1].copy()  # pair edge values with random ones
        args[name] = a
    got = {name: getattr(F, name)(*map(torch.as_tensor, a)) for name, a in args.items()}
    want = jax.jit(lambda t: {name: getattr(J, name)(*a) for name, a in t.items()})(
        {name: [jnp.asarray(x) for x in a] for name, a in args.items()})
    for name in args:
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name


def test_montmul_twin_kernel_body_fields_and_dispatch(fields):
    """The K1 twin against the TPU kernel's algebra (``_mm_rows``, the body
    ``montmul_pallas`` runs) evaluated eagerly (interpret mode computes the
    same function but takes ~40 s to compile at n = 32); the plain field
    ops at limb counts that are not a multiple of the carry group (n = 3,
    6, 22, 33); CPU tensors take the twin and launch nothing; the kernels take
    BLS12-381's field in a shape of its own and refuse fields no shape
    fits, and other devices."""
    F, J = fields
    x = F.pack(_ints(20, 4 * P, edges=(0, 4 * P - 1)), montgomery=False)
    y = F.pack(_ints(21, 4 * P, edges=(4 * P - 1, 1)), montgomery=False)
    pn = (-pow(P, -1, J.R)) % J.R
    rows = _mm_rows(
        [jnp.asarray(x[i]) for i in range(32)], [jnp.asarray(y[i]) for i in range(32)],
        n=32, w=12, mask=J.mask, p_ints=tuple(int(v) for v in J.p_limbs),
        pn_ints=tuple(J.scheme.to_limbs(pn)),
    )
    got = F.montmul_plain(torch.as_tensor(x), torch.as_tensor(y))
    assert np.array_equal(got.numpy(), np.asarray(jnp.stack(rows)))

    fields = [(name, EXAMPLE_FIELDS[name]) for name in ("babybear", "goldilocks", "pasta-fp")]
    for name, p in fields + [("bls12-381", BLS12_381.modulus)]:
        Fo, Jo = make_field(p), jax_field(p)
        for G, H in ((Fo, Jo), (F, J)):  # the same limb layout and constants
            assert (G.n, G.mask, G.R, G.R2, G.mont_one) == (H.n, H.mask, H.R, H.R2, H.mont_one), name
            assert np.array_equal(G.p_limbs, H.p_limbs) and np.array_equal(G.two_p_limbs, H.two_p_limbs)
        x, y = (Fo.pack(_ints(50 + i, 4 * p, edges=(0, 4 * p - 1)), montgomery=False) for i in range(2))
        # add and sub take values < 2p
        x2, y2 = (Fo.pack([v % (2 * p) for v in Fo.unpack(a, montgomery=False, reduce=False)],
                          montgomery=False) for a in (x, y))

        def ops(G, x, y, x2, y2):
            return G.montmul(x, y), G.add(x2, y2), G.sub(x2, y2), G.fully_reduce(x)

        got = ops(Fo, *map(torch.as_tensor, (x, y, x2, y2)))
        want = jax.jit(lambda *a: ops(Jo, *a))(*map(jnp.asarray, (x, y, x2, y2)))
        for op, g, w in zip(("montmul", "add", "sub", "fully_reduce"), got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (name, op)

    xs = torch.as_tensor(F.pack(_ints(30, P)))
    before = COUNTS["k1_montmul"]
    assert torch.equal(F.montmul(xs, xs[:, :1]), F.montmul_plain(xs, xs[:, :1]))
    assert COUNTS["k1_montmul"] == before  # no kernel launch on CPU tensors

    # BLS12-381's field has a shape of its own (n = 33, R = 2^396); a field
    # of n = 33 whose 4p exceeds 12 words has none
    assert _build.field_shape(make_field(BLS12_381.modulus)) == 3
    with pytest.raises(ValueError, match="2\\^384"):
        _build.field_words(make_field((1 << 382) + 3))
    z = torch.zeros((32, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        cuda_mul.montmul(F, z, torch.zeros((32, 4), dtype=torch.int32, device="meta"))
