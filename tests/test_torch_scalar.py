"""The port's scalar prep (the K2 twin) against the JAX package.

``glv_digits_plain`` (GlvScalar.decompose + signed_digits in torch) must be
BIT-exact against the JAX jnp path and against the TPU kernel's body
(``pallas_scalar._scalar_kernel``), zero digits with sign 0 included.
Inputs are numpy-seeded scalars plus the edges 0, 1, q-1, q/2. The K2
kernel itself runs on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msm_zprize_tpu.bigint import glv as glv_oracle
from msm_zprize_tpu.curves.pallas_curve import _ValRef
from msm_zprize_tpu.curves.params import BLS12_377
from msm_zprize_tpu.fields.pallas_scalar import _scalar_kernel
from msm_zprize_tpu.fields.scalar import make_glv_scalar as jax_glv_scalar
from msm_zprize_tpu.fields.scalar import signed_digits as jax_signed_digits
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch.fields.cuda_scalar import glv_digits, glv_digits_plain
from msm_zprize_tpu_torch.fields.scalar import glv_basis, make_glv_scalar
from msm_zprize_tpu_torch.parallel.api import Weierstrass

torch.set_num_threads(1)

Q = BLS12_377.order
N = 64


def _scalars(seed, count=N):
    rng = np.random.default_rng(seed)
    vals = [0, 1, Q - 1, Q // 2]
    vals += [int.from_bytes(rng.bytes(40), "little") % Q for _ in range(count - len(vals))]
    return vals


@pytest.fixture(scope="module")
def modules():
    return make_glv_scalar(Q, BLS12_377.lambda_), jax_glv_scalar(Q, BLS12_377.lambda_)


def _jax_digits(J, s, c, K):
    sg0, u0, sg1, u1 = J.decompose(jnp.asarray(s))
    m0, s0 = jax_signed_digits(u0, c, K, J.w, scalar_sign=sg0)
    m1, s1 = jax_signed_digits(u1, c, K, J.w, scalar_sign=sg1)
    return np.concatenate([m0, m1], axis=-1), np.concatenate([s0, s1], axis=-1)


def test_scalar_prep_matches_jax(modules):
    """glv_digits_plain against the JAX jnp path at c = 8 and 12 and against
    the TPU kernel's body (evaluated eagerly on whole arrays: the function
    ``glv_digits_pallas`` runs, minus the pallas_call plumbing), through the
    K2 wrapper, which takes the twin for CPU tensors; the decomposition is a
    GLV split; random_scalars gives the JAX package's limbs for one seed."""
    S, J = modules
    for c in (8, 12):
        s = S.pack(_scalars(c))
        K = -(-(S.max_bits + 1) // c)
        mags, signs = glv_digits_plain(S, torch.as_tensor(s), c, K)
        want_m, want_s = _jax_digits(J, s, c, K)
        assert np.array_equal(mags.numpy(), want_m), c
        assert np.array_equal(signs.numpy(), want_s), c
        assert not (signs.numpy()[mags.numpy() == 0]).any()  # zero digits: sign 0

    c = 12
    K = -(-(S.max_bits + 1) // c)
    s = S.pack(_scalars(3))
    mag_ref = _ValRef(jnp.zeros((2 * K, N), jnp.int32))
    sgn_ref = _ValRef(jnp.zeros((2 * K, N), jnp.int32))
    _scalar_kernel(jnp.asarray(s), mag_ref, sgn_ref, S=J, c=c, K=K)
    mags, signs = glv_digits(S, torch.as_tensor(s), c, K)
    assert np.array_equal(mags.numpy(), np.concatenate([mag_ref.val[:K], mag_ref.val[K:]], axis=-1))
    assert np.array_equal(signs.numpy(), np.concatenate([sgn_ref.val[:K], sgn_ref.val[K:]], axis=-1))

    # s == (-1)^g0 u0 + lambda (-1)^g1 u1 (mod q) with half-size u_i. (The
    # rounded multipliers may pick a different lattice point than the exact
    # bigint oracle, so the split is checked, not the oracle's halves.)
    vals = _scalars(4, count=16)
    sign0, u0, sign1, u1 = S.decompose(torch.as_tensor(S.pack(vals)))
    lam = BLS12_377.lambda_
    for v, g0, a0, g1, a1 in zip(vals, sign0.tolist(), S.unpack_half(u0),
                                 sign1.tolist(), S.unpack_half(u1)):
        assert ((-1) ** g0 * a0 + lam * (-1) ** g1 * a1 - v) % Q == 0
        assert max(a0, a1).bit_length() <= S.max_bits
    g = glv_oracle.glv_params(Q, lam)  # the port's own lattice basis is the JAX package's
    assert glv_basis(Q, lam) == ((g.v00, g.v01), (g.v10, g.v11), g.det, g.max_bits)
    assert S.max_bits == g.max_bits + 2

    got = Weierstrass.create(BLS12_377).random_scalars(N, seed=11)
    want = JaxWeierstrass.create(BLS12_377).random_scalars(N, seed=11)
    assert np.array_equal(got.numpy(), np.asarray(want))
