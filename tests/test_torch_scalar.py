"""The port's scalar prep (the K2 twin) against the JAX package.

``glv_digits_plain`` (GlvScalar.decompose + signed_digits in torch) must be
BIT-exact against the JAX jnp path and against the TPU kernel's body
(``pallas_scalar._scalar_kernel``), zero digits with sign 0 included.
Inputs are numpy-seeded scalars plus the edges 0, 1, q-1, q/2. A Python
model of the K2 kernel's word algorithm (``csrc/glv_digits.cu``: the
constants as ``_const_words`` packs them, the 276-bit shift as 8 words + 20
bits, the 2^144 and 2^156 truncations, the digits streamed from a bit
buffer, the infinity mask) must be bit-exact against both on BLS12-377's,
BLS12-381's and Pallas's scalars. The K2 kernel itself runs on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msm_zprize_tpu.bigint import glv as glv_oracle
from msm_zprize_tpu.curves.pallas_curve import _ValRef
from msm_zprize_tpu.curves.params import BLS12_377, BLS12_381, PALLAS
from msm_zprize_tpu.fields.pallas_scalar import _scalar_kernel
from msm_zprize_tpu.fields.scalar import make_glv_scalar as jax_glv_scalar
from msm_zprize_tpu.fields.scalar import signed_digits as jax_signed_digits
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch.fields.cuda_scalar import _const_words, glv_digits, glv_digits_plain
from msm_zprize_tpu_torch.fields.scalar import glv_basis, make_glv_scalar
from msm_zprize_tpu_torch.parallel.api import Weierstrass

torch.set_num_threads(1)

Q = BLS12_377.order
N = 64


def _scalars(seed, count=N, q=Q):
    rng = np.random.default_rng(seed)
    vals = [0, 1, q - 1, q // 2]
    vals += [int.from_bytes(rng.bytes(40), "little") % q for _ in range(count - len(vals))]
    return vals


def _word_model(words, limbs, c, K, inf=None):
    """K2's word algorithm (csrc/glv_digits.cu) in Python ints on the
    GlvConsts words: s in 8 words; u_i = words 8..12 of the 8 x 5-word
    product s m_i shifted right by 20 bits (276 = 8 x 32 + 20), masked to
    2^144; the four products u_i |v| and the combines modulo 2^160, the sign
    bit 155 (the limb path's 2^156 accumulator), the magnitude's low 132
    bits; c-bit windows from a 64-bit buffer refilled a word at a time;
    magnitude 0 where ``inf`` flags the column."""
    M32, MOD = (1 << 32) - 1, 1 << 160
    val = lambda ws: sum(w << (32 * i) for i, w in enumerate(ws))
    sg = [w - (1 << 32) if w >> 31 else w for w in words[5:9]]
    m = [val(words[9:14]), val(words[14:19])]
    v = [val(words[19 + 5 * k:24 + 5 * k]) for k in range(4)]
    N = limbs.shape[1]
    mags, signs = np.zeros((K, 2 * N), np.int32), np.zeros((K, 2 * N), np.int32)
    for col in range(N):
        s = sum(int(x) << (12 * i) for i, x in enumerate(limbs[:, col])) & ((1 << 256) - 1)
        u = []
        for mi in m:
            pw = [(s * mi >> (32 * k)) & M32 for k in range(13)]
            uw = [(pw[8 + k] >> 20) | ((pw[9 + k] << 12) & M32 if k < 4 else 0) for k in range(5)]
            uw[4] &= (1 << 16) - 1
            u.append(val(uw))
        acc = [s % MOD, 0]
        for (ui, h), sgn, vk in zip(((0, 0), (1, 0), (0, 1), (1, 1)), sg, v):
            t = u[ui] * vk % MOD
            acc[h] = (acc[h] - t if sgn > 0 else acc[h] + t) % MOD
        for h in range(2):
            top = acc[h] >> 155 & 1
            mag = (-acc[h] % MOD if top else acc[h]) & ((1 << 132) - 1)
            queue = [mag >> (32 * k) & M32 for k in range(1, 5)]
            buf, have, carry = mag & M32, 32, 0
            for k in range(K):
                if have < c:
                    buf |= (queue.pop(0) if queue else 0) << have
                    have += 32
                l = (buf & ((1 << c) - 1)) + carry
                buf, have = buf >> c, have - c
                carry = int(l > 1 << (c - 1))
                d = (1 << c) - l if carry else l
                mags[k, h * N + col] = 0 if inf is not None and inf[h * N + col] else d
                signs[k, h * N + col] = 0 if d == 0 else carry ^ top
    return mags, signs


@pytest.fixture(scope="module")
def modules():
    return make_glv_scalar(Q, BLS12_377.lambda_), jax_glv_scalar(Q, BLS12_377.lambda_)


def _jax_digits(J, s, c, K):
    sg0, u0, sg1, u1 = J.decompose(jnp.asarray(s))
    m0, s0 = jax_signed_digits(u0, c, K, J.w, scalar_sign=sg0)
    m1, s1 = jax_signed_digits(u1, c, K, J.w, scalar_sign=sg1)
    return np.concatenate([m0, m1], axis=-1), np.concatenate([s0, s1], axis=-1)


def _tpu_body(J, s, c, K):
    """The TPU kernel's body on whole arrays (``glv_digits_pallas`` minus the
    pallas_call plumbing): (K, 2N) magnitude and sign planes."""
    mag_ref = _ValRef(jnp.zeros((2 * K, s.shape[1]), jnp.int32))
    sgn_ref = _ValRef(jnp.zeros((2 * K, s.shape[1]), jnp.int32))
    _scalar_kernel(jnp.asarray(s), mag_ref, sgn_ref, S=J, c=c, K=K)
    return [np.concatenate([np.asarray(r.val[:K]), np.asarray(r.val[K:])], axis=-1)
            for r in (mag_ref, sgn_ref)]


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
    want_m, want_s = _tpu_body(J, s, c, K)
    mags, signs = glv_digits(S, torch.as_tensor(s), c, K)
    assert np.array_equal(mags.numpy(), want_m)
    assert np.array_equal(signs.numpy(), want_s)

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

    got = Weierstrass.create(BLS12_377).random_scalars(N, seed=11, device="cpu")
    want = JaxWeierstrass.create(BLS12_377).random_scalars(N, seed=11)
    assert np.array_equal(got.numpy(), np.asarray(want))

    # K2's word algorithm on the three curves' scalars at five window sizes,
    # against the twin and the TPU kernel's body (run eagerly: one
    # interpret-mode compile takes 6-10 s on XLA:CPU, 15 of them minutes; the
    # interpret-mode kernel itself is held against the twin on BLS12-381
    # and Pallas in tests/test_torch_bls12_381_pallas.py); the twin's mask
    # against the JAX glv_prep's (``jnp.where`` on the digits)
    rng = np.random.default_rng(12)
    for P in (BLS12_377, BLS12_381, PALLAS):
        S, J = make_glv_scalar(P.order, P.lambda_), jax_glv_scalar(P.order, P.lambda_)
        words = _const_words(S)
        s = S.pack(_scalars(P.order.bit_length(), q=P.order))
        inf = rng.integers(0, 2, size=2 * N, dtype=np.int32)
        for c in (6, 8, 12, 13, 14):
            K = -(-(S.max_bits + 1) // c)
            plain = [t.numpy() for t in glv_digits_plain(S, torch.as_tensor(s), c, K)]
            interp = _tpu_body(J, s, c, K)
            model = _word_model(words, s, c, K)
            for want in (plain, interp):
                assert all(np.array_equal(a, b) for a, b in zip(model, want)), (P.label, c)
            masked = glv_digits_plain(S, torch.as_tensor(s), c, K, inf=torch.as_tensor(inf))
            want_m = np.asarray(jnp.where(jnp.asarray(inf).astype(bool)[None, :], 0, interp[0]))
            assert np.array_equal(masked[0].numpy(), want_m) and inf.any(), (P.label, c)
            assert np.array_equal(masked[1].numpy(), plain[1]), (P.label, c)  # signs untouched
            model = _word_model(words, s, c, K, inf)
            assert all(np.array_equal(a, b.numpy()) for a, b in zip(model, masked)), (P.label, c)
