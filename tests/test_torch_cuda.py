"""The port's CUDA kernels on the card, against their plain twins.

This file imports nothing of JAX or the JAX package (the machine with the
card has no JAX), so run it there without the suite's conftest, which
configures JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False (decided inside the fixture). Widths
are odd (ragged last block) and some operands are strided slices, which
the kernels read in place. Tolerance: K2 and K9 bit-exact; K1 limb-exact
(the Montgomery product is one integer) on both field shapes; K3-K5, K8 and
K10-K12 exact mod p.
"""

import numpy as np
import pytest
import torch

from msm_zprize_tpu_torch.counters import COUNTS
from msm_zprize_tpu_torch.curves import cuda_curve, cuda_edwards
from msm_zprize_tpu_torch.curves.params import BLS12_377, ED_ON_BLS12_377
from msm_zprize_tpu_torch.fields import cuda_mul
from msm_zprize_tpu_torch.fields.cuda_scalar import glv_digits, glv_digits_plain, simple_digits
from msm_zprize_tpu_torch.fields.scalar import signed_digits
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
from msm_zprize_tpu_torch.testing.points import (
    ed_expected_msm, ed_points_with_logs, expected_msm, points_with_logs,
)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

WIDTH = 4099


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def curve():
    return Weierstrass.create(BLS12_377)


def _elems(dev, rng, width=WIDTH, rows=32):
    """Random field limbs with value < 2^376 < p (rows = 32) or < 2^252 < p
    (rows = 22)."""
    limbs = rng.integers(0, 1 << 12, size=(rows, width), dtype=np.int32)
    limbs[-1] &= 0xF if rows == 32 else 0
    return torch.as_tensor(limbs, device=dev)


def test_kernels_match_plain_twins(dev, curve):
    """Each kernel against its twin, then a 2^10 MSM of each curve on the
    card that launches every kernel of its path and equals its
    known-discrete-log result (one test item: the CPU suite's wall time
    follows its item count)."""
    W = curve.ops
    F, S = W.F, curve.scalar
    rng = np.random.default_rng(1)

    # K1, also on a strided operand; a wrong dtype is refused
    x, y = _elems(dev, rng), _elems(dev, rng)
    assert torch.equal(cuda_mul.montmul(F, x, y), F.montmul_plain(x, y))
    wide = torch.cat([x, y], dim=1)
    assert torch.equal(cuda_mul.montmul(F, wide[:, :WIDTH], y), F.montmul_plain(x, y))
    with pytest.raises(ValueError):
        cuda_mul.montmul(F, x.to(torch.int64), y)

    # K2 at two window sizes
    for c in (8, 12):
        s = curve.random_scalars(WIDTH, seed=c, device=dev)
        K = -(-(S.max_bits + 1) // c)
        got, want = glv_digits(S, s, c, K), glv_digits_plain(S, s, c, K)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), c

    # K3-K5; K4 also on the two halves of one slot row block
    a = [_elems(dev, rng) for _ in range(6)]
    f = [torch.as_tensor(rng.integers(0, 2, size=WIDTH, dtype=np.int32), device=dev) for _ in range(4)]
    slot = _elems(dev, rng, width=2 * WIDTH)
    pairs = {
        "K4": (cuda_curve.proj_add(W, *a), cuda_curve.proj_add_plain(W, *a)),
        "K4 strided": (cuda_curve.proj_add(W, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:]),
                       cuda_curve.proj_add_plain(W, slot[:, :WIDTH], *a[1:3], slot[:, WIDTH:], *a[4:])),
        "K5": (cuda_curve.proj_double_k(W, *a[:3], 5), cuda_curve.proj_double_k_plain(W, *a[:3], 5)),
        "K3": (cuda_curve.aff_pair_add(W, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3]),
               cuda_curve.aff_pair_add_plain(W, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3])),
    }
    for name, (got, want) in pairs.items():
        for g, w in zip(got, want):
            assert torch.equal(F.fully_reduce(g), F.fully_reduce(w)), name

    N = 1 << 10
    pts, logs = points_with_logs(BLS12_377, N, seed=12)
    scalars = curve.random_scalars(N, seed=12, device=dev)
    before = dict(COUNTS)
    res = curve.msm(scalars, curve.points_from_ints(pts, dev))
    assert curve.result_to_int(res) == expected_msm(BLS12_377, curve.scalar.unpack(scalars), logs)
    for key in ("k1_montmul", "k2_glv_digits", "k3_aff_pair_add", "k4_proj_add", "k5_proj_double_k"):
        assert COUNTS[key] > before.get(key, 0), key

    # ed-on-bls12-377: K1 on the 22-limb field, K8, K9, K10-K12 (K11 with
    # and without a mask, on strided halves of one slot block)
    ed = TwistedEdwards.create(ED_ON_BLS12_377)
    E, FE = ed.ops, ed.ops.F
    x, y = _elems(dev, rng, rows=22), _elems(dev, rng, rows=22)
    assert torch.equal(cuda_mul.montmul(FE, x, y), FE.montmul_plain(x, y))
    for e in (0, 1, 5, FE.p - 2):
        assert torch.equal(FE.fully_reduce(cuda_mul.exp_const(FE, x[:, :64], e)),
                           FE.fully_reduce(FE.exp_const_plain(x[:, :64], e))), e
    for c in (6, 11):
        s = ed.random_scalars(WIDTH, seed=c, device=dev)
        K = -(-(ed.scalar.bits + 1) // c)
        got, want = simple_digits(s, c, K), signed_digits(s, c, K, 12)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), c
    a = [_elems(dev, rng, rows=22) for _ in range(8)]
    slot = _elems(dev, rng, width=2 * WIDTH, rows=22)
    m = f[0]
    pairs = {
        "K10": (cuda_edwards.ed_pair_add(E, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3]),
                cuda_edwards.ed_pair_add_plain(E, a[0], a[1], f[0], f[1], a[2], a[3], f[2], f[3])),
        "K11": (cuda_edwards.ed_add(E, *a), cuda_edwards.ed_add_plain(E, *a)),
        "K11 masked strided": (
            cuda_edwards.ed_add(E, slot[:, :WIDTH], *a[1:4], slot[:, WIDTH:], *a[5:], mask=m),
            cuda_edwards.ed_add_plain(E, slot[:, :WIDTH], *a[1:4], slot[:, WIDTH:], *a[5:], mask=m)),
        "K12": (cuda_edwards.ed_double_k(E, *a[:4], 5), cuda_edwards.ed_double_k_plain(E, *a[:4], 5)),
    }
    for name, (got, want) in pairs.items():
        for g, w in zip(got, want):
            assert torch.equal(FE.fully_reduce(g), FE.fully_reduce(w)), name

    pts, logs = ed_points_with_logs(ED_ON_BLS12_377, N, seed=13)
    scalars = ed.random_scalars(N, seed=13, device=dev)
    before = dict(COUNTS)
    res = ed.msm(scalars, ed.points_from_ints(pts, dev))
    assert ed.result_to_int(res) == ed_expected_msm(ED_ON_BLS12_377, ed.scalar.unpack(scalars), logs)
    for key in ("k1_montmul", "k8_exp_const", "k9_simple_digits", "k10_ed_pair_add", "k11_ed_add",
                "k12_ed_double_k"):
        assert COUNTS[key] > before.get(key, 0), key
