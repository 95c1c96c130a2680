"""The port's CUDA kernels on the card, against their plain twins.

This file imports nothing of JAX or the JAX package (the machine with the
card has no JAX), so run it there without the suite's conftest, which
configures JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False (decided inside the fixture). Widths
are odd (ragged last block) and some operands are strided slices, which
the kernels read in place. Tolerance: K2 bit-exact; K1 limb-exact (the
Montgomery product is one integer); K3-K5 exact mod p.
"""

import numpy as np
import pytest
import torch

from msm_zprize_tpu_torch.counters import COUNTS
from msm_zprize_tpu_torch.curves import cuda_curve
from msm_zprize_tpu_torch.curves.params import BLS12_377
from msm_zprize_tpu_torch.fields import cuda_mul
from msm_zprize_tpu_torch.fields.cuda_scalar import glv_digits, glv_digits_plain
from msm_zprize_tpu_torch.parallel.api import Weierstrass
from msm_zprize_tpu_torch.testing.points import expected_msm, points_with_logs

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
    """Random field limbs with value < 2^376 < p."""
    limbs = rng.integers(0, 1 << 12, size=(rows, width), dtype=np.int32)
    limbs[-1] &= 0xF
    return torch.as_tensor(limbs, device=dev)


def test_kernels_match_plain_twins(dev, curve):
    """Each kernel against its twin, then a 2^10 MSM on the card that
    launches every kernel and equals its known-discrete-log result (one
    test item: the CPU suite's wall time follows its item count)."""
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
