"""Integer models of the port's bucket engine against the JAX engine.

Curve points are replaced by integers (the group law by +, or by + mod a
prime for the reduction and Horner), so the engine's sort / spread /
slot-layout / sign-routing / residual logic is checked exactly and fast,
as ``tests/test_engine_model.py`` does for the JAX engine. The same numpy-
seeded digits go through ``msm_zprize_tpu_torch.msm.engine``, through
``msm_zprize_tpu.msm.engine`` and through a plain loop oracle; tolerance:
exact equality. The JAX engine runs under ``jax.jit``: on integers it
compiles in about a second, where eager dispatch compiles op by op and
takes several times longer. The cases cover the compact (top-T) and the
global residual rounds, virtual-bucket spreading, window chunks, both the
fused and the prepared level 1, the two-key sort that takes over when
(id, sign, position) no longer fits one int32 key, and a window with no
digit set at L = 2^17 (spread factor S = L, so the fold's l * S exceeds
int32).
"""

from typing import NamedTuple

import numpy as np
import torch

import jax
import jax.numpy as jnp

import msm_zprize_tpu.msm.engine as JE
import msm_zprize_tpu_torch.msm.engine as TE
from msm_zprize_tpu_torch.counters import COUNTS

torch.set_num_threads(1)


def _port_accumulate(digits, signs, vals, L, use_l1, chunks, max_slots):
    def prepare(leaves, sg, valid):
        (v,) = leaves
        return (torch.where(valid, torch.where(sg.bool(), -v, v), 0),)

    def pair_level1(a, b, sa, sb, va, vb):
        return (prepare(a, sa, va)[0] + prepare(b, sb, vb)[0],)

    out = TE.accumulate_buckets_padded(
        (torch.as_tensor(vals),), torch.as_tensor(digits), torch.as_tensor(signs), L,
        lambda a, b: tuple(x + y for x, y in zip(a, b)), prepare,
        lambda K, L_: (torch.zeros((K, L_), dtype=torch.int32),),
        pair_level1=pair_level1 if use_l1 else None, window_chunks=chunks,
        max_slots=max_slots,
    )
    return out[0].numpy().astype(np.int64)


def _jax_accumulate(digits, signs, vals, L, use_l1, chunks):
    def prepare(leaves, sg, valid):
        (v,) = leaves
        return (jnp.where(valid, jnp.where(sg, -v, v), 0),)

    def pair_level1(a, b, sa, sb, va, vb):
        return (prepare(a, sa, va)[0] + prepare(b, sb, vb)[0],)

    @jax.jit
    def run(d, s, v):
        return JE.accumulate_buckets_padded(
            (v,), d, s, L,
            lambda a, b: tuple(x + y for x, y in zip(a, b)), prepare,
            lambda K, L_: (jnp.zeros((K, L_), jnp.int32),),
            pair_level1=pair_level1 if use_l1 else None, window_chunks=chunks,
        )

    out = run(jnp.asarray(digits), jnp.asarray(signs), jnp.asarray(vals))
    return np.asarray(out[0]).astype(np.int64)


def _oracle(digits, signs, vals, L):
    K, B = digits.shape
    want = np.zeros((K, L), np.int64)
    for k in range(K):
        for i in range(B):
            if digits[k, i]:
                want[k, digits[k, i] - 1] += (-1 if signs[k, i] else 1) * int(vals[i])
    return want


# K, B, L, digit distribution, fused level 1, window chunks, residual path
# the case must take (None: not checked), slot budget of a main sub-round
CASES = [
    (3, 64, 8, "uniform", True, 1, None),
    (3, 64, 8, "uniform", True, 1, None, 64),        # slot sub-rounds
    (2, 64, 16, "all_equal", True, 1, "compact"),     # one bucket holds everything
    (2, 64, 16, "top_heavy", False, 1, None),         # tiny digit range: spreading
    (5, 64, 16, "uniform", True, 2, None),
    (5, 64, 16, "uniform", False, 3, None),           # chunks not dividing K
    (5, 6144, 2048, "stride4", True, 1, "global"),    # > T buckets overflow
    (1, 65536, 16384, "uniform", True, 1, None),      # key > 31 bits: sort_by_bucket
    (2, 16, 1 << 17, "sparse", True, 1, None),        # S = L: l * S past int32 in the fold
]


def test_accumulate_matches_jax_engine(monkeypatch):
    for case in CASES:
        K, B, L, dist, use_l1, chunks, residual = case[:7]
        max_slots = case[7] if len(case) == 8 else TE.MAX_SLOTS
        rng = np.random.default_rng(K * 1000 + B + L)
        digits = {
            "uniform": lambda: rng.integers(0, L + 1, (K, B)),
            "all_equal": lambda: np.full((K, B), 3),
            "top_heavy": lambda: rng.integers(0, 3, (K, B)),
            "stride4": lambda: 4 * rng.integers(0, L // 4, (K, B)) + 1,
            "sparse": lambda: np.stack([np.zeros(B, np.int64), rng.integers(0, 3, B)]),
        }[dist]().astype(np.int32)
        signs = np.where(digits == 0, 0, rng.integers(0, 2, (K, B))).astype(np.int32)
        vals = rng.integers(1, 1000, (B,)).astype(np.int32)

        before = dict(COUNTS)
        got = _port_accumulate(digits, signs, vals, L, use_l1, chunks, max_slots)
        rounds = {kind: COUNTS[f"{kind}_residual_rounds"] - before.get(f"{kind}_residual_rounds", 0)
                  for kind in ("compact", "global")}
        assert np.array_equal(got, _oracle(digits, signs, vals, L)), case
        monkeypatch.setenv("MSM_TPU_MAX_SLOTS", str(max_slots))  # the JAX engine's knob
        assert np.array_equal(got, _jax_accumulate(digits, signs, vals, L, use_l1, chunks)), case
        if residual is not None:  # the case exists to drive this residual path
            assert {k for k, n in rounds.items() if n} == {residual}, (case, rounds)


class _Pt(NamedTuple):
    v: object


MOD = 65521  # a prime: the integer model of the group, with 2^k as doubling


class _TorchAcc:
    def zero(self, *batch):
        return _Pt(torch.zeros((1,) + batch, dtype=torch.int32))

    def add(self, a, b):
        return _Pt((a.v + b.v) % MOD)

    def double_k(self, a, k):
        return _Pt((a.v << k) % MOD)


class _JaxAcc:
    def zero(self, *batch):
        return _Pt(jnp.zeros((1,) + batch, jnp.int32))

    def add(self, a, b):
        return _Pt((a.v + b.v) % MOD)

    def double(self, a):
        return _Pt((a.v << 1) % MOD)

    def double_k(self, a, k):
        return _Pt((a.v << k) % MOD)


def test_reduce_and_horner_match_jax_engine():
    """reduce_buckets_log (S_k = sum_l (l+1) B[k, l]) then Horner
    (sum_k 2^(k c) S_k), mod a prime, against the JAX engine and the sums."""
    for K, c in ((3, 4), (22, 6)):
        L = 1 << (c - 1)
        c0 = max((c - 1) // 2, 1)
        rng = np.random.default_rng(K + c)
        buckets = rng.integers(0, MOD, (1, K, L)).astype(np.int32)

        t_acc = _TorchAcc()
        t_win = TE.reduce_buckets_log(_Pt(torch.as_tensor(buckets)), c0, t_acc)
        t_res = TE.horner(t_win, c, t_acc.add, t_acc.double_k)

        @jax.jit
        def jax_side(b):
            j_acc = _JaxAcc()
            j_win = JE.reduce_buckets_log(_Pt(b), c0, j_acc)
            return j_win, JE.horner(j_win, c, j_acc.add, j_acc.double, None, double_k=j_acc.double_k)

        j_win, j_res = jax_side(jnp.asarray(buckets))

        weights = np.arange(1, L + 1, dtype=object)
        S = [int((buckets[0, k].astype(object) * weights).sum()) % MOD for k in range(K)]
        assert t_win.v.numpy()[0].tolist() == np.asarray(j_win.v)[0].tolist() == S
        total = sum(pow(2, k * c, MOD) * s for k, s in enumerate(S)) % MOD
        assert t_res.v.numpy().tolist() == np.asarray(j_res.v).tolist() == [[total]]
