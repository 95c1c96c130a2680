"""The port's sharded MSM (``parallel/mesh.py``) on gloo CPU processes.

Each rank runs in a process of its own (``parallel/launch.py``) on the
rank bodies of ``testing/mesh_ranks.py``, which import nothing of JAX, and
returns affine int results; here they are held against the JAX package's
bigint Pippenger oracle (``msm_zprize_tpu/bigint/msm.py``) and the port's
one-card result, which the parent computes while the ranks run. Points are
exact: no tolerance.

* four ranks on ``make_mesh()``: BLS12-377 at N = 16, c = 6 (``msm``,
  ``msm_unsafe(mode="affine")``, ``msm(mode="packed")``), ed-on-bls12-377
  padded and basic, Pallas ``"fma51"`` (the case of
  ``tests/test_fma51_msm.py::test_fma51_msm_sharded``) and
  ``make_compute_msm(mesh=...)`` on int inputs with a duplicated point;
* six ranks: BLS12-377 at N = 12 (padded to 18) on ``make_mesh2(2, 3)`` and
  ``(3, 2)``, ed-on-bls12-377 on (3, 2), and the hierarchical combine on
  hand-made partials with K = 5 < 6 and K = 4 windows (K < d and K % d != 0)
  on the 1-D mesh and both orientations: each rank's slice against the host
  sums over ranks (it stands in for the c = 22, K = 6 < d = 8 case of
  ``tests/test_msm_sweep.py``, which takes minutes on the CPU);
* one process: ``_pad`` for every mesh size 1..8 (equal to the JAX
  ``_pad``'s shapes for powers of two), ``graft_entry.entry``, its dry run
  on four ranks, and ``launch.spawn(device="cuda")`` refused on a host
  without a card.

Three test items: the CPU suite's wall time follows its item count (see
ROADMAP.md's standing rule on Tier-1 time).
"""

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msm_zprize_tpu.bigint.edwards import EdwardsCurve
from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.bigint.weierstrass import AffineCurve, ProjectiveCurve
from msm_zprize_tpu.curves.params import BLS12_377, ED_ON_BLS12_377, PALLAS
from msm_zprize_tpu.parallel.api import TwistedEdwards as JaxTwistedEdwards
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch import graft_entry
from msm_zprize_tpu_torch.curves.weierstrass import ProjectivePoints
from msm_zprize_tpu_torch.parallel import launch
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
from msm_zprize_tpu_torch.submission import make_compute_msm
from msm_zprize_tpu_torch.testing import mesh_ranks
from msm_zprize_tpu_torch.testing.points import ed_points_with_logs, points_with_logs

torch.set_num_threads(1)

C = mesh_ranks.C_SMALL


def _scalars(q, N, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % q for _ in range(N)]


def _oracle(params, scs, pts):
    """The JAX package's bigint Pippenger, as an affine int point."""
    curve = EdwardsCurve(params) if params is ED_ON_BLS12_377 else ProjectiveCurve(params)
    return curve.to_affine(msm_oracle(curve, scs, [curve.from_affine(P) for P in pts],
                                      params.order.bit_length()))


def _one_card(params, scs, pts, entry="msm", mode=None):
    cls = TwistedEdwards if params is ED_ON_BLS12_377 else Weierstrass
    curve = cls.create(params)
    s, p = curve.scalars_from_ints(scs, "cpu"), curve.points_from_ints(pts, "cpu")
    kw = {} if mode is None else {"mode": mode}
    return curve.result_to_int(getattr(curve, entry)(s, p, c=C, **kw))


def _spawn_and(world, body, inputs, local):
    """Run ``body`` on ``world`` gloo CPU ranks while this process computes
    ``local()``; returns (the ranks' results, local's)."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, body, world, device="cpu", args=(inputs,))
        mine = local()
        return ranks.result(timeout=600), mine


def test_mesh_1d_four_ranks_every_mode():
    bls, _ = points_with_logs(BLS12_377, 16, seed=41)
    ed, _ = ed_points_with_logs(ED_ON_BLS12_377, 16, seed=42)
    rng = random.Random(12)  # tests/test_fma51_msm.py::test_fma51_msm_sharded's inputs
    jax_pallas = JaxWeierstrass.create(PALLAS)
    pal = [jax_pallas.oracle_affine.random(rng) for _ in range(16)]
    pal_scs = [rng.randrange(PALLAS.order) for _ in range(16)]
    dup = bls[:-1] + [bls[0]]
    inputs = {
        "bls12-377": (_scalars(BLS12_377.order, 16, 41), bls),
        "ed-on-bls12-377": (_scalars(ED_ON_BLS12_377.order, 16, 42), ed),
        "pallas": (pal_scs, pal),
        "compute_msm": (_scalars(BLS12_377.order, 16, 43), dup),
    }
    cases = {  # key -> (params, input name, one-card entry, mode)
        "bls12-377 msm projective": (BLS12_377, "bls12-377", "msm", "projective"),
        "bls12-377 msm_unsafe affine": (BLS12_377, "bls12-377", "msm_unsafe", "affine"),
        "bls12-377 msm packed": (BLS12_377, "bls12-377", "msm", "packed"),
        "ed-on-bls12-377 msm padded": (ED_ON_BLS12_377, "ed-on-bls12-377", "msm", "padded"),
        "ed-on-bls12-377 msm basic": (ED_ON_BLS12_377, "ed-on-bls12-377", "msm", "basic"),
        "pallas msm fma51": (PALLAS, "pallas", "msm", "fma51"),
    }

    def local():
        out = {k: _one_card(P, *inputs[name], entry, mode) for k, (P, name, entry, mode) in cases.items()}
        out["compute_msm"] = make_compute_msm(BLS12_377, None, "cpu")(*inputs["compute_msm"][::-1])
        return out

    results, one_card = _spawn_and(4, mesh_ranks.cpu_1d, inputs, local)
    want = {k: _oracle(P, *inputs[name]) for k, (P, name, _, _) in cases.items()}
    want["compute_msm"] = _oracle(BLS12_377, *inputs["compute_msm"])
    assert want["compute_msm"] is not None and len(set(dup)) < len(dup)
    assert one_card == want
    for rank, got in enumerate(results):
        assert got.pop("foreign") == [], rank  # the ranks imported nothing of JAX
        assert got == want, rank


def _combine_expected(pool, K, L, world, shape):
    """Each rank's combined slice, from the host: window k, bucket l holds
    the sum over ranks r of pool[(r K + k) L + l] (the identity past K);
    the combine pads to Kp windows and splits them innermost axis first, so
    rank (i, j) of a (dcn, ici) mesh owns block j * dcn + i."""
    A = AffineCurve(BLS12_377)
    Kp = -(-K // world) * world
    Kl = Kp // world
    sums = [[None] * L for _ in range(Kp)]
    for r in range(world):
        for k in range(K):
            for l in range(L):
                sums[k][l] = A.add(sums[k][l], pool[(r * K + k) * L + l])
    out = []
    for r in range(world):
        if len(shape) == 1:
            block = r
        else:
            dcn, ici = shape
            block = (r % ici) * dcn + r // ici
        out.append((Kl, [P for k in range(block * Kl, (block + 1) * Kl) for P in sums[k]]))
    return out


def test_mesh_2d_six_ranks_padding_and_window_deficit():
    bls, _ = points_with_logs(BLS12_377, 12, seed=51)
    ed, _ = ed_points_with_logs(ED_ON_BLS12_377, 12, seed=52)
    L = 4
    pool, _ = points_with_logs(BLS12_377, 6 * 5 * L, seed=53)
    inputs = {
        "bls12-377": (_scalars(BLS12_377.order, 12, 51), bls),
        "ed-on-bls12-377": (_scalars(ED_ON_BLS12_377.order, 12, 52), ed),
        "pool": pool, "L": L,
    }

    def local():
        return (_one_card(BLS12_377, *inputs["bls12-377"]),
                _one_card(ED_ON_BLS12_377, *inputs["ed-on-bls12-377"]))

    results, (bls_one, ed_one) = _spawn_and(6, mesh_ranks.cpu_2d, inputs, local)
    bls_want = _oracle(BLS12_377, *inputs["bls12-377"])
    ed_want = _oracle(ED_ON_BLS12_377, *inputs["ed-on-bls12-377"])
    assert bls_one == bls_want and ed_one == ed_want
    combined = {(K, name): _combine_expected(pool, K, L, 6, shape)
                for K in (5, 4) for name, shape in (("1-D", (6,)), ("(2, 3)", (2, 3)),
                                                    ("(3, 2)", (3, 2)))}
    for rank, got in enumerate(results):
        assert got.pop("foreign") == [], rank
        assert got.pop("bls12-377 msm (2, 3)") == got.pop("bls12-377 msm (3, 2)") == bls_want, rank
        assert got.pop("ed-on-bls12-377 msm (3, 2)") == ed_want, rank
        for (K, name), want in combined.items():
            assert got.pop(f"combine K={K} {name}") == want[rank], (rank, K, name)
        assert not got


def test_mesh_padding_entry_and_launcher():
    W, E = Weierstrass.create(BLS12_377), TwistedEdwards.create(ED_ON_BLS12_377)
    JW, JE = JaxWeierstrass.create(BLS12_377), JaxTwistedEdwards.create(ED_ON_BLS12_377)
    pts, _ = points_with_logs(BLS12_377, 13, seed=61)
    ept, _ = ed_points_with_logs(ED_ON_BLS12_377, 13, seed=62)
    for N in (1, 8, 9, 13):
        s, p = W.scalars_from_ints(list(range(N)), "cpu"), W.points_from_ints(pts[:N], "cpu")
        es, ep = E.scalars_from_ints(list(range(N)), "cpu"), E.points_from_ints(ept[:N], "cpu")
        for multiple in range(1, 9):
            got = W._pad(s, p, multiple)
            target = got[1].x.shape[-1]
            assert target % multiple == 0 and target >= max(N, 8)
            assert bool(got[1].inf[N:].all()) and not bool(got[0][:, N:].any())
            eg = E._pad(es, ep, multiple)
            assert eg[1].X.shape[-1] == target and not bool(eg[0][:, N:].any())
            assert E.ops.unpack(type(ep)(*(a[:, N:] for a in eg[1]))) == [(0, 1, 1, 0)] * (target - N)
            if multiple & (multiple - 1) == 0:  # the JAX loop ends for powers of two
                js, jp = JW._pad(jnp.asarray(s.numpy()), JW.points_from_ints(pts[:N]), multiple)
                assert (tuple(got[0].shape), tuple(got[1].x.shape)) == (js.shape, jp.x.shape)
                jes, jep = JE._pad(jnp.asarray(es.numpy()), JE.points_from_ints(ept[:N]), multiple)
                assert tuple(eg[1].X.shape) == jep.X.shape and tuple(eg[0].shape) == jes.shape

    fn, args = graft_entry.entry(device="cpu")
    assert W.result_to_int(ProjectivePoints(*fn(*args))) == _oracle(BLS12_377, *graft_entry.entry_inputs())
    graft_entry.dryrun_multichip(4, device="cpu")

    with pytest.raises(RuntimeError, match="needs a GPU"):
        launch.spawn(mesh_ranks.card_ranks, 2, device="cuda", backend="gloo")
    with pytest.raises((RuntimeError, ValueError)):
        launch.spawn(mesh_ranks.card_ranks, 1, device="cuda")
