"""The port's tools and point cache on the CPU (``--device cpu``: the plain
twins), against the JAX package's bigint oracle.

* ``utils/point_cache.py``: a good npz in a temporary cache folder is
  loaded as it is; a corrupt one, and one whose points lie off the curve,
  fall through to ``random_points_fast`` with the same seed; no file is
  written.
* ``scripts.run_msm`` at logN = 3 on BLS12-377 (with ``--verbose`` and
  ``--amortize``, and with points of known logs) and on ed-on-bls12-377,
  its result held against JAX ``bigint/msm.py``; ``scripts.evaluate_msm`` at
  logN = 3 over c = 3..4; ``scripts.field_benchmark`` on Pallas (the 51x5
  engine included) at a 256-lane batch.
* ``scripts.scaling_bench`` on gloo CPU processes at d = 1 and 2, logN = 3,
  with its oracle check on the largest mesh.

Three test items (the suite's wall time follows its item count).
"""

import os

import numpy as np
import pytest
import torch

from msm_zprize_tpu.bigint.msm import msm as jax_msm
from msm_zprize_tpu.bigint.weierstrass import ProjectiveCurve as JaxProjective
from msm_zprize_tpu.bigint.edwards import EdwardsCurve as JaxEdwards
from msm_zprize_tpu.curves.params import BLS12_377 as JAX_BLS12_377
from msm_zprize_tpu.curves.params import ED_ON_BLS12_377 as JAX_ED
from msm_zprize_tpu_torch.curves.params import BLS12_377, ED_ON_BLS12_377
from msm_zprize_tpu_torch.parallel.api import TwistedEdwards, Weierstrass
from msm_zprize_tpu_torch.scripts import evaluate_msm, field_benchmark, run_msm, scaling_bench
from msm_zprize_tpu_torch.utils import point_cache

torch.set_num_threads(1)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_point_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(point_cache, "CACHE_DIR", str(tmp_path))
    for curve, N in ((Weierstrass.create(BLS12_377), 8), (TwistedEdwards.create(ED_ON_BLS12_377), 8)):
        fresh = curve.random_points_fast(N, seed=4, device="cpu")
        path = tmp_path / f"pts_{curve.label}_{N}_4.npz"
        assert _same(point_cache.cached_random_points(curve, N, 4, device="cpu"), fresh)
        assert not path.exists()  # nothing written
        # a good file: loaded as it is (a point set of another seed tells it apart)
        other = curve.random_points_fast(N, seed=5, device="cpu")
        np.savez(path, *[a.numpy() for a in other])
        assert _same(point_cache.cached_random_points(curve, N, 4, device="cpu"), other)
        # off the curve: regenerated
        bad = [a.numpy().copy() for a in other]
        bad[1][0, 0] ^= 1
        np.savez(path, *bad)
        assert _same(point_cache.cached_random_points(curve, N, 4, device="cpu"), fresh)
        # not an npz at all: regenerated
        path.write_bytes(b"not a zip file")
        assert _same(point_cache.cached_random_points(curve, N, 4, device="cpu"), fresh)
        os.remove(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):  # the card by default: no silent CPU run
        run_msm.main(["bls12-377", "3"])


def test_run_msm_evaluate_field_benchmark():
    W = Weierstrass.create(BLS12_377)
    out = run_msm.main(["bls12-377", "3", "--device", "cpu", "--runs", "1", "--warmup", "0",
                        "--verbose", "--amortize", "1"])
    assert out["checked"] == ["bigint oracle"] and len(out["phases"]) == 4
    scs = W.scalar.unpack(W.random_scalars(8, seed=0, device="cpu"))
    pts = W.ops.unpack_affine(W.random_points_fast(8, seed=1, device="cpu"))
    C = JaxProjective(JAX_BLS12_377)
    assert out["result"] == C.to_affine(jax_msm(C, scs, [C.from_affine(p) for p in pts], 253))
    out = run_msm.main(["bls12-377", "3", "--device", "cpu", "--runs", "1", "--warmup", "0",
                        "--points", "logs", "--mode", "affine"])
    assert out["checked"] == ["known logs", "bigint oracle"]
    E = TwistedEdwards.create(ED_ON_BLS12_377)
    out = run_msm.main(["ed-on-bls12-377", "3", "--device", "cpu", "--runs", "1", "--warmup", "0"])
    scs = E.scalar.unpack(E.random_scalars(8, seed=0, device="cpu"))
    pts = E.ops.unpack(E.random_points_fast(8, seed=1, device="cpu"))
    C = JaxEdwards(JAX_ED)
    assert out["result"] == C.to_affine(jax_msm(C, scs, pts, E.scalar.bits))

    sweep = evaluate_msm.main(["bls12-377", "3", "--cmin", "3", "--cmax", "4", "--runs", "1",
                               "--device", "cpu"])
    assert sweep["default"] == 6 and set(sweep["table"]) == {3, 4} and sweep["best"] in (3, 4)
    bench = field_benchmark.main(["pallas", "--batch", "256", "--iters", "1", "--device", "cpu"])
    assert set(bench) == {"montmul", "montsquare", "add", "sub", "reduce", "batch_inverse",
                          "sqrt (B=256)", "montmul 51x5"} and all(v > 0 for v in bench.values())


def test_scaling_bench_gloo():
    rows = scaling_bench.main(["bls12-377", "3", "--device", "cpu", "--devices", "1,2",
                               "--runs", "1"])
    assert [r["devices"] for r in rows] == [1, 2] and rows[-1]["oracle_ok"]
    assert rows[0]["result"] == rows[1]["result"] and all(r["backend"] == "gloo" for r in rows)
