"""The port's BLS12-377 MSM slice end to end on the CPU.

Judge: the bigint Pippenger oracle (``msm_zprize_tpu.bigint.msm``), as in
``tests/test_msm.py``, plus the known-discrete-log check of
``testing/points.py``. Inputs are made by the JAX package (``points_from_ints``,
``scalars_from_ints``) and carried over with ``utils/convert.py``, so the
carry-over is tested too. ``glv_prep`` is held against the JAX ``glv_prep``
limb for limb. No whole-MSM JAX jit here: its XLA:CPU compile takes minutes.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msm_zprize_tpu.bigint.msm import msm as msm_oracle
from msm_zprize_tpu.bigint.weierstrass import ProjectiveCurve
from msm_zprize_tpu.curves.params import BLS12_377
from msm_zprize_tpu.msm.batched_affine import glv_prep as jax_glv_prep
from msm_zprize_tpu.parallel.api import Weierstrass as JaxWeierstrass
from msm_zprize_tpu_torch.curves import params as port_params
from msm_zprize_tpu_torch.msm.batched_affine import glv_prep
from msm_zprize_tpu_torch.parallel.api import Weierstrass
from msm_zprize_tpu_torch.testing.points import expected_msm, naive_msm, points_with_logs
from msm_zprize_tpu_torch.utils.convert import affine_from_jax, scalars_from_jax

torch.set_num_threads(1)

Q = BLS12_377.order


@pytest.fixture(scope="module")
def curves():
    return Weierstrass.create(BLS12_377), JaxWeierstrass.create(BLS12_377)


def _inputs(curves, N, seed):
    """Points (with discrete logs) and scalars, packed by the JAX package and
    carried over to the port."""
    port, jax_curve = curves
    pts, logs = points_with_logs(BLS12_377, N, seed=seed)
    rng = np.random.default_rng(seed)
    scs = [int.from_bytes(rng.bytes(40), "little") % Q for _ in range(N)]
    jp = jax_curve.points_from_ints(pts)
    points = affine_from_jax(np.asarray(jp.x), np.asarray(jp.y), np.asarray(jp.inf), port.ops.F, "cpu")
    scalars = scalars_from_jax(np.asarray(jax_curve.scalars_from_ints(scs)), port.scalar, "cpu")
    return pts, logs, scs, points, scalars


C = ProjectiveCurve(BLS12_377)


def _oracle(scs, pts):
    return C.to_affine(msm_oracle(C, scs, [C.from_affine(P) for P in pts], Q.bit_length()))


def test_msm_matches_bigint_oracle(curves):
    """N in {1, 8, 64} against the oracle and the known discrete logs, then
    the edge cases of the JAX package's MSM tests; the port's own small
    oracle (``naive_msm``, what the GPU smoke run judges by) agrees."""
    port = curves[0]
    for N in (1, 8, 64):
        pts, logs, scs, points, scalars = _inputs(curves, N, seed=N)
        got = port.result_to_int(port.msm(scalars, points))
        assert got == _oracle(scs, pts) == expected_msm(BLS12_377, scs, logs), N
    assert naive_msm(BLS12_377, scs[:8], pts[:8]) == _oracle(scs[:8], pts[:8])

    pts, _ = points_with_logs(BLS12_377, 3, seed=5)
    cases = {
        "duplicates": ([5, 11], [pts[0], pts[0]], C.to_affine(C.scale(16, C.from_affine(pts[0])))),
        "cancellation": ([3, Q - 3], [pts[1], pts[1]], None),
        "zero_scalars": ([0, 0, 0], pts, None),
        "single_point": ([987654321], [pts[2]], C.to_affine(C.scale(987654321, C.from_affine(pts[2])))),
    }
    for case, (scs, points, want) in cases.items():
        assert port.msm_bigint(scs, points, "cpu") == want == naive_msm(BLS12_377, scs, points), case


def test_glv_prep_matches_jax(curves):
    port, jax_curve = curves
    _, _, _, points, scalars = _inputs(curves, 64, seed=3)
    points = points._replace(inf=points.inf.clone())
    points.inf[5] = 1  # a point at infinity: its digits must be zeroed
    c = 6
    got = glv_prep(port.ops, port.scalar, scalars, points, c)
    jp = type(jax_curve.points_from_ints([None]))(*(jnp.asarray(a.numpy()) for a in points))
    want = jax_glv_prep(jax_curve.ops, jax_curve.scalar, jnp.asarray(scalars.numpy()), jp, c)
    for g, w in zip(got[0], want[0]):  # the 2N points: beta*x bit-identical
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[1:3], want[1:3]):  # digit magnitudes and signs
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[3:] == want[3:]  # K, L


def test_port_boundaries(curves):
    """The port's curve constants are the JAX package's; the carry-over
    from JAX arrays checks its input; the codec storage mode "packed" runs
    and "fma51" on BLS12-377 raises as the JAX package's does (the 51x5
    layout's 255-bit ceiling on p), naming the one supported curve below it
    (Pallas); unknown modes raise; importing the port (every module, item
    10's sqrt, barrett, fma51 and bytes_codec, the mesh, its launcher, the
    entry twin, the native codec, the bigint oracles, the harness, the
    utilities and the four tools named) leaves JAX and the JAX package
    out, and chip_smoke.py imports neither."""
    assert dataclasses.asdict(port_params.BLS12_377) == dataclasses.asdict(BLS12_377)
    port = curves[0]
    x = np.zeros((32, 4), np.int32)
    with pytest.raises(ValueError):
        affine_from_jax(x.astype(np.int64), x, np.zeros(4, np.int32), port.ops.F, "cpu")
    with pytest.raises(ValueError):
        affine_from_jax(x, x, np.full(4, 2, np.int32), port.ops.F, "cpu")
    with pytest.raises(ValueError):
        scalars_from_jax(np.full((22, 4), 1 << 12, np.int32), port.scalar, "cpu")

    _, logs, scs, points, scalars = _inputs(curves, 8, seed=1)
    assert port.result_to_int(port.msm(scalars, points, mode="packed")) == expected_msm(
        BLS12_377, scs, logs)
    with pytest.raises(ValueError, match="255-bit ceiling.*only Pallas"):
        port.msm(scalars, points, mode="fma51")
    with pytest.raises(ValueError, match="mode"):
        port.msm(scalars, points, mode="basic")

    root = Path(__file__).resolve().parents[1]
    tree = ast.parse((root / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "msm_zprize_tpu_torch.parallel.api" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "msm_zprize_tpu")], names
    code = (
        "import sys, pkgutil, importlib, msm_zprize_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert 'msm_zprize_tpu' not in sys.modules\n"
        "for name in ('fields.sqrt', 'fields.barrett', 'fields.fma51', 'fields.bytes_codec',\n"
        "             'parallel.mesh', 'parallel.launch', 'graft_entry', 'utils.native_codec',\n"
        "             'bigint.glv', 'bigint.msm', 'curves.example_fields', 'testing.equivalent',\n"
        "             'utils.phases', 'utils.point_cache', 'utils.timing', 'scripts.run_msm',\n"
        "             'scripts.evaluate_msm', 'scripts.field_benchmark', 'scripts.scaling_bench'):\n"
        "    assert m.__name__ + '.' + name in sys.modules, name\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
