"""The port's curve formulas (the K3-K5 twins) against the JAX package.

* BLS12-377: ``proj_add_plain`` (RCB Alg. 7), ``aff_pair_add_plain``
  (signed/valid slots, the rcb7_unitz function) and ``proj_double_k_plain``
  (k x RCB Alg. 9) against ``WeierstrassOps`` on the jnp path and against
  the TPU kernels' formula bodies run eagerly, on curve points with random
  Z, identity, doubling and cancelling lanes included.
* goldilocks (n = 6): the same twins against the TPU kernels themselves,
  ``CurveKernels(..., interpret=True)``, on arbitrary field values (the
  formulas are polynomial identities, so any values compare).

Tolerance: exact equality of every output coordinate mod p (the same
formula gives the same field values). The CUDA kernels themselves run on
the card in ``tests/test_torch_cuda.py``.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msm_zprize_tpu.bigint.weierstrass import ProjectiveCurve
from msm_zprize_tpu.curves import pallas_curve as pc
from msm_zprize_tpu.curves.example_fields import EXAMPLE_FIELDS
from msm_zprize_tpu.curves.params import BLS12_377
from msm_zprize_tpu.curves.weierstrass import ProjectivePoints as JaxProj
from msm_zprize_tpu.curves.weierstrass import WeierstrassOps as JaxOps
from msm_zprize_tpu.fields import pallas_field as pf
from msm_zprize_tpu_torch.curves import cuda_curve
from msm_zprize_tpu_torch.curves.weierstrass import ProjectivePoints, WeierstrassOps
from msm_zprize_tpu_torch.fields.fp import make_field
from msm_zprize_tpu_torch.testing.points import points_with_logs

torch.set_num_threads(1)

P = BLS12_377.modulus
B = 8


@pytest.fixture(scope="module")
def ops():
    return WeierstrassOps(BLS12_377), JaxOps(BLS12_377)


@pytest.fixture(scope="module")
def lanes():
    """Projective operand pairs (P_i, Q_i): random points with random Z,
    then an identity lane, a doubling lane and a cancelling lane."""
    rng = np.random.default_rng(7)
    pts, _ = points_with_logs(BLS12_377, 2 * B, seed=7)
    zs = [int.from_bytes(rng.bytes(48), "little") % P or 1 for _ in range(2 * B)]
    proj = [(x * z % P, y * z % P, z) for (x, y), z in zip(pts, zs)]
    Ps, Qs = proj[:B], proj[B:]
    Ps[1] = (0, 1, 0)                          # identity + Q
    Qs[2] = Ps[2]                              # P + P
    Qs[3] = (Ps[3][0], (-Ps[3][1]) % P, Ps[3][2])  # P + (-P)
    return Ps, Qs


def _pack(F, pts):
    return [F.pack([pt[i] for pt in pts]) for i in range(3)]


def _values(F, arrs):
    return [F.unpack(np.asarray(a)) for a in arrs]


@pytest.fixture(scope="module")
def aff_args(ops):
    """Two signed/valid affine slot batches (a doubling lane included)."""
    W, _ = ops
    pts, _ = points_with_logs(BLS12_377, 2 * B, seed=8)
    pts[B + 1] = pts[1]
    x = W.F.pack([pt[0] for pt in pts])
    y = W.F.pack([pt[1] for pt in pts])
    rng = np.random.default_rng(8)
    s = rng.integers(0, 2, size=(2, B), dtype=np.int32)
    v = rng.integers(0, 2, size=(2, B), dtype=np.int32)
    v[:, :2] = 1  # both slots valid on the first lanes
    return (x[:, :B], y[:, :B], s[0], v[0], x[:, B:], y[:, B:], s[1], v[1])


@pytest.fixture(scope="module")
def jax_results(ops, lanes, aff_args):
    """The JAX jnp path's add, double and signed-slot add, in ONE jit (one
    XLA compile instead of eager scans that recompile per call)."""
    W, J = ops
    a, b = _pack(W.F, lanes[0]), _pack(W.F, lanes[1])

    def fn(a, b, aff):
        Pa, Pb = JaxProj(*a), JaxProj(*b)
        return J.proj_add(Pa, Pb), J.proj_double(Pa), J.aff_pair_add(*aff)

    tree = (tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), tuple(map(jnp.asarray, aff_args)))
    add, dbl, aff = jax.jit(fn)(*tree)
    return a, b, add, dbl, aff


def test_twins_match_jax_ops(ops, lanes, aff_args, jax_results):
    """proj_add (also against the bigint group law), proj_double (also
    through the curve-ops entry point, which sends CPU tensors to the twin)
    and aff_pair_add against the JAX jnp path."""
    W, _ = ops
    F = W.F
    Ps, Qs = lanes
    a, b, add, dbl, aff = jax_results
    t = lambda arrs: [torch.as_tensor(x) for x in arrs]
    got = cuda_curve.proj_add_plain(W, *t(a), *t(b))
    assert _values(F, got) == _values(F, add)
    C = ProjectiveCurve(BLS12_377)
    for i, R in enumerate(zip(*_values(F, got))):
        assert C.eq(R, C.add(Ps[i], Qs[i])), i
    assert _values(F, cuda_curve.proj_double_k_plain(W, *t(a), 1)) == _values(F, dbl)
    assert _values(F, W.proj_double(ProjectivePoints(*t(a)))) == _values(F, dbl)
    assert _values(F, cuda_curve.aff_pair_add_plain(W, *t(aff_args))) == _values(F, aff)


@pytest.fixture(scope="module")
def goldilocks():
    p = EXAMPLE_FIELDS["goldilocks"]
    F = make_field(p)
    b3 = 9
    W = types.SimpleNamespace(F=F, b3_mont=b3 * F.R % p, b3_small=b3, storage=cuda_curve.Storage(F.n))
    kern = pc.CurveKernels(p, F.w, F.n, b3 * F.R % p, b3, interpret=True)
    rng = np.random.default_rng(9)
    vals = [F.pack([int(v) for v in rng.integers(0, p, size=B, dtype=np.uint64)]) for _ in range(6)]
    flags = rng.integers(0, 2, size=(4, B), dtype=np.int32)
    return W, kern, vals, flags


def test_twins_match_tpu_kernels(ops, lanes, aff_args, goldilocks):
    """Against the TPU kernels' formula bodies (``rcb7``, ``k x rcb9`` with
    the storage re-entry of ``_proj_double_k_body``, ``rcb7_unitz``) run
    eagerly on BLS12-377 with 3b as the small multiply the kernels use, and
    against ``CurveKernels(..., interpret=True)`` itself on goldilocks."""
    W, _ = ops
    F = W.F
    ctx = pf.FieldCtx(F.p, F.w, F.n)
    mul_b3 = lambda v: pf.f_small(ctx, v, 3)
    t = lambda arrs: [torch.as_tensor(x) for x in arrs]
    a, b = _pack(F, lanes[0]), _pack(F, lanes[1])
    fa = [pf.fv_stored(ctx, jnp.asarray(x), vmax=P - 1) for x in a + b]
    x1, y1, s1, v1, x2, y2, s2, v2 = aff_args
    fv = lambda x: pf.fv_stored(ctx, jnp.asarray(x), vmax=2 * P - 1)
    unitz = pc.rcb7_unitz(ctx, mul_b3, W.b3_mont, fv(x1), fv(y1), jnp.asarray(s1), jnp.asarray(v1),
                          fv(x2), fv(y2), jnp.asarray(s2), jnp.asarray(v2))
    cases = {
        "rcb7": (cuda_curve.proj_add_plain(W, *t(a), *t(b)), pc.rcb7(ctx, mul_b3, *fa)),
        "rcb7_unitz": (cuda_curve.aff_pair_add_plain(W, *t(aff_args)), unitz),
    }
    dbl = fa[:3]
    for k in range(1, 6):  # store/load re-entry between doublings, as the kernel body
        dbl = [pf.fv_stored(ctx, pf.f_relax(ctx, o).arr) for o in pc.rcb9(ctx, mul_b3, *dbl)]
        if k in (2, 5):
            cases[f"{k} x rcb9"] = (cuda_curve.proj_double_k_plain(W, *t(a), k), dbl)
    for name, (got, want) in cases.items():
        assert _values(F, got) == _values(F, [o.arr for o in want]), name

    Wg, kern, vals, flags = goldilocks
    Fg = Wg.F
    tv, jv = t(vals), [jnp.asarray(x) for x in vals]
    tf, jf = t(flags), [jnp.asarray(f) for f in flags]
    kernels = {
        "proj_add": (cuda_curve.proj_add_plain(Wg, *tv), kern.proj_add(*jv)),
        "proj_double_k": (cuda_curve.proj_double_k_plain(Wg, *tv[:3], 2), kern.proj_double_k(*jv[:3], 2)),
        "aff_pair_add": (
            cuda_curve.aff_pair_add_plain(Wg, tv[0], tv[1], tf[0], tf[1], tv[2], tv[3], tf[2], tf[3]),
            kern.aff_pair_add(jv[0], jv[1], jf[0], jf[1], jv[2], jv[3], jf[2], jf[3]),
        ),
    }
    for name, (got, want) in kernels.items():
        assert _values(Fg, got) == _values(Fg, want), name
