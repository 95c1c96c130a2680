"""K10, K11, K12 wrappers (``csrc/edwards.cu``) and their plain PyTorch twins.

Replace the formula bodies of ``msm_zprize_tpu/curves/pallas_curve.py``'s
``EdwardsKernels``:

* ``ed_pair_add`` (K10, ``hwcd3_unitz``): two signed/valid affine slots ->
  extended sum; invalid lanes act as the identity (0, 1, 1, 0);
* ``ed_add``      (K11, ``hwcd3``): strongly unified extended add, k = 2d,
  with an optional per-lane mask (mask == 0 passes the first operand);
* ``ed_double_k`` (K12, k x ``hwcd3`` doubling): k chained doublings.

CUDA tensors launch the kernels; CPU tensors run the plain twins, which
follow the JAX package's jnp path (``curves/edwards.py::EdwardsOps.add`` and
``ed_pair_add``) op for op with plain field ops, so kernel and twin agree
exactly mod p. ``E`` is an ``EdwardsOps`` (its field ``F``, ``k_mont`` and
``two_mont``); field operands are ``(n, *batch)`` int32 Montgomery limbs of
one batch shape, flags ``(*batch,)`` integer or bool tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import cuda_curve
from .cuda_curve import field_rows, flag_rows

__all__ = [
    "ed_pair_add", "ed_add", "ed_double_k",
    "ed_pair_add_plain", "ed_add_plain", "ed_double_k_plain",
]

K10, K11, K11M, K12 = "k10_ed_pair_add", "k11_ed_add", "k11m_ed_add_masked", "k12_ed_double_k"


# ---- plain twins (the JAX jnp-path formulas) ---------------------------------


def ed_add_plain(E, X1, Y1, Z1, T1, X2, Y2, Z2, T2, mask=None):
    """2008-hwcd-3 (a = -1, k = 2d), as JAX ``EdwardsOps.add`` off the TPU."""
    F = E.F
    M = F.montmul_plain
    A = M(F.sub_positive(Y1, X1), F.sub_positive(Y2, X2))
    B = M(F.add(Y1, X1), F.add(Y2, X2))
    C = M(M(T1, F.const(E.k_mont, T1)), T2)
    ZZ = M(Z1, Z2)
    D = F.add(ZZ, ZZ)
    Ee, Fc, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    out = (M(Ee, Fc), M(G, H), M(Fc, G), M(Ee, H))
    if mask is not None:
        out = tuple(torch.where(mask.bool(), o, a) for o, a in zip(out, (X1, Y1, Z1, T1)))
    return out


def ed_double_k_plain(E, X1, Y1, Z1, T1, k: int):
    P = (X1, Y1, Z1, T1)
    for _ in range(k):
        P = ed_add_plain(E, *P, *P)
    return P


def ed_pair_add_plain(E, x1, y1, s1, v1, x2, y2, s2, v2):
    """Sign + identity encoding of both slots (Z = 1, T = x y), then the
    unified add."""
    F = E.F

    def prep(x, y, s, v):
        v = v.bool()
        one = F.ones_mont(*x.shape[1:], device=x.device)
        xs = torch.where(v, F.cneg(x, s), torch.zeros_like(x))
        ys = torch.where(v, y, one)
        return xs, ys, one, F.montmul_plain(xs, ys)

    return ed_add_plain(E, *prep(x1, y1, s1, v1), *prep(x2, y2, s2, v2))


# ---- kernel wrappers -----------------------------------------------------------


def _words(E):
    return _build.field_words(E.F, (E.k_mont, E.two_mont))


def _launch(E, name, entry, ins, lds, width, batch, extra=(), k=0):
    """Launch ``entry`` and count it under ``name``, logged (with K12's k)
    where ``cuda_curve.LAUNCH_LOG`` is a list."""
    if cuda_curve.LAUNCH_LOG is not None and width:
        cuda_curve.LAUNCH_LOG.append((name, width, k, E.F.n, E.F, None))
    return cuda_curve.launch(E.F, _words(E), name, entry, ins, lds, width, batch, 4, extra)


def ed_pair_add(E, x1, y1, s1, v1, x2, y2, s2, v2):
    """K10: operand i is the affine point ((-1)^s_i x_i, y_i) where v_i != 0,
    else the identity; x_i, y_i raw affine coordinates. Returns (X, Y, Z, T)."""
    return _ed_pair_add(E, 0, x1, y1, s1, v1, x2, y2, s2, v2)


def _ed_pair_add(E, group, x1, y1, s1, v1, x2, y2, s2, v2):
    """``ed_pair_add`` on the instance with G = ``group`` threads a point
    (one of ``_k10_groups``; 0: the one the width table picks, as
    ``ed_pair_add`` does). For comparing the instances on the card; the
    engines call ``ed_pair_add``."""
    if _build.on_cpu(x1, y1, s1, v1, x2, y2, s2, v2):
        return ed_pair_add_plain(E, x1, y1, s1, v1, x2, y2, s2, v2)
    batch = x1.shape[1:]
    (fx1, fy1, fx2, fy2), lds, width = field_rows(E.F.n, (x1, y1, x2, y2), batch)
    fl = flag_rows((s1, v1, s2, v2), width)
    ins = (fx1, fy1, fl[0], fl[1], fx2, fy2, fl[2], fl[3])
    lds = [lds[0], lds[1], 0, 0, lds[2], lds[3], 0, 0]
    return _launch(E, K10, "msm_ed_pair_add", ins, lds, width, batch, extra=(group,))


def _k10_group_for(E, width: int) -> int:
    """G, the threads a point, of the K10 instance that ``ed_pair_add``
    launches at ``width`` lanes on E's field: the kernels' own table
    (``csrc/edwards.cu::k10_group``)."""
    shape = _build.field_shape(E.F)
    lib, _ = _build.library(shape)
    return lib.msm_ed_pair_add_group(shape, width)


def _k10_groups(E) -> tuple[int, ...]:
    """The Gs of K10's instances built on E's field, as the kernels' library
    lists them (``csrc/edwards.cu::K10Groups``)."""
    shape, out = _build.field_shape(E.F), (ctypes.c_int * 8)()
    lib, _ = _build.library(shape)
    count = lib.msm_ed_pair_add_groups(shape, out, 8)
    if not 0 < count <= 8:
        raise RuntimeError(f"K10: the library lists {count} instances on field shape {shape}")
    return tuple(out[:count])


def ed_add(E, X1, Y1, Z1, T1, X2, Y2, Z2, T2, mask=None):
    """K11: unified add of (X1:Y1:Z1:T1) and (X2:Y2:Z2:T2); with ``mask``,
    lanes where mask == 0 return the first operand bit for bit (counted
    under K11M: no MSM path runs the masked kernel)."""
    ops = (X1, Y1, Z1, T1, X2, Y2, Z2, T2)
    if _build.on_cpu(*ops, *(() if mask is None else (mask,))):
        return ed_add_plain(E, *ops, mask=mask)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(E.F.n, ops, batch)
    if mask is not None:
        ins = ins + flag_rows((mask,), width)
        lds = lds + [0]
    return _launch(E, K11 if mask is None else K11M, "msm_ed_add", ins, lds, width, batch,
                   extra=(int(mask is not None),))


def ed_double_k(E, X1, Y1, Z1, T1, k: int):
    """K12: k chained unified doublings in one launch (k >= 1)."""
    if k < 1:
        raise ValueError("ed_double_k needs k >= 1")
    if _build.on_cpu(X1, Y1, Z1, T1):
        return ed_double_k_plain(E, X1, Y1, Z1, T1, k)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(E.F.n, (X1, Y1, Z1, T1), batch)
    return _launch(E, K12, "msm_ed_double_k", ins, lds, width, batch, extra=(k,), k=k)
