"""K3, K4, K5 wrappers (``csrc/curve.cu``) and their plain PyTorch twins.

Replace the formula bodies of ``msm_zprize_tpu/curves/pallas_curve.py``:

* ``aff_pair_add``  (K3, ``rcb7_unitz``): two signed/valid affine slots ->
  projective sum; invalid lanes act as the identity;
* ``proj_add``      (K4, ``rcb7``): complete projective addition;
* ``proj_double_k`` (K5, k x ``rcb9``): k chained complete doublings.

CUDA tensors launch the kernels; CPU tensors run the plain twins, which
follow the JAX package's jnp path (``curves/weierstrass.py``) op for op with
plain field ops, so the two agree exactly mod p. Field operands are
``(n, *batch)`` int32 Montgomery limbs of one batch shape; flags are
``(*batch,)`` integer or bool tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..counters import COUNTS

__all__ = [
    "aff_pair_add", "proj_add", "proj_double_k",
    "aff_pair_add_plain", "proj_add_plain", "proj_double_k_plain",
]

K3, K4, K5 = "k3_aff_pair_add", "k4_proj_add", "k5_proj_double_k"


# ---- plain twins (the JAX jnp-path formulas) ---------------------------------


def _mul_b3(W, x):
    """3b * x by double-and-add over field additions, as the kernels do."""
    F = W.F
    acc = None
    for bit in bin(W.b3_small)[2:]:
        acc = None if acc is None else F.add(acc, acc)
        if bit == "1":
            acc = x if acc is None else F.add(acc, x)
    return acc


def proj_add_plain(W, X1, Y1, Z1, X2, Y2, Z2):
    """Renes-Costello-Batina Alg. 7 (a = 0), 12 muls."""
    F = W.F
    M, A, S = F.montmul_plain, F.add, F.sub
    t0 = M(X1, X2)
    t1 = M(Y1, Y2)
    t2 = M(Z1, Z2)
    t3 = M(A(X1, Y1), A(X2, Y2))
    t3 = S(t3, A(t0, t1))
    t4 = M(A(Y1, Z1), A(Y2, Z2))
    t4 = S(t4, A(t1, t2))
    Y3 = M(A(X1, Z1), A(X2, Z2))
    Y3 = S(Y3, A(t0, t2))
    t0 = A(A(t0, t0), t0)
    t2 = _mul_b3(W, t2)
    Z3 = A(t1, t2)
    t1 = S(t1, t2)
    Y3 = _mul_b3(W, Y3)
    X3 = S(M(t3, t1), M(t4, Y3))
    Y3 = A(M(t1, Z3), M(Y3, t0))
    Z3 = A(M(Z3, t4), M(t0, t3))
    return X3, Y3, Z3


def _double_plain(W, X1, Y1, Z1):
    """Renes-Costello-Batina Alg. 9 (a = 0), 8 muls."""
    F = W.F
    M, A, S = F.montmul_plain, F.add, F.sub
    t0 = M(Y1, Y1)
    Z3 = A(t0, t0)
    Z3 = A(Z3, Z3)
    Z3 = A(Z3, Z3)
    t1 = M(Y1, Z1)
    t2 = _mul_b3(W, M(Z1, Z1))
    X3 = M(t2, Z3)
    Y3 = A(t0, t2)
    Z3 = M(t1, Z3)
    t2 = A(A(t2, t2), t2)
    t0 = S(t0, t2)
    Y3 = A(X3, M(t0, Y3))
    t1 = M(X1, Y1)
    X3 = M(t0, t1)
    return A(X3, X3), Y3, Z3


def proj_double_k_plain(W, X1, Y1, Z1, k: int):
    P = (X1, Y1, Z1)
    for _ in range(k):
        P = _double_plain(W, *P)
    return P


def aff_pair_add_plain(W, x1, y1, s1, v1, x2, y2, s2, v2):
    """Sign + identity encoding of both slots, then the complete add."""
    F = W.F

    def prep(x, y, s, v):
        v = v.bool()
        one = F.ones_mont(*x.shape[1:], device=x.device)
        zero = torch.zeros_like(x)
        return (
            torch.where(v, x, zero),
            torch.where(v, F.cneg(y, s), one),
            torch.where(v, one, zero),
        )

    return proj_add_plain(W, *prep(x1, y1, s1, v1), *prep(x2, y2, s2, v2))


# ---- kernel wrappers -----------------------------------------------------------


def field_rows(F, arrs, batch):
    """Operands of one batch shape as (n, width) views with unit lane stride
    (and their row strides), copying only those whose lanes are not adjacent."""
    n = F.n
    if any(tuple(a.shape[1:]) != tuple(batch) for a in arrs):
        raise ValueError(f"operands differ in batch shape: {[tuple(a.shape) for a in arrs]}")
    # (n, W) views where the batch axes merge with unit lane stride (slices
    # of the slot axis do); other layouts are copied into one
    flat = [a.reshape(n, -1) for a in arrs]
    flat = [a if a.shape[1] <= 1 or a.stride(1) == 1 else a.contiguous() for a in flat]
    width = flat[0].shape[1]
    lds = [_build.rows(a, n, width, f"operand {i}") for i, a in enumerate(flat)]
    return flat, lds, width


def flag_rows(flags, width):
    """Per-lane flags as contiguous int32 (width,) vectors."""
    out = []
    for i, f in enumerate(flags):
        f = f.reshape(-1).to(torch.int32).contiguous()
        _build.flags(f, width, f"flag {i}")
        out.append(f)
    return out


def launch(F, words, name, entry, ins, lds, width, batch, n_out, extra=()):
    """Allocate n_out (n, width) outputs, launch ``entry``, count it, and
    return the outputs in the operands' batch shape."""
    n = F.n
    device = ins[0].device
    outs = [torch.empty((n, width), dtype=torch.int32, device=device) for _ in range(n_out)]
    if width:
        lib, _ = _build.library()
        code = getattr(lib, entry)(
            _build.ptrs(*ins, *outs), _build.ints(lds + [width] * n_out), width, n, *extra,
            words, _build.stream_of(outs[0]),
        )
        _build.check(code, name)
        COUNTS[name] += 1
    return tuple(o.reshape((n,) + tuple(batch)) for o in outs)


def _launch(W, name, entry, ins, lds, width, batch, extra=()):
    words = _build.field_words(W.F, (W.b3_mont, 0), W.b3_small)
    return launch(W.F, words, name, entry, ins, lds, width, batch, 3, extra)


def aff_pair_add(W, x1, y1, s1, v1, x2, y2, s2, v2):
    """K3: operand i is ((-1)^s_i * (x_i, y_i)) where v_i != 0, else the
    identity; x_i, y_i raw affine coordinates (< 2p). Returns (X3, Y3, Z3)."""
    if _build.on_cpu(x1, y1, s1, v1, x2, y2, s2, v2):
        return aff_pair_add_plain(W, x1, y1, s1, v1, x2, y2, s2, v2)
    batch = x1.shape[1:]
    (fx1, fy1, fx2, fy2), lds, width = field_rows(W.F, (x1, y1, x2, y2), batch)
    fl = flag_rows((s1, v1, s2, v2), width)
    ins = (fx1, fy1, fl[0], fl[1], fx2, fy2, fl[2], fl[3])
    lds = [lds[0], lds[1], 0, 0, lds[2], lds[3], 0, 0]
    return _launch(W, K3, "msm_aff_pair_add", ins, lds, width, batch)


def proj_add(W, X1, Y1, Z1, X2, Y2, Z2):
    """K4: complete projective add of (X1:Y1:Z1) and (X2:Y2:Z2)."""
    if _build.on_cpu(X1, Y1, Z1, X2, Y2, Z2):
        return proj_add_plain(W, X1, Y1, Z1, X2, Y2, Z2)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(W.F, (X1, Y1, Z1, X2, Y2, Z2), batch)
    return _launch(W, K4, "msm_proj_add", ins, lds, width, batch)


def proj_double_k(W, X1, Y1, Z1, k: int):
    """K5: k chained complete doublings in one launch (k >= 1)."""
    if k < 1:
        raise ValueError("proj_double_k needs k >= 1")
    if _build.on_cpu(X1, Y1, Z1):
        return proj_double_k_plain(W, X1, Y1, Z1, k)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(W.F, (X1, Y1, Z1), batch)
    return _launch(W, K5, "msm_proj_double_k", ins, lds, width, batch, extra=(k,))
