"""K3-K7 wrappers (``csrc/curve.cuh``, one C entry ``msm_curve`` for every
curve unit ``csrc/curve*.cu``; K14 is the same kernels on row-codec
storage) and their plain PyTorch twins.

Replace the formula bodies of ``msm_zprize_tpu/curves/pallas_curve.py``:

* ``aff_pair_add``   (K3, ``rcb7_unitz``): two signed/valid affine slots ->
  projective sum; invalid lanes act as the identity;
* ``proj_add``       (K4, ``rcb7``): complete projective addition; with a
  per-lane ``mask`` (K4m) lanes where mask == 0 return P1's limbs unchanged;
* ``proj_double_k``  (K5, k x ``rcb9``): k chained complete doublings;
* ``proj_double``    (K6, ``rcb9``): one complete doubling (on the card,
  K5's group kernel at k = 1);
* ``proj_add_mixed`` (K7, ``rcb8``): projective + affine (x2, y2, inf2);
  lanes where inf2 is set return P1's limbs unchanged.

CUDA tensors launch the kernels; CPU tensors run the plain twins, which
follow the JAX package's jnp path (``curves/weierstrass.py``) op for op with
plain field ops, so the two agree exactly mod p (and bit for bit on the
pass-through lanes). Field operands are ``(n, *batch)`` int32 Montgomery
limbs of one batch shape; flags are ``(*batch,)`` integer or bool tensors.

Every curve ops object ``W`` says how it stores a coordinate in
``W.storage`` (a :class:`Storage`): 12-bit limbs (``WeierstrassOps``), or,
for K14, the rows of a codec (``curves/weierstrass51.py``), where field
operands are ``(codec.rows, *batch)`` rows and the wrappers launch the same
formulas on that storage (counted under the ``k14_*`` keys on
``PackedCodec``, ``k14_fma51_*`` on ``Fma51Codec``). The kernels are built
for BLS12-377 (limbs and 13 packed rows), BLS12-381 (the same) and Pallas
(limbs, 9 packed rows, 10 Fma51 pair rows), and for every other field the
limb code takes (n = 1..63) through a shape made on demand: on limbs, on
its PackedCodec rows and, where p < 2^255 - 2^206, on Fma51Codec rows
(``_build.field_shape``); the wrappers name the field's shape and the
codec, and the C entry refuses any other pair. The twins decode the rows to digit planes, run the formulas
and encode the result; the pass-through lanes keep the caller's rows bit
for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from ..counters import COUNTS
from ..fields.codec import CODEC_IDS, codec_id

__all__ = [
    "Storage", "K14", "K14_FMA51", "aff_pair_add", "proj_add", "proj_double_k", "proj_double",
    "proj_add_mixed", "aff_pair_add_plain", "proj_add_plain", "proj_double_k_plain",
    "proj_double_plain", "proj_add_mixed_plain",
]

K3, K4, K4M, K5 = "k3_aff_pair_add", "k4_proj_add", "k4m_proj_add_masked", "k5_proj_double_k"
K6, K7 = "k6_proj_double", "k7_proj_add_mixed"
# the K14 variant of each kernel: the same formula on PackedCodec rows, and
# on Fma51Codec rows
K14 = {k: "k14_" + k for k in (K3, K4, K4M, K5, K6, K7)}
K14_FMA51 = {k: "k14_fma51_" + k for k in (K3, K4, K4M, K5, K6, K7)}
# the kernel ids of the C entry msm_curve (csrc/curve.cuh::CURVE_K3..K7)
KERNEL_IDS = {K3: 3, K4: 4, K4M: 4, K5: 5, K6: 6, K7: 7}
# (key, width, K5's or K12's k, rows, field, the K4m/K7 flag tensor or None)
# of every curve launch, Weierstrass and Edwards (cuda_edwards logs K10-K12
# here), while this is a list (profile_msm's per-width table sets it to []
# and back to None); None: nothing is recorded
LAUNCH_LOG: list | None = None


@dataclass(frozen=True)
class Storage:
    """How a curve ops object stores a coordinate, as the wrappers read it:
    ``rows`` int32 rows per value, the name prefix of its launch counters,
    and its row codec (None: 12-bit Montgomery limbs, which the formulas
    take as they are)."""

    rows: int
    counter: str = ""
    codec: object = None

    @classmethod
    def of_codec(cls, codec) -> "Storage":
        """K14's storage: ``codec``'s rows, counted under ``k14_*`` keys
        (``k14_fma51_*`` on Fma51Codec)."""
        return cls(codec.rows, "k14_fma51_" if codec_id(codec) == CODEC_IDS["Fma51Codec"]
                   else "k14_", codec)

    def decode(self, F, a):
        """A stored field operand as the digit planes the twins compute on."""
        return a if self.codec is None else self.codec.to_digits(F, a)

    def encode(self, F, a):
        """Digit planes of a value < 2p in this storage."""
        return a if self.codec is None else self.codec.from_digits(F, a)

    def words(self, W) -> object:
        """The FieldConsts words of W's kernels (3b as a plain integer, or 0
        where ``W.b3_small`` is None: the kernels then multiply by
        ``W.b3_mont``, on a shape made on demand only)."""
        if W.b3_small is None and _build.field_shape(W.F) < _build.DYN_ID_BASE:
            raise ValueError("the curve kernels of the four main shapes take 3b as a small integer")
        return _build.field_words(W.F, (W.b3_mont, 0), W.b3_small or 0)

    def codec_arg(self, F) -> int:
        """The codec id msm_curve takes (0: limbs), once a codec's rows are
        checked against the kernels' codec table."""
        return 0 if self.codec is None else _build.codec_arg(F, self.codec)


# ---- plain twins (the JAX jnp-path formulas) ---------------------------------
# The formulas run on digit planes (_rcb7, _rcb8, _rcb9, _aff_pair); the
# public twins run them on W's storage (_on_storage) and apply the
# pass-through masks to the caller's own tensors.


def _mul_b3(W, x):
    """3b * x by double-and-add over field additions, as the kernels do; a
    product by 3b R where ``W.b3_small`` is None (3b no small integer)."""
    F = W.F
    if W.b3_small is None:
        return F.montmul_plain(x, F.const(W.b3_mont, x).expand_as(x))
    acc = None
    for bit in bin(W.b3_small)[2:]:
        acc = None if acc is None else F.add(acc, acc)
        if bit == "1":
            acc = x if acc is None else F.add(acc, x)
    return acc


def _pass_through(keep, out, P1):
    """out where keep, else P1's own tensors (bit for bit)."""
    return tuple(torch.where(keep.bool(), o, a) for o, a in zip(out, P1))


def _on_storage(W, formula, args, fields):
    """formula(W, *args) on W's storage: the field operands (positions
    ``fields``) decoded to digit planes, the outputs encoded again."""
    st = W.storage
    dec = [st.decode(W.F, a) if i in fields else a for i, a in enumerate(args)]
    return tuple(st.encode(W.F, o) for o in formula(W, *dec))


def _rcb7(W, X1, Y1, Z1, X2, Y2, Z2):
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


def _rcb8(W, X1, Y1, Z1, x2, y2):
    """Renes-Costello-Batina Alg. 8 (a = 0, Z2 = 1), 11 muls."""
    F = W.F
    M, A, S = F.montmul_plain, F.add, F.sub
    t0 = M(X1, x2)
    t1 = M(Y1, y2)
    t3 = M(A(x2, y2), A(X1, Y1))
    t3 = S(t3, A(t0, t1))
    t4 = A(M(y2, Z1), Y1)
    Y3 = A(M(x2, Z1), X1)
    t0 = A(A(t0, t0), t0)
    t2 = _mul_b3(W, Z1)
    Z3 = A(t1, t2)
    t1 = S(t1, t2)
    Y3 = _mul_b3(W, Y3)
    X3 = S(M(t3, t1), M(t4, Y3))
    Y3 = A(M(t1, Z3), M(Y3, t0))
    Z3 = A(M(Z3, t4), M(t0, t3))
    return X3, Y3, Z3


def _rcb9(W, X1, Y1, Z1):
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


def _aff_pair(W, x1, y1, s1, v1, x2, y2, s2, v2):
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

    return _rcb7(W, *prep(x1, y1, s1, v1), *prep(x2, y2, s2, v2))


def proj_add_plain(W, X1, Y1, Z1, X2, Y2, Z2, mask=None):
    """RCB Alg. 7 (K4's twin); with ``mask`` (K4m's), lanes where mask == 0
    return P1."""
    out = _on_storage(W, _rcb7, (X1, Y1, Z1, X2, Y2, Z2), range(6))
    return out if mask is None else _pass_through(mask, out, (X1, Y1, Z1))


def proj_add_mixed_plain(W, X1, Y1, Z1, x2, y2, inf2):
    """RCB Alg. 8 (K7's twin); lanes where inf2 is set return P1."""
    out = _on_storage(W, _rcb8, (X1, Y1, Z1, x2, y2), range(5))
    return _pass_through(~inf2.bool(), out, (X1, Y1, Z1))


def proj_double_plain(W, X1, Y1, Z1):
    """RCB Alg. 9 (K6's twin)."""
    return _on_storage(W, _rcb9, (X1, Y1, Z1), range(3))


def proj_double_k_plain(W, X1, Y1, Z1, k: int):
    """k chained RCB Alg. 9 doublings (K5's twin)."""

    def chain(W_, *P):
        for _ in range(k):
            P = _rcb9(W_, *P)
        return P

    return _on_storage(W, chain, (X1, Y1, Z1), range(3))


def aff_pair_add_plain(W, x1, y1, s1, v1, x2, y2, s2, v2):
    """K3's twin: the signed/valid slots encoded, then RCB Alg. 7."""
    return _on_storage(W, _aff_pair, (x1, y1, s1, v1, x2, y2, s2, v2), (0, 1, 4, 5))


# ---- kernel wrappers -----------------------------------------------------------


def field_rows(n, arrs, batch):
    """Operands of one batch shape as (n, width) views with unit lane stride
    (and their row strides), copying only those whose lanes are not adjacent;
    n is the rows a value takes (limbs, or a codec's rows)."""
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


def launch(F, words, name, entry, ins, lds, width, batch, n_out, extra=(), n=None):
    """Allocate n_out (n, width) outputs (n: F.n limbs unless given, the
    rows of a codec), launch ``entry`` on F's field shape, count it, and
    return the outputs in the operands' batch shape."""
    n = F.n if n is None else n
    device = ins[0].device
    outs = [torch.empty((n, width), dtype=torch.int32, device=device) for _ in range(n_out)]
    if width:
        shape = _build.field_shape(F)
        lib, _ = _build.library(shape)
        code = getattr(lib, entry)(
            _build.ptrs(*ins, *outs), _build.ints(lds + [width] * n_out), width,
            shape, *extra, words, _build.stream_of(outs[0]),
        )
        _build.check(code, name)
        COUNTS[name] += 1
    return tuple(o.reshape((n,) + tuple(batch)) for o in outs)


def _launch(W, name, ins, lds, width, batch, arg=0, group=0):
    """Launch the curve kernel ``name`` on W's storage (``arg``: K4's masked
    flag, K5's k; ``group``: 0 for the instance the kernels' own width table
    picks, else the G of a built instance), counted under ``name`` with the
    storage's prefix, and logged where ``LAUNCH_LOG`` is a list."""
    st = W.storage
    extra = (KERNEL_IDS[name], st.codec_arg(W.F), arg, group)
    if LAUNCH_LOG is not None and width:
        flags = ins[6] if name == K4M else (ins[5] if name == K7 else None)
        LAUNCH_LOG.append((st.counter + name, width, arg if name == K5 else 0, st.rows, W.F, flags))
    return launch(W.F, st.words(W), st.counter + name, "msm_curve", ins, lds, width, batch, 3,
                  extra, n=st.rows)


def aff_pair_add(W, x1, y1, s1, v1, x2, y2, s2, v2):
    """K3: operand i is ((-1)^s_i * (x_i, y_i)) where v_i != 0, else the
    identity; x_i, y_i raw affine coordinates (< 2p). Returns (X3, Y3, Z3)."""
    return _aff_pair_add(W, 0, x1, y1, s1, v1, x2, y2, s2, v2)


def _aff_pair_add(W, group, x1, y1, s1, v1, x2, y2, s2, v2):
    """``aff_pair_add`` on the instance with G = ``group`` threads a point
    (one of ``_groups``; 0: the one the width table picks, as
    ``aff_pair_add`` does). For comparing the instances on the card; the
    engines call ``aff_pair_add``."""
    args = (x1, y1, s1, v1, x2, y2, s2, v2)
    if _build.on_cpu(*args):
        return aff_pair_add_plain(W, *args)
    batch = x1.shape[1:]
    (fx1, fy1, fx2, fy2), lds, width = field_rows(W.storage.rows, (x1, y1, x2, y2), batch)
    fl = flag_rows((s1, v1, s2, v2), width)
    ins = (fx1, fy1, fl[0], fl[1], fx2, fy2, fl[2], fl[3])
    lds = [lds[0], lds[1], 0, 0, lds[2], lds[3], 0, 0]
    return _launch(W, K3, ins, lds, width, batch, group=group)


def proj_add(W, X1, Y1, Z1, X2, Y2, Z2, mask=None):
    """K4: complete projective add of (X1:Y1:Z1) and (X2:Y2:Z2); with
    ``mask`` (K4m), lanes where mask == 0 return (X1, Y1, Z1) bit for bit."""
    return _proj_add(W, 0, X1, Y1, Z1, X2, Y2, Z2, mask=mask)


def _proj_add(W, group, X1, Y1, Z1, X2, Y2, Z2, mask=None):
    """``proj_add`` on the instance with G = ``group`` threads a point (one
    of ``_groups``; 0: the one the width table picks, as ``proj_add``
    does). For comparing the instances on the card; the engines call
    ``proj_add``."""
    ops = (X1, Y1, Z1, X2, Y2, Z2)
    if _build.on_cpu(*ops, *(() if mask is None else (mask,))):
        return proj_add_plain(W, *ops, mask=mask)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(W.storage.rows, ops, batch)
    if mask is not None:
        ins = ins + flag_rows((mask,), width)
        lds = lds + [0]
    return _launch(W, K4 if mask is None else K4M, ins, lds, width, batch,
                   arg=int(mask is not None), group=group)


def proj_double(W, X1, Y1, Z1):
    """K6: one complete doubling (the C entry launches K5's group instance
    at k = 1; counted under K6's own key)."""
    if _build.on_cpu(X1, Y1, Z1):
        return proj_double_plain(W, X1, Y1, Z1)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(W.storage.rows, (X1, Y1, Z1), batch)
    return _launch(W, K6, ins, lds, width, batch)


def proj_add_mixed(W, X1, Y1, Z1, x2, y2, inf2):
    """K7: (X1:Y1:Z1) + the affine point (x2, y2), or P1 bit for bit where
    inf2 is set (the affine operand is infinity)."""
    return _proj_add_mixed(W, 0, X1, Y1, Z1, x2, y2, inf2)


def _proj_add_mixed(W, group, X1, Y1, Z1, x2, y2, inf2):
    """``proj_add_mixed`` on the instance with G = ``group`` threads a point
    (one of ``_groups``; 0: the width table's pick). For comparing the
    instances on the card; the engines call ``proj_add_mixed``."""
    args = (X1, Y1, Z1, x2, y2, inf2)
    if _build.on_cpu(*args):
        return proj_add_mixed_plain(W, *args)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(W.storage.rows, (X1, Y1, Z1, x2, y2), batch)
    ins = ins + flag_rows((inf2,), width)
    return _launch(W, K7, ins, lds + [0], width, batch, group=group)


def proj_double_k(W, X1, Y1, Z1, k: int):
    """K5: k chained complete doublings in one launch (k >= 1)."""
    return _proj_double_k(W, 0, X1, Y1, Z1, k)


def _proj_double_k(W, group, X1, Y1, Z1, k: int):
    """``proj_double_k`` on the instance with G = ``group`` threads a point
    (one of ``_groups``; 0: the width table's pick). For comparing the
    instances on the card; the engines call ``proj_double_k``."""
    if k < 1:
        raise ValueError("proj_double_k needs k >= 1")
    if _build.on_cpu(X1, Y1, Z1):
        return proj_double_k_plain(W, X1, Y1, Z1, k)
    batch = X1.shape[1:]
    ins, lds, width = field_rows(W.storage.rows, (X1, Y1, Z1), batch)
    return _launch(W, K5, ins, lds, width, batch, arg=k, group=group)


def _group_for(W, name: str, width: int) -> int:
    """G, the threads a point, of the instance that kernel ``name`` (K3,
    K4, K4m, K5, K7) launches with at ``width`` lanes on W's field and storage:
    the kernels' own table (csrc/curve.cuh::curve_group)."""
    shape = _build.field_shape(W.F)
    lib, _ = _build.library(shape)
    return lib.msm_curve_group(shape, W.storage.codec_arg(W.F),
                               KERNEL_IDS[name], width, int(name == K4M))


def _groups(W, name: str) -> tuple[int, ...]:
    """The Gs of the instances of kernel ``name`` (K3, K4, K4m, K5, K7)
    built on W's field and storage, as the kernels' library lists them
    (csrc/curve.cuh::K3Groups, K4Groups, K4mGroups, K5Groups, K7Groups)."""
    shape, out = _build.field_shape(W.F), (ctypes.c_int * 8)()
    lib, _ = _build.library(shape)
    count = lib.msm_curve_groups(shape, W.storage.codec_arg(W.F), KERNEL_IDS[name],
                                 int(name == K4M), out, 8)
    if not 0 < count <= 8:
        raise RuntimeError(f"{name}: the library lists {count} instances on field shape {shape}")
    return tuple(out[:count])
