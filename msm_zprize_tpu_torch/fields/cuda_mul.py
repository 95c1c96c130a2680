"""K1 and K8 wrappers: Montgomery product and static exponentiation
(``csrc/montmul.cu``).

K1 replaces ``msm_zprize_tpu/fields/pallas_mul.py::montmul_pallas``. On the
Weierstrass main paths (BLS12-377, BLS12-381, Pallas) it computes beta * x
for the GLV endomorphism over all N points; on the Edwards path it carries ``batch_inverse``. K8 replaces
``exp_const_pallas``: x^e in one launch, the Fermat inverse at the bottom of
``batch_inverse``. CUDA tensors launch the kernels; CPU tensors run the
plain twins ``MontgomeryFp.montmul_plain`` (the JAX conv path's algorithm)
and ``MontgomeryFp.exp_const_plain`` (the JAX windowed square-and-multiply).

K8's chain is a list of ops that ``exp_chain`` writes on the host
(sliding windows over odd powers; ``csrc/montmul.cu`` says how the kernel
walks it, one warp a lane). ``_exp_probe`` runs x^e on one thread a lane
by binary square-and-multiply with the one-thread product of K1-K14
(field.cuh's ``mont_mul``), the chain K8 ran before: a probe of that
product's latency, which no path launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..counters import COUNTS

__all__ = ["montmul", "exp_const", "exp_chain", "exp_products"]

KERNEL = "k1_montmul"
K8 = "k8_exp_const"
K8_PROBE = "k8_probe_exp_mont_mul"  # K8's probe: on no path

# K8's ops (csrc/montmul.cu): kind << 6 | slot. MUL: cur *= slot (slot CUR:
# a square); SAVE: slot = cur; LOAD: cur = slot. Slots 0-15 hold the odd
# powers x^(2t+1), X2 x^2.
MUL, SAVE, LOAD = 0, 1, 2
X2, CUR = 16, 31
WINDOW_MAX = 5


def montmul(F, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x*y*R^-1 mod p for (n, W) int32 limb tensors (values < 4p; CUDA
    operands may have strided limb rows). Output (n, W): canonical limbs,
    value < 2p; the twin's integer, except on a field with 4p > 2^(32 NW)
    (Pallas), whose kernel reduces inputs of 2p and above first (equal mod
    p)."""
    if _build.on_cpu(x, y):
        return F.montmul_plain(x, y)
    n, W = F.n, x.shape[-1]
    lds = [_build.rows(x, n, W, "x"), _build.rows(y, n, W, "y"), W]
    words = _build.field_words(F)
    out = torch.empty((n, W), dtype=torch.int32, device=x.device)
    if W == 0:
        return out
    shape = _build.field_shape(F)
    lib, _ = _build.library(shape)
    code = lib.msm_montmul(_build.ptrs(x, y, out), _build.ints(lds), W, shape, words,
                           _build.stream_of(x))
    _build.check(code, KERNEL)
    COUNTS[KERNEL] += 1
    return out


def _window_ops(e: int, window: int) -> list[int]:
    """The op list of x^e with sliding windows of up to ``window`` bits:
    the table x, x^3, .., x^(2^window - 1) (from x^2), then MSB first each
    window that starts and ends on a one bit (the first taken from the
    table, the others after as many squarings as it has bits), single
    squarings between windows."""
    if e == 0:
        return []
    ops = [SAVE << 6]
    if window > 1:
        ops += [MUL << 6 | CUR, SAVE << 6 | X2, LOAD << 6]
        for t in range(1, 1 << (window - 1)):
            ops += [MUL << 6 | X2, SAVE << 6 | t]
    i, started = e.bit_length() - 1, False
    while i >= 0:
        if not (e >> i) & 1:
            ops.append(MUL << 6 | CUR)
            i -= 1
            continue
        low = max(i - window + 1, 0)
        while not (e >> low) & 1:
            low += 1
        t = ((e >> low) & ((1 << (i - low + 1)) - 1)) >> 1  # the odd power x^(2t+1)
        if started:
            ops += [MUL << 6 | CUR] * (i - low + 1) + [MUL << 6 | t]
        else:
            ops.append(LOAD << 6 | t)
            started = True
        i = low - 1
    return ops


def exp_products(ops: list[int]) -> int:
    """The products (MUL ops) of an op list: those x^e needs; K8's chain
    has two more, into and out of its own domain."""
    return sum(op >> 6 == MUL for op in ops)


@functools.lru_cache(maxsize=64)
def exp_chain(e: int) -> tuple[int, ...]:
    """K8's op list for x^e: of the window widths 1 to 5, the first whose
    list has the fewest products."""
    return tuple(min((_window_ops(e, w) for w in range(1, WINDOW_MAX + 1)), key=exp_products))


@functools.lru_cache(maxsize=64)
def _exp_args(F, e: int) -> ctypes.Array:
    """The words of K8's ExpArgs for field F and exponent e: the op list
    (4 ops a word), then p, -p^-1 mod R', R'^2 / R mod p and R mod p as
    30-bit digits, R' = 2^(30 digits), the digits of F's shape; or, on a
    shape that K8 runs one thread a lane (more than 12 words), ExpWideArgs:
    the op list alone."""
    shape = _build.field_shape(F)
    lib, _ = _build.library(shape)
    layout = (ctypes.c_int * 7)()
    nd = lib.msm_exp_layout(shape, layout)
    op_words, dmax, ebits, nwords = layout[:4] if nd else (layout[4], 0, layout[5], layout[6])
    if e.bit_length() > ebits:
        raise ValueError(f"the K8 kernel takes exponents below 2^{ebits} on this field")
    ops = list(exp_chain(e))
    if len(ops) > 4 * op_words:
        raise ValueError(f"K8's chain for this exponent has {len(ops)} ops; the kernel takes {4 * op_words}")
    ops += [0] * (4 * op_words - len(ops))
    words = [len(exp_chain(e))] + [sum(ops[4 * i + k] << (8 * k) for k in range(4)) for i in range(op_words)]
    if nd:
        r_chain = 1 << (30 * nd)
        consts = (F.p, (-pow(F.p, -1, r_chain)) % r_chain,
                  r_chain * r_chain * pow(F.R, -1, F.p) % F.p, F.mont_one)
        for c in consts:
            words += [(c >> (30 * q)) & ((1 << 30) - 1) for q in range(dmax)]
    assert len(words) == nwords, (len(words), nwords)
    return _build.ints(words, ctypes.c_uint32)


def _exp_launch(F, x: torch.Tensor, entry: str, key: str, args: ctypes.Array) -> torch.Tensor:
    """Launch ``entry`` (K8 or its probe) on x with its host words
    ``args``, counted under ``key``."""
    n, W = F.n, x.shape[-1]
    lds = [_build.rows(x, n, W, "x"), W]
    words = _build.field_words(F)
    out = torch.empty((n, W), dtype=torch.int32, device=x.device)
    if W == 0:
        return out
    shape = _build.field_shape(F)
    lib, _ = _build.library(shape)
    code = getattr(lib, entry)(_build.ptrs(x, out), _build.ints(lds), W, shape, args, words,
                               _build.stream_of(x))
    _build.check(code, key)
    COUNTS[key] += 1
    return out


def exp_const(F, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a static exponent 0 <= e < 2^384 (2^768 on fields of more
    than 12 words) on (n, W) Montgomery limbs
    (values < 4p; CUDA operands may have strided limb rows). Output (n, W):
    canonical limbs, value < 2p (e = 0 gives one); equal to the twin mod p."""
    if e < 0:
        raise ValueError("exp_const needs e >= 0")
    if _build.on_cpu(x):
        return F.exp_const_plain(x, e)
    return _exp_launch(F, x, "msm_exp_const", K8, _exp_args(F, e))


def probe_products(e: int) -> int:
    """The products of the probe's chain for x^e: e's bit length plus its
    popcount (a squaring a bit, a multiply a one bit)."""
    return e.bit_length() + bin(e).count("1")


def _exp_probe(F, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e (0 <= e < 2^384) by MSB-first binary square-and-multiply on one
    thread a lane with the one-thread product of K1-K14, operands in
    registers (CUDA tensors only): its time over ``probe_products(e)`` is
    that product's dependent latency."""
    if not 0 <= e < 1 << 384 or _build.on_cpu(x):
        raise ValueError("the K8 probe takes 0 <= e < 2^384 and CUDA tensors")
    bits = [(e >> (32 * i)) & 0xFFFFFFFF for i in range(12)] + [e.bit_length()]
    return _exp_launch(F, x, "msm_exp_probe", K8_PROBE, _build.ints(bits, ctypes.c_uint32))
