"""Host-side packed bytes <-> limb arrays, and uniform limbs below a bound.

Mirror of ``msm_zprize_tpu/fields/bytes_codec.py``: little-endian byte rows
(B, nbytes) uint8 and canonical limb arrays (n, B) int32 converted with
numpy, vectorised over the B values (a loop over limbs or bytes only), and
rejection-sampled uniform values in [0, bound) that draw the same bytes, in
the same order, as the JAX package, so one seed gives the same limbs in
both. ``bytes_to_limbs``, ``limbs_to_bytes`` and ``_less_than`` run the
native C++ tier (``utils/native_codec.py`` over ``csrc/codec.cpp``, built at
first use; a failed build raises) unless the caller passes ``native=False``
for the numpy path, their twin.
"""

from __future__ import annotations

import numpy as np

from ..utils import native_codec
from .limbs import LimbScheme

__all__ = [
    "bytes_to_limbs",
    "limbs_to_bytes",
    "ints_to_bytes",
    "bytes_to_ints",
    "random_uniform_limbs",
]


def bytes_to_limbs(data: np.ndarray, scheme: LimbScheme, native: bool = True) -> np.ndarray:
    """(B, nbytes) uint8 little-endian -> (n, B) int32 canonical limbs."""
    if data.dtype != np.uint8 or data.ndim != 2:
        raise ValueError(f"expected a (B, nbytes) uint8 array, got {data.dtype} {data.shape}")
    if native:
        return native_codec.bytes_to_limbs_native(data, scheme.n, scheme.w)
    B, nbytes = data.shape
    out = np.zeros((scheme.n, B), dtype=np.int32)
    for i in range(scheme.n):
        lo_bit = scheme.w * i
        acc = np.zeros(B, dtype=np.int64)
        for j in range(lo_bit // 8, min((lo_bit + scheme.w + 7) // 8, nbytes)):
            shift = 8 * j - lo_bit
            b = data[:, j].astype(np.int64)
            acc += (b << shift) if shift >= 0 else (b >> -shift)
        out[i] = (acc & scheme.mask).astype(np.int32)
    return out


def limbs_to_bytes(limbs: np.ndarray, scheme: LimbScheme, nbytes: int | None = None,
                   native: bool = True) -> np.ndarray:
    """(n, B) canonical int32 limbs -> (B, nbytes) uint8 little-endian
    (nbytes defaults to the scheme's capacity, rounded up to whole bytes)."""
    n, B = limbs.shape
    if nbytes is None:
        nbytes = (scheme.bits + 7) // 8
    if native:
        return native_codec.limbs_to_bytes_native(limbs, scheme.w, nbytes)
    out = np.zeros((B, nbytes), dtype=np.uint8)
    for j in range(nbytes):
        lo_bit = 8 * j
        acc = np.zeros(B, dtype=np.int64)
        for i in range(max(lo_bit - scheme.w + 1, 0) // scheme.w,
                       min((lo_bit + 8 + scheme.w - 1) // scheme.w, n)):
            shift = scheme.w * i - lo_bit
            v = limbs[i].astype(np.int64)
            acc += (v << shift) if shift >= 0 else (v >> -shift)
        out[:, j] = (acc & 0xFF).astype(np.uint8)
    return out


def ints_to_bytes(values, nbytes: int) -> np.ndarray:
    """Python ints -> (B, nbytes) uint8 little-endian."""
    raw = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(values), nbytes).copy()


def bytes_to_ints(data: np.ndarray) -> list[int]:
    """(B, nbytes) uint8 little-endian -> Python ints."""
    return [int.from_bytes(row.tobytes(), "little") for row in data]


def _less_than(limbs: np.ndarray, bound_limbs: np.ndarray, native: bool = True) -> np.ndarray:
    """limbs < bound per column, compared lexicographically from the top
    limb: (n, B) against (n,) -> (B,) bool."""
    if native:
        return native_codec.below_bound_native(limbs, bound_limbs)
    lt = np.zeros(limbs.shape[1], dtype=bool)
    decided = np.zeros(limbs.shape[1], dtype=bool)
    for i in range(limbs.shape[0] - 1, -1, -1):
        bi = int(bound_limbs[i])
        lt |= ~decided & (limbs[i] < bi)
        decided |= limbs[i] != bi
    return lt


def random_uniform_limbs(rng: np.random.Generator, bound: int, count: int,
                         scheme: LimbScheme) -> np.ndarray:
    """(n, count) canonical limbs uniform in [0, bound), by rejection
    sampling of bit_length(bound)-bit strings."""
    bits = bound.bit_length()
    nbytes = (bits + 7) // 8
    top_mask = (1 << (bits - 8 * (nbytes - 1))) - 1 if bits % 8 else 0xFF
    bound_limbs = np.array(scheme.to_limbs(bound), dtype=np.int64)
    out = np.zeros((scheme.n, count), dtype=np.int32)
    todo = np.arange(count)
    while todo.size:
        draw = rng.integers(0, 256, size=(todo.size, nbytes), dtype=np.uint8)
        draw[:, -1] &= top_mask
        limbs = bytes_to_limbs(draw, scheme)
        ok = _less_than(limbs, bound_limbs)
        out[:, todo[ok]] = limbs[:, ok]
        todo = todo[~ok]
    return out
