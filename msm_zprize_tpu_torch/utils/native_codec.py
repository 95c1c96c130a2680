"""ctypes bindings for the native bytes codec (``csrc/codec.cpp``).

Mirror of ``msm_zprize_tpu/utils/native_codec.py``: the packed-bytes <->
limb conversions and the rejection filter of uniform sampling in C++,
multi-threaded over the elements, for ``fields/bytes_codec.py``. The
library is built with g++ at first use into ``build/`` at the repository
root, under a name derived from a hash of the source and flags (as the
CUDA kernels are, ``_build.py``). Unlike the JAX module it never falls back:
a failed build raises, and there is no environment switch; the numpy path
of ``bytes_codec`` is the twin, chosen by its callers' ``native=False``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from .._build import BUILD_DIR, CSRC

__all__ = ["library", "bytes_to_limbs_native", "limbs_to_bytes_native", "below_bound_native"]

SOURCE = CSRC / "codec.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (or reuse) and load the codec library, argtypes declared."""
    tag = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libmsm_codec_{tag}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or e
            raise RuntimeError(f"the native bytes codec did not build from {SOURCE}: {detail}") from e
        os.replace(tmp, path)  # atomic: a concurrent process never loads a partial file
    lib = ctypes.CDLL(str(path))
    i64, p_u8, p_i32 = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.msm_bytes_to_limbs.argtypes = [p_u8, i64, i64, p_i32, i64, i64]
    lib.msm_limbs_to_bytes.argtypes = [p_i32, i64, i64, i64, p_u8, i64]
    lib.msm_below_bound.argtypes = [p_i32, i64, i64, p_i32, p_u8]
    for fn in (lib.msm_bytes_to_limbs, lib.msm_limbs_to_bytes, lib.msm_below_bound):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bytes_to_limbs_native(data: np.ndarray, n: int, w: int) -> np.ndarray:
    """(B, nbytes) uint8 little-endian -> (n, B) int32 limbs of w bits."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    B, nbytes = data.shape
    out = np.empty((n, B), dtype=np.int32)
    library().msm_bytes_to_limbs(_ptr(data, ctypes.c_uint8), B, nbytes,
                                 _ptr(out, ctypes.c_int32), n, w)
    return out


def limbs_to_bytes_native(limbs: np.ndarray, w: int, nbytes: int) -> np.ndarray:
    """(n, B) int32 limbs of w bits -> (B, nbytes) uint8 little-endian."""
    limbs = np.ascontiguousarray(limbs, dtype=np.int32)
    n, B = limbs.shape
    out = np.empty((B, nbytes), dtype=np.uint8)
    library().msm_limbs_to_bytes(_ptr(limbs, ctypes.c_int32), n, B, w,
                                 _ptr(out, ctypes.c_uint8), nbytes)
    return out


def below_bound_native(limbs: np.ndarray, bound_limbs: np.ndarray) -> np.ndarray:
    """limbs < bound per column: (n, B) against (n,) -> (B,) bool."""
    limbs = np.ascontiguousarray(limbs, dtype=np.int32)
    bound = np.ascontiguousarray(bound_limbs, dtype=np.int32)
    n, B = limbs.shape
    if bound.shape != (n,):
        raise ValueError(f"bound has {bound.shape} limbs; the values have {n}")
    ok = np.empty(B, dtype=np.uint8)
    library().msm_below_bound(_ptr(limbs, ctypes.c_int32), n, B, _ptr(bound, ctypes.c_int32),
                              _ptr(ok, ctypes.c_uint8))
    return ok.astype(bool)
