"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file compiles with ``nvcc`` into ONE shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). The library lands in ``build/`` at the repository root under a
name derived from a hash of the sources and flags, so a rebuilt checkout
reuses it and an edited source builds anew. Each C entry point launches on
the stream it is given, never synchronises, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.

Counterpart of the JAX package's build-on-first-use idiom
(``native/Makefile``, ``msm_zprize_tpu/utils/native_codec.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "BuildInfo", "library", "check", "ptrs", "ints", "stream_of",
    "on_cpu", "rows", "flags", "field_words",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry points: (name, argtypes). Pointer arrays and integer arrays are
# host buffers read by the C side before it launches.
_P = ctypes.c_void_p
_ENTRIES = {
    "msm_montmul": [_P, _P, ctypes.c_int64, _P, _P],
    "msm_glv_digits": [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P, _P],
    "msm_aff_pair_add": [_P, _P, ctypes.c_int64, _P, _P],
    "msm_proj_add": [_P, _P, ctypes.c_int64, _P, _P],
    "msm_proj_double_k": [_P, _P, ctypes.c_int64, ctypes.c_int, _P, _P],
    "msm_field_const_words": [],
    "msm_glv_const_words": [],
}


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the cached library was reused
    log: str  # nvcc output, including the ptxas -v register/spill lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build() -> BuildInfo:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    lib = BUILD_DIR / f"libmsm_kernels_{tag}.so"
    log = BUILD_DIR / f"libmsm_kernels_{tag}.log"
    if lib.exists():
        return BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return BuildInfo(lib, seconds, out)


@functools.cache
def library() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (or reuse) and load the kernel library; argtypes declared."""
    info = _build()
    lib = ctypes.CDLL(str(info.path))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, info


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def ptrs(*tensors) -> ctypes.Array:
    """Host array of device pointers (uint64) for a C entry point."""
    return (ctypes.c_uint64 * len(tensors))(*(t.data_ptr() for t in tensors))


def ints(values, ctype=ctypes.c_int64) -> ctypes.Array:
    return (ctype * len(values))(*(int(v) for v in values))


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


# ---- wrapper-side checks shared by the kernel modules ----------------------


def on_cpu(*tensors) -> bool:
    """Device dispatch: True when every tensor lies on the CPU (plain twin),
    False when all lie on one CUDA device (kernel); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def rows(t, n: int, W: int, name: str) -> int:
    """Validate a CUDA field operand: int32 (n, W) with unit lane stride.
    Returns its row stride (elements between limbs)."""
    import torch

    if t.dtype != torch.int32 or t.dim() != 2 or tuple(t.shape) != (n, W):
        raise ValueError(f"{name}: expected int32 ({n}, {W}), got {t.dtype} {tuple(t.shape)}")
    if W > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: lanes must be contiguous (stride {t.stride()})")
    if n > 1 and t.stride(0) < W:
        raise ValueError(f"{name}: limb rows overlap (stride {t.stride()})")
    return t.stride(0)


def flags(t, W: int, name: str) -> None:
    """Validate a per-lane int32 flag vector (W,)."""
    import torch

    if t.dtype != torch.int32 or tuple(t.shape) != (W,) or (W > 1 and t.stride(0) != 1):
        raise ValueError(f"{name}: expected contiguous int32 ({W},), got {t.dtype} {tuple(t.shape)}")


@functools.cache
def field_words(F, b3_mont: int = 0, b3_small: int = 0) -> ctypes.Array:
    """FieldConsts words (csrc/field.cuh) for a MontgomeryFp, packed once
    per field and curve constant and read only by the host. The kernels
    compute with twelve 32-bit words, which is R = 2^384: the same R as the
    limb code only for w = 12, n = 32 (BLS12-377's base field)."""
    if (F.w, F.n) != (12, 32):
        raise ValueError(
            f"CUDA field kernels need R = 2^384 (w = 12, n = 32); this field has "
            f"w = {F.w}, n = {F.n}"
        )
    words = []
    for v in (F.p, 2 * F.p, F.mont_one, b3_mont):
        words += [(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
    words += [(-pow(F.p, -1, 1 << 32)) % (1 << 32), b3_small]
    lib, _ = library()
    if len(words) != lib.msm_field_const_words():
        raise RuntimeError("FieldConsts layout mismatch between Python and csrc/field.cuh")
    return ints(words, ctypes.c_uint32)
