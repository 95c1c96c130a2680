"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and one more ``nvcc`` links the objects into ONE shared library
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
    "on_cpu", "rows", "flags", "field_shape", "field_words", "codec_arg",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry points: (name, argtypes). Pointer arrays and integer arrays are
# host buffers read by the C side before it launches.
_P, _I, _W = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ENTRIES = {
    # (ptrs, lds, width, shape, [int arguments], [host words], consts, stream)
    "msm_montmul": [_P, _P, _W, _I, _P, _P],
    "msm_montmul_rows": [_P, _P, _W, _I, _I, _P, _P],
    "msm_exp_const": [_P, _P, _W, _I, _P, _P, _P],
    "msm_glv_digits": [_P, _P, _W, _I, _I, _P, _P],
    "msm_simple_digits": [_P, _P, _W, _I, _I, _I, _P],
    # K3-K7 and K14: (ptrs, lds, width, shape, kernel, codec, arg, group, consts, stream)
    "msm_curve": [_P, _P, _W, _I, _I, _I, _I, _I, _P, _P],
    "msm_curve_group": [_I, _I, _W, _I],
    "msm_curve_groups": [_I, _I, _I, _P, _I],
    "msm_ed_pair_add": [_P, _P, _W, _I, _P, _P],
    "msm_ed_add": [_P, _P, _W, _I, _I, _P, _P],
    "msm_ed_double_k": [_P, _P, _W, _I, _I, _P, _P],
    "msm_field_const_words": [_I],
    "msm_codec_rows": [_I, _I],
    "msm_exp_words": [],
    "msm_glv_const_words": [],
}

# Field shapes the kernels are built for (csrc/field.cuh::ShapeTable): ID ->
# (limb count n, 32-bit register words NW, carry). R = 2^(12 n) = 2^(32 NW +
# tail bits). A shape without carry takes fields with 4p < 2^(32 NW); the
# carry shape those with 2p < 2^(32 NW) <= 4p (Pallas), whose additions and
# loads keep the bit above the top word. n alone does not name a shape
# (ed-on-bls12-377 and Pallas both have n = 22): field_shape derives the ID
# from (n, p), and the C entries take the ID.
FIELD_SHAPES = {1: (32, 12, False), 2: (22, 8, False), 3: (33, 12, False), 4: (22, 8, True)}


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


def _run_all(cmds) -> str:
    """Run the commands at once; their joined output, or an error naming the
    first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=CSRC) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


def _build() -> BuildInfo:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    lib = BUILD_DIR / f"libmsm_kernels_{tag}.so"
    log = BUILD_DIR / f"libmsm_kernels_{tag}.log"
    if lib.exists():
        return BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    t0 = time.perf_counter()
    out = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(_sources(), objs)])
    out += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
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


def _fits(p: int, nw: int, carry: bool) -> bool:
    top = 1 << (32 * nw)
    return 2 * p < top <= 4 * p if carry else 4 * p < top


def _shape_name(sid: int) -> str:
    n, nw, carry = FIELD_SHAPES[sid]
    bound = f"2p < 2^{32 * nw} <= 4p" if carry else f"4p < 2^{32 * nw}"
    return f"n = {n} (R = 2^{12 * n}, {bound})"


@functools.cache
def field_shape(F) -> int:
    """The ID of the kernels' field shape for a MontgomeryFp (csrc/field.cuh),
    derived from its limb layout and p; other fields are refused with the
    shapes that exist."""
    for sid, (n, nw, carry) in FIELD_SHAPES.items():
        if F.w == 12 and F.n == n and _fits(F.p, nw, carry):
            return sid
    raise ValueError(
        "CUDA field kernels take w = 12 limbs in one of the shapes "
        f"{'; '.join(map(_shape_name, FIELD_SHAPES))}; this field has w = {F.w}, n = {F.n}, "
        f"a {F.p.bit_length()}-bit p"
    )


@functools.cache
def field_words(F, curve_mont: tuple[int, int] = (0, 0), small: int = 0) -> ctypes.Array:
    """FieldConsts words (csrc/field.cuh) for a MontgomeryFp, packed once per
    field and curve constants and read only by the host: p, 2p, R mod p, the
    two Montgomery-form curve constants, -p^-1 mod 2^32 and one plain-integer
    curve constant. The kernels compute with the limb code's own R = 2^(12 n)
    for the field shapes in FIELD_SHAPES; other fields are refused."""
    sid = field_shape(F)
    nw = FIELD_SHAPES[sid][1]
    words = []
    for v in (F.p, 2 * F.p, F.mont_one, *curve_mont):
        words += [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]
    words += [(-pow(F.p, -1, 1 << 32)) % (1 << 32), small]
    lib, _ = library()
    if len(words) != lib.msm_field_const_words(sid):
        raise RuntimeError("FieldConsts layout mismatch between Python and csrc/field.cuh")
    return ints(words, ctypes.c_uint32)


@functools.cache
def codec_arg(F, codec) -> int:
    """The codec id the C entry points take for ``codec`` on the field F,
    once its row count is checked against the rows of the kernels' codec
    table (``csrc/codec.cuh``, read through ``msm_codec_rows``); other pairs
    are refused with the table's entries."""
    from .fields.codec import CODEC_IDS, codec_id

    cid = codec_id(codec)
    lib, _ = library()
    if lib.msm_codec_rows(field_shape(F), cid) != codec.rows:
        built = [f"{name} ({lib.msm_codec_rows(sid, i)} rows) on {_shape_name(sid)}"
                 for sid in FIELD_SHAPES for name, i in CODEC_IDS.items()
                 if lib.msm_codec_rows(sid, i) > 0]
        raise ValueError(
            f"no CUDA kernel for {type(codec).__name__} ({codec.rows} rows) on a field of "
            f"w = {F.w}, n = {F.n}: the kernels take {'; '.join(built)}"
        )
    return cid
