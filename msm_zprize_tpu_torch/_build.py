"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and one more ``nvcc`` links the objects into ONE shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). The library lands in ``build/`` at the repository root under a
name derived from a hash of the sources and flags, so a rebuilt checkout
reuses it and an edited source builds anew. Each C entry point launches on
the stream it is given, never synchronises, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.

A field outside the four shapes of that library (``FIELD_SHAPES``) gets a
shape made on demand (``csrc/field.cuh``'s DynShape): ``field_shape``
derives its ID from (n, p), and ``library(shape)`` builds, at first use, a
library of that shape alone (K1, K8 and K13 from ``montmul.cu``, the curve
kernels on limbs and on the shape's codec rows from ``curve.cu``,
``curve_codec.cu`` and ``curve_pallas_codec.cu``, the Edwards kernels from
``edwards.cu``), cached by the same hash and the shape. A GLV scalar module
of other sizes than the main library's K2 takes (``GLV_MAIN_DIMS``) gets
``scalar_library(dims)`` the same way (K2 from ``glv_digits.cu``). Neither
ever rebuilds the main library, and a failed build raises.

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
    "on_cpu", "rows", "flags", "field_shape", "shape_layout", "shape_rows", "field_words",
    "codec_arg", "scalar_library", "GLV_MAIN_DIMS", "MAX_LIMBS",
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
    "msm_exp_probe": [_P, _P, _W, _I, _P, _P, _P],
    "msm_glv_digits": [_P, _P, _W, _I, _I, _P, _P],
    "msm_simple_digits": [_P, _P, _W, _I, _I, _I, _P],
    # K3-K7 and K14: (ptrs, lds, width, shape, kernel, codec, arg, group, consts, stream)
    "msm_curve": [_P, _P, _W, _I, _I, _I, _I, _I, _P, _P],
    "msm_curve_group": [_I, _I, _I, _W, _I],
    "msm_curve_groups": [_I, _I, _I, _I, _P, _I],
    "msm_ed_pair_add": [_P, _P, _W, _I, _I, _P, _P],
    "msm_ed_pair_add_group": [_I, _W],
    "msm_ed_pair_add_groups": [_I, _P, _I],
    "msm_ed_add": [_P, _P, _W, _I, _I, _P, _P],
    "msm_ed_double_k": [_P, _P, _W, _I, _I, _P, _P],
    "msm_field_const_words": [_I],
    "msm_codec_rows": [_I, _I],
    "msm_exp_layout": [_I, _P],
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
# Shapes made on demand (csrc/field.cuh::DynShape): ID = DYN_ID_BASE + ROW_ID
# ROWS + 32 n + NW, with NW the fewest words with 8p < 2^(32 NW) and at least
# the 12 n div 32 full reduction rounds, and ROWS the rows of p's PackedCodec
# (the codec kernels' row count, a compile-time size of the shape's library),
# for every limb count the limb code takes (n = 1..63: MontgomeryFp's
# 2 n 2^24 < 2^31). Every kernel on field values takes all of them.
DYN_ID_BASE = 1024
ROW_ID = 2048  # above 32 n + NW for every n <= 63
MAX_LIMBS = 63
# (n, n_half, n_acc, K0 limbs, limbs of m_i, words of s) of the GlvScalar
# modules the main library's K2 is built for (BLS12-377's, BLS12-381's and
# Pallas's; csrc/glv_digits.cu); any other w = 12 module takes
# scalar_library(its dims).
GLV_MAIN_DIMS = (22, 11, 13, 23, 13, 8)


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


def _digest(defines=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for path in sorted(CSRC.glob("*.cu*")):  # the kernels and their headers
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


def _build(name: str = "kernels", sources=None, defines=()) -> BuildInfo:
    """Build (or reuse) ``build/libmsm_<name>_<hash>.so`` from ``sources``
    (default: every csrc/*.cu), each compiled with ``defines``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest(defines)
    lib = BUILD_DIR / f"libmsm_{name}_{tag}.so"
    log = BUILD_DIR / f"libmsm_{name}_{tag}.log"
    if lib.exists():
        return BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
    sources = _sources() if sources is None else [CSRC / src for src in sources]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    out = _run_all([[_nvcc(), *NVCC_FLAGS, *defines, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(sources, objs)])
    out += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    log.write_text(out)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return BuildInfo(lib, seconds, out)


def _load(info: BuildInfo) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(info.path))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name, None)  # a library of a shape made on demand has fewer
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library_of(shape: int) -> tuple[ctypes.CDLL, BuildInfo]:
    if shape < DYN_ID_BASE:
        return _load(info := _build()), info
    n, nw, _ = shape_layout(shape)
    rows = shape_rows(shape)
    defines = ("-DMSM_DYN_SHAPE", f"-DMSM_DYN_ID={shape}", f"-DMSM_DYN_NL={n}",
               f"-DMSM_DYN_NW={nw}", f"-DMSM_DYN_TAIL={12 * n % 32}", f"-DMSM_DYN_ROWS={rows}")
    sources = ["montmul.cu", "curve.cu", "curve_codec.cu", "curve_pallas_codec.cu", "edwards.cu"]
    info = _build(f"shape{n}x{nw}r{rows}", sources, defines)
    return _load(info), info


def library(shape: int | None = None) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (or reuse) and load the kernel library of field shape ``shape``
    (an ID of ``field_shape``; None or a shape of FIELD_SHAPES: the main
    library, which also holds the scalar kernels), argtypes declared."""
    return _library_of(shape if shape is not None and shape >= DYN_ID_BASE else 1)


@functools.cache
def scalar_library(dims: tuple) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (or reuse) and load K2's library for a GlvScalar module of the
    sizes ``dims`` (as GLV_MAIN_DIMS lists them, for a module the main
    library's K2 does not take): csrc/glv_digits.cu with each size a macro
    of its own (nvcc splits one -D at its commas), into
    build/libmsm_scalar<sizes>_<hash>.so."""
    names = ("NS", "NH", "NACC", "K0L", "NM", "SW")
    defines = ("-DMSM_DYN_SCALAR",) + tuple(f"-DMSM_DYN_{k}={v}" for k, v in zip(names, dims))
    info = _build("scalar" + "x".join(map(str, dims)), ["glv_digits.cu"], defines)
    return _load(info), info


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
    """Whether p fits a main-library shape of nw words, by p's top word as
    csrc/field.cuh::fits reads it: 4p < 2^(32 nw), or (carry) 2p < 2^(32 nw)
    <= 4p, each with the margin that keeps the CIOS accumulator a 2^32 + p
    within nw + 1 words (top below 0x3FFFFFFF, or below 0x7FFFFFFF)."""
    top = p >> (32 * (nw - 1))
    return 0x40000000 <= top < 0x7FFFFFFF if carry else top < 0x3FFFFFFF


def _shape_name(sid: int) -> str:
    n, nw, carry = FIELD_SHAPES[sid]
    bound = f"2p < 2^{32 * nw} <= 4p" if carry else f"4p < 2^{32 * nw}"
    return f"n = {n} (R = 2^{12 * n}, {bound})"


def shape_layout(sid: int) -> tuple[int, int, bool]:
    """(limbs n, register words NW, carry) of a field shape's ID."""
    if sid in FIELD_SHAPES:
        return FIELD_SHAPES[sid]
    n, nw = divmod((sid - DYN_ID_BASE) % ROW_ID, 32)
    if sid < DYN_ID_BASE + ROW_ID or not 1 <= n <= MAX_LIMBS:
        raise ValueError(f"no field shape has the ID {sid}")
    return n, nw, False


def shape_rows(sid: int) -> int:
    """The PackedCodec rows that the codec kernels of a shape made on demand
    take (ceil((bits(p) + 1) / 31) of its fields)."""
    shape_layout(sid)
    if sid in FIELD_SHAPES:
        raise ValueError(f"the main library's shape {sid} has the codec table of csrc/codec.cuh")
    return (sid - DYN_ID_BASE) // ROW_ID


@functools.cache
def field_shape(F) -> int:
    """The ID of the kernels' field shape for a MontgomeryFp (csrc/field.cuh):
    one of FIELD_SHAPES, derived from its limb layout and p, or else the ID
    of a shape made on demand for its n and p (n = 1..63, w = 12). Fields
    outside that domain are refused."""
    for sid, (n, nw, carry) in FIELD_SHAPES.items():
        if F.w == 12 and F.n == n and _fits(F.p, nw, carry):
            return sid
    if F.w != 12 or not 1 <= F.n <= MAX_LIMBS or F.R <= 32 * F.p:
        raise ValueError(
            f"CUDA field kernels take w = 12 limbs, n = 1..{MAX_LIMBS}, R > 32p; this field has "
            f"w = {F.w}, n = {F.n}, a {F.p.bit_length()}-bit p"
        )
    nw = max((12 * F.n) // 32, -(-(F.p.bit_length() + 3) // 32))  # 8p < 2^(32 NW)
    rows = -(-(F.p.bit_length() + 1) // 31)  # PackedCodec(p).rows
    return DYN_ID_BASE + ROW_ID * rows + 32 * F.n + nw


@functools.cache
def field_words(F, curve_mont: tuple[int, int] = (0, 0), small: int = 0) -> ctypes.Array:
    """FieldConsts words (csrc/field.cuh) for a MontgomeryFp, packed once per
    field and curve constants and read only by the host: p, 2p, R mod p, the
    two Montgomery-form curve constants, -p^-1 mod 2^32 and one plain-integer
    curve constant (0 on a shape made on demand: the curve kernels then take
    the first Montgomery-form constant by a product). The kernels compute
    with the limb code's own R = 2^(12 n) on every field shape."""
    sid = field_shape(F)
    nw = shape_layout(sid)[1]
    words = []
    for v in (F.p, 2 * F.p, F.mont_one, *curve_mont):
        words += [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]
    words += [(-pow(F.p, -1, 1 << 32)) % (1 << 32), small]
    lib, _ = library(sid)
    if len(words) != lib.msm_field_const_words(sid):
        raise RuntimeError("FieldConsts layout mismatch between Python and csrc/field.cuh")
    return ints(words, ctypes.c_uint32)


@functools.cache
def codec_arg(F, codec) -> int:
    """The codec id the C entry points take for ``codec`` on the field F,
    once its row count is checked against the rows of the kernels' codec
    table (``csrc/codec.cuh``, read through ``msm_codec_rows``: the main
    library's entries, and a shape made on demand's own, PackedCodec on any
    p and Fma51Codec where p < 2^255 - 2^206); other pairs are refused with
    the table's entries."""
    from .fields.codec import CODEC_IDS, codec_id

    cid = codec_id(codec)
    sid = field_shape(F)
    lib, _ = library(sid)
    if lib.msm_codec_rows(sid, cid) != codec.rows:
        main, _ = library()
        built = [f"{name} ({main.msm_codec_rows(s, i)} rows) on {_shape_name(s)}"
                 for s in FIELD_SHAPES for name, i in CODEC_IDS.items()
                 if main.msm_codec_rows(s, i) > 0]
        if sid >= DYN_ID_BASE:
            built += [f"{name} ({lib.msm_codec_rows(sid, i)} rows) on this field's shape made on "
                      f"demand (n = {F.n})" for name, i in CODEC_IDS.items()
                      if lib.msm_codec_rows(sid, i) > 0]
        raise ValueError(
            f"no CUDA kernel for {type(codec).__name__} ({codec.rows} rows) on a field of "
            f"w = {F.w}, n = {F.n}: the kernels take {'; '.join(built)}"
        )
    return cid
