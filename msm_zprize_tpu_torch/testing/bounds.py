"""The least time the card could take for a kernel's work: the larger of its
bytes over the memory rate and its 32-bit multiply-adds over the card's
integer rate. Shared by ``chip_smoke.py`` (each kernel at its shapes) and
``profile_msm`` (the curve kernels of one MSM, launch by launch).

Rates (NVIDIA H100 SXM): device memory 3.35 TB/s (data sheet); 32-bit
integer multiply-adds, 64 results per clock per SM on compute capability
9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput), times
the SM count and the card's maximum SM clock, both read on the card.
"""

from __future__ import annotations

import subprocess

__all__ = ["HBM_BYTES_PER_S", "imad_per_s", "mont_imads", "bound_ms", "curve_work"]

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64


def imad_per_s(torch) -> float:
    """The card's 32-bit multiply-add rate: SMs x max SM clock x 64."""
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # "1980 MHz"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return IMAD_PER_CLOCK_PER_SM * sms * float(clock.split()[0]) * 1e6


def mont_imads(nw: int, tail: bool) -> int:
    """32-bit multiply-adds of one CIOS product over nw words: nw^2 products
    a_j b_i and nw^2 products m p_j, each 32x32->64 counted as two (low and
    high half), nw quotient digits m; the tail round one more row of m p_j
    and its digit. Additions, carries and selects are not counted, so a
    bound built on this is a lower bound."""
    return 4 * nw * nw + nw + (2 * nw + 1 if tail else 0)


def bound_ms(nbytes: float, imads: float, rate: float) -> tuple[float, str]:
    """(the bound in ms, "bytes" or "operations", whichever sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def curve_work(kernel: str, rows: int, mm: int, width: int, arg: int = 0,
               computing: int | None = None) -> tuple[int, int]:
    """(bytes, multiply-adds) of one launch of curve kernel ``kernel``
    (``cuda_curve``'s key, codec prefix allowed) over ``width`` lanes of
    ``rows`` int32 rows a coordinate, with ``mm`` multiply-adds a product:
    every input read once, every output written once; K5's ``arg`` is k;
    K4m and K7 compute on ``computing`` lanes (default: all)."""
    lanes = width if computing is None else computing
    name = kernel.removeprefix("k14_").removeprefix("fma51_").split("_")[0]
    table = {  # (rows read and written, flag words, products) per lane
        "k3": (7 * rows, 4, 9), "k4": (9 * rows, 0, 12), "k4m": (9 * rows, 1, 12),
        "k5": (6 * rows, 0, 8 * max(arg, 1)), "k6": (6 * rows, 0, 8), "k7": (8 * rows, 1, 11),
    }
    words, flags, products = table[name]
    return (words + flags) * 4 * width, products * mm * lanes
