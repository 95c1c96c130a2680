"""The main library against another tree's: K1, K3 and K4 on BLS12-377 and
K10 on ed-on-bls12-377 at their 2^16 MSM shapes, timed on the card, and the
SASS of two built libraries compared kernel by kernel.

    python3 -m msm_zprize_tpu_torch.testing.main_turns          (from a tree's root)
    python3 -m msm_zprize_tpu_torch.testing.main_turns --sass A.so B.so

The first form builds (or reuses) the tree's main library and times, through
the wrappers every tree since PR 13 has, K1 at (32, 65,536), K3 at 901,120
lanes (its code flushed from the L2 before each call, as in the MSM), K4
at 450,560 lanes and K10 at the padded MSM's 942,080 and 32,768 lanes (cold,
as K3: both follow the slot gather): the card's own time, CUDA-graph replay,
two readings each.
It prints one JSON line with the times, the library's path and the card's
name and power limit, so one command can run a parent's tree and this one in
turns (copy this file into the parent's tree). The second form prints, for
two libraries, how many kernels each has and which differ in SASS
(``cuobjdump -sass``, instruction addresses stripped); it exits non-zero if
any kernel differs or is missing from one of them. Needs a CUDA device and
the toolkit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from .. import _build


def sass(lib: str) -> dict:
    """Each kernel's SASS instructions in a library, by mangled name
    (``cuobjdump -sass`` of the toolkit beside ``nvcc``), addresses and
    encodings stripped."""
    tool = Path(_build._nvcc()).resolve().parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True, check=True,
                         timeout=600).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            kernels[name].append(re.sub(r"/\*[0-9a-fx]+\*/", "", line).strip())
    return kernels


def sass_diff(a: str, b: str) -> int:
    ka, kb = sass(a), sass(b)
    differ = sorted(k for k in set(ka) & set(kb) if ka[k] != kb[k])
    only = sorted(set(ka) ^ set(kb))
    print(f"SASS: {len(ka)} kernels in {Path(a).name}, {len(kb)} in {Path(b).name}; "
          f"{len(set(ka) & set(kb)) - len(differ)} identical, {len(differ)} differ, "
          f"{len(only)} in one library only")
    for k in differ + only:
        print(f"    differs or missing: {k}")
    return 1 if differ or only else 0


def turns() -> None:
    import torch

    from chip_smoke import _cold_ms, _graph_ms, _smi  # the tree's root is on the path under -m

    from ..curves import cuda_curve, cuda_edwards
    from ..curves.params import BLS12_377, ED_ON_BLS12_377
    from ..fields import cuda_mul
    from ..parallel.api import TwistedEdwards, Weierstrass

    if not torch.cuda.is_available():
        raise SystemExit("main_turns: needs a CUDA device")
    dev = torch.device("cuda", 0)
    W = Weierstrass.create(BLS12_377).ops
    E = TwistedEdwards.create(ED_ON_BLS12_377).ops
    F = W.F
    rng = np.random.default_rng(2026)

    def elems(width, G=F):
        limbs = rng.integers(0, 1 << 12, size=(G.n, width), dtype=np.int32)
        limbs[-1] &= (1 << (G.p.bit_length() - 1 - 12 * (G.n - 1))) - 1  # below p
        return torch.as_tensor(limbs, device=dev)

    def bits(width):
        return torch.as_tensor(rng.integers(0, 2, size=width, dtype=np.int32), device=dev)

    x, y = elems(1 << 16), elems(1 << 16)
    k3 = [elems(901_120), elems(901_120), bits(901_120), bits(901_120),
          elems(901_120), elems(901_120), bits(901_120), bits(901_120)]
    k4 = [elems(450_560) for _ in range(6)]
    k10 = {w: [elems(w, E.F), elems(w, E.F), bits(w), bits(w), elems(w, E.F), elems(w, E.F), bits(w),
               bits(w)] for w in (942_080, 32_768)}
    res = {"card": _smi("name,power.limit"), "library": str(_build.library()[1].path)}
    for _ in range(2):
        res.setdefault("k1_32x65536", []).append(_graph_ms(torch, lambda: cuda_mul.montmul(F, x, y)))
        res.setdefault("k3_901120", []).append(
            _cold_ms(torch, lambda: cuda_curve.aff_pair_add(W, *k3), k3))
        res.setdefault("k4_450560", []).append(_graph_ms(torch, lambda: cuda_curve.proj_add(W, *k4)))
        for w, a in k10.items():
            res.setdefault(f"k10_{w}", []).append(
                _cold_ms(torch, lambda a=a: cuda_edwards.ed_pair_add(E, *a), a))
    print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--sass"]:
        return sass_diff(argv[1], argv[2])
    turns()
    return 0


if __name__ == "__main__":
    sys.exit(main())
