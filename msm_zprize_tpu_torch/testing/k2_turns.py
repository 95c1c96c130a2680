"""K2's card time on each Weierstrass curve at the 2^16 MSM's shape (c = 12)
and the 2^20 one's (c = 13), by CUDA-graph replay, through the one call
every version of the wrapper takes, ``glv_digits(S, scalars, c, K)``, so
that one command can time an older tree and this one in turns:

    python3 -m msm_zprize_tpu_torch.testing.k2_turns    (from a tree's root)

Where the wrapper takes the infinity mask (``inf=``), it is passed, all
zeros, as ``glv_prep`` passes it. Prints one line per curve and width, with
the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import inspect
import subprocess

import torch

from ..curves.params import WEIERSTRASS_CURVES
from ..fields import cuda_scalar
from ..msm.common import default_windows
from ..parallel.api import Weierstrass


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_turns: needs a CUDA device")
    from chip_smoke import _graph_ms  # the tree's root is on the path under -m

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    masked = "inf" in inspect.signature(cuda_scalar.glv_digits).parameters
    dev = torch.device("cuda", 0)
    for label, params in WEIERSTRASS_CURVES.items():
        cv = Weierstrass.create(params)
        S = cv.scalar
        for log_n, c in ((16, 12), (20, 13)):
            N, K = 1 << log_n, default_windows(S.max_bits, c)
            s = cv.random_scalars(N, seed=2026, device=dev)
            kw = {"inf": torch.zeros(2 * N, dtype=torch.int32, device=dev)} if masked else {}
            ms = [_graph_ms(torch, lambda: cuda_scalar.glv_digits(S, s, c, K, **kw)) for _ in range(2)]
            print(f"K2 {label} N=2^{log_n} c={c} K={K}{' masked' if masked else ''}: "
                  f"{ms[0]:.4f}, {ms[1]:.4f} ms ({card})", flush=True)


if __name__ == "__main__":
    main()
