"""Field-operation microbenchmarks (ns/op over a batch): the twin of the JAX
package's ``scripts/field_benchmark.py``.

    python3 -m msm_zprize_tpu_torch.scripts.field_benchmark [curve] [--batch B]
        [--iters I] [--device cuda|cpu]

curve: bls12-377 | bls12-381 | pallas (their base fields). Reports ns/op,
amortized over the batch, of montmul (K1), montsquare, add, sub, reduce,
batch_inverse (K1 and one K8) and sqrt (the batch's first 4,096 lanes at
most: K8 powers and K1 squarings), and the 51x5 engine's montmul
(``fields/fma51.py``, int64 and float64 torch ops) on fields below
2^255 - 2^206. Each op: one untimed call, then the median of I calls,
each timed by a CUDA event pair on the card (the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import random

import torch

from ..bigint.field import random_fields
from ..fields.fp import make_field
from ..fields.sqrt import make_sqrt
from ..utils.phases import timed_ms
from .common import CURVES, WEIERSTRASS, device_of

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("curve", nargs="?", default="bls12-377", choices=list(WEIERSTRASS))
    ap.add_argument("--batch", type=int, default=1 << 18)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    p = CURVES[args.curve].modulus
    F = make_field(p)
    B = args.batch
    rng = random.Random(0)
    reps = max(B // 256, 1)
    xs = torch.as_tensor(F.pack(random_fields(p, 256, rng) * reps), device=device)[:, :B]
    ys = torch.as_tensor(F.pack(random_fields(p, 256, rng) * reps), device=device)[:, :B]
    B = xs.shape[1]
    print(f"[{args.curve}] p ~ 2^{p.bit_length()}, n={F.n} limbs x w={F.w} bits, batch={B}, "
          f"device={device}")
    out = {}

    def report(name, fn, lanes):
        ms, _ = timed_ms(fn, device, args.iters)
        out[name] = ms * 1e6 / lanes
        print(f"{name + ':':16s}{out[name]:10.2f} ns/op   ({lanes / ms / 1e3:10.1f} Mops/s)", flush=True)

    report("montmul", lambda: F.montmul(xs, ys), B)
    report("montsquare", lambda: F.montsquare(xs), B)
    report("add", lambda: F.add(xs, ys), B)
    report("sub", lambda: F.sub(xs, ys), B)
    report("reduce", lambda: F.reduce(xs), B)
    report("batch_inverse", lambda: F.batch_inverse(xs), B)
    S = make_sqrt(p)
    small = xs[:, :4096].contiguous()
    report(f"sqrt (B={small.shape[1]})", lambda: S.sqrt(F.montmul(small, small)), small.shape[1])
    if p < (1 << 255) - (1 << 206):
        from ..fields.fma51 import make_fma51_field

        F51 = make_fma51_field(p)
        xs51 = F51.pack(random_fields(p, 256, rng) * reps, device)[:, :B]
        ys51 = F51.pack(random_fields(p, 256, rng) * reps, device)[:, :B]
        report("montmul 51x5", lambda: F51.montmul(xs51, ys51), B)
    return out


if __name__ == "__main__":
    main()
