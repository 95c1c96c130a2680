"""Entry points for a harness: a one-card MSM step and a multi-rank dry run.

Port twin of the repository's ``__graft_entry__.py``:

* ``entry(device)`` returns ``(fn, example_args)``: one BLS12-377 GLV MSM
  (``msm_batched_affine``) at N = 16, c = 6, inputs on ``device``;
* ``dryrun_multichip(n)`` starts n ranks (``parallel.launch.spawn``) and
  runs the whole sharded MSM on ``make_mesh(n)``, then on both 2-D
  orientations (2, n/2) and (n/2, 2) where n >= 4 is even, each rank's
  result held against the port's host oracle (``testing/points.py``).

    python -m msm_zprize_tpu_torch.graft_entry [N_RANKS] [--device cpu|cuda] [--backend gloo]

On the card each rank takes a card of its own (NCCL) unless ``--backend
gloo`` puts them all on one.
"""

from __future__ import annotations

import argparse
import random

from .bigint.weierstrass import AffineCurve
from .curves.params import BLS12_377
from .curves.weierstrass import AffinePoints, ProjectivePoints
from .msm.batched_affine import msm_batched_affine
from .parallel import launch
from .parallel.api import DEVICE, Weierstrass
from .parallel.mesh import make_mesh, make_mesh2
from .testing.points import naive_msm

__all__ = ["entry", "entry_inputs", "dryrun_multichip"]

C = 6


def entry_inputs(N: int = 16, seed: int = 0):
    """(int scalars, affine int points): N random subgroup points and
    scalars below q, from ``random.Random(seed)``."""
    rng = random.Random(seed)
    A = AffineCurve(BLS12_377)
    pts = [A.random(rng) for _ in range(N)]
    return [rng.randrange(BLS12_377.order) for _ in range(N)], pts


def entry(device=DEVICE):
    """(fn, example_args): fn(scalars, x, y, inf) -> (X, Y, Z), the MSM of
    ``entry_inputs()`` as one projective point."""
    curve = Weierstrass.create(BLS12_377)
    scs, pts = entry_inputs()
    points = curve.points_from_ints(pts, device)

    def fn(s, px, py, pinf):
        res = msm_batched_affine(curve.ops, curve.scalar, s, AffinePoints(px, py, pinf), c=C)
        return res.X, res.Y, res.Z

    return fn, (curve.scalars_from_ints(scs, device), points.x, points.y, points.inf)


def _mesh_shapes(n: int) -> list[tuple]:
    shapes = [(n,)]
    if n >= 4 and n % 2 == 0:
        shapes += list(dict.fromkeys([(2, n // 2), (n // 2, 2)]))
    return shapes


def _dryrun_rank(rank, world, device, scs, pts):
    curve = Weierstrass.create(BLS12_377)
    s, p = curve.scalars_from_ints(scs, device), curve.points_from_ints(pts, device)
    out = {}
    for shape in _mesh_shapes(world):
        mesh = make_mesh(world, device.type) if len(shape) == 1 else make_mesh2(*shape, device.type)
        out[shape] = curve.result_to_int(curve.msm(s, p, c=C, mesh=mesh))
    return out


def dryrun_multichip(n_devices: int, device=DEVICE, backend: str | None = None) -> None:
    """The sharded MSM on ``n_devices`` ranks at N = 2 n_devices, on every
    mesh shape of ``_mesh_shapes``; raises if any rank's result differs
    from the host oracle."""
    scs, pts = entry_inputs(2 * n_devices, seed=1)
    want = naive_msm(BLS12_377, scs, pts)
    results = launch.spawn(_dryrun_rank, n_devices, device=device, backend=backend,
                           args=(scs, pts))
    for rank, res in enumerate(results):
        bad = [shape for shape, got in res.items() if got != want]
        if bad:
            raise AssertionError(f"dryrun_multichip({n_devices}): rank {rank} disagrees with the "
                                 f"host oracle on the meshes {bad}")
    for shape in results[0]:
        print(f"dryrun_multichip({n_devices}) mesh {shape}: every rank equals the host oracle")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", nargs="?", type=int, default=1)
    ap.add_argument("--device", default=DEVICE)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    fn, args = entry(a.device)
    res = fn(*args)
    scs, pts = entry_inputs()
    if Weierstrass.create(BLS12_377).result_to_int(ProjectivePoints(*res)) != naive_msm(
            BLS12_377, scs, pts):
        raise AssertionError("entry(): the MSM disagrees with the host oracle")
    print("entry(): OK")
    dryrun_multichip(a.n_ranks, a.device, a.backend)


if __name__ == "__main__":
    main()
