"""Rank bodies of the sharded MSM's checks, for ``parallel.launch.spawn``.

They live in the port, not in a test file, so that the spawned ranks import
nothing of JAX: ``tests/test_torch_mesh.py`` runs ``cpu_1d`` and ``cpu_2d``
on gloo CPU processes and holds what they return against the JAX package's
bigint oracle; ``chip_smoke.py`` (phase 17) and ``tests/test_torch_cuda.py``
run ``card_ranks`` on the card. Each returns plain Python values: affine
int points (None or (0, 1) for the identity), counts and times.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist

from .. import counters
from ..curves import cuda_curve, cuda_edwards
from ..curves.params import BLS12_377, ED_ON_BLS12_377, PALLAS
from ..curves.weierstrass import ProjectivePoints
from ..fields import cuda_mul, cuda_scalar
from ..msm.batched_affine import _ProjAcc
from ..parallel import mesh as mesh_mod
from ..parallel.api import TwistedEdwards, Weierstrass
from ..submission import make_compute_msm

__all__ = ["cpu_1d", "cpu_2d", "card_ranks", "check_card_ranks", "foreign_modules"]

C_SMALL = 6  # the window of the CPU cases (N = 12 or 16)

_GLV_PATH = (cuda_mul.KERNEL, cuda_scalar.KERNEL, cuda_curve.K3, cuda_curve.K4, cuda_curve.K5)
# the first word of a card run's label -> the kernels its path launches (the
# combine's adds among K4's and K11's launches)
CARD_PATHS = {
    "bls12-377": _GLV_PATH,
    "compute_msm": _GLV_PATH,
    "ed-on-bls12-377": (cuda_mul.KERNEL, cuda_mul.K8, cuda_scalar.K9, cuda_edwards.K10,
                        cuda_edwards.K11, cuda_edwards.K12),
}


def foreign_modules() -> list[str]:
    """Modules of JAX or of the JAX package that this process imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "msm_zprize_tpu"))


def _affine(W, pts: ProjectivePoints) -> list:
    """Projective points (n, W) -> affine int tuples, None for the identity."""
    p = W.params.modulus
    return [None if Z % p == 0 else (X * pow(Z, -1, p) % p, Y * pow(Z, -1, p) % p)
            for X, Y, Z in W.ops.unpack_projective(pts)]


def cpu_1d(rank, world, device, inputs):
    """On ``make_mesh()`` of every rank, at c = 6: BLS12-377 ``msm``
    (projective), ``msm_unsafe(mode="affine")`` and ``msm(mode="packed")``;
    ed-on-bls12-377 ``msm`` padded and basic; Pallas ``msm(mode="fma51")``;
    ``make_compute_msm(mesh=...)`` on int inputs. ``inputs``: name -> (int
    scalars, int points) for "bls12-377", "ed-on-bls12-377", "pallas" and
    "compute_msm"."""
    mesh = mesh_mod.make_mesh(device=device.type)
    out = {}
    for name, params, cls, modes in (
        ("bls12-377", BLS12_377, Weierstrass,
         (("projective", "msm"), ("affine", "msm_unsafe"), ("packed", "msm"))),
        ("ed-on-bls12-377", ED_ON_BLS12_377, TwistedEdwards, (("padded", "msm"), ("basic", "msm"))),
        ("pallas", PALLAS, Weierstrass, (("fma51", "msm"),)),
    ):
        curve = cls.create(params)
        scs, pts = inputs[name]
        s, p = curve.scalars_from_ints(scs, device), curve.points_from_ints(pts, device)
        for mode, entry in modes:
            res = getattr(curve, entry)(s, p, c=C_SMALL, mode=mode, mesh=mesh)
            out[f"{name} {entry} {mode}"] = curve.result_to_int(res)
    scs, pts = inputs["compute_msm"]
    out["compute_msm"] = make_compute_msm(BLS12_377, mesh, device)(pts, scs)
    out["foreign"] = foreign_modules()
    return out


def cpu_2d(rank, world, device, inputs):
    """Six ranks: BLS12-377 ``msm`` (projective) on ``make_mesh2(2, 3)`` and
    ``make_mesh2(3, 2)``, ed-on-bls12-377 ``msm`` (padded) on (3, 2), all at
    c = 6; then the hierarchical combine alone on hand-made partials (rank
    r's (window k, bucket l) is ``pool[(r K + k) L + l]``, L = 4) with K = 5
    and 4 windows on the 1-D mesh and both 2-D ones: this rank's combined
    slice as affine ints. ``inputs``: name -> (int scalars, int points) for
    "bls12-377" and "ed-on-bls12-377", and "pool", "L"."""
    meshes = {"1-D": mesh_mod.make_mesh(device=device.type),
              "(2, 3)": mesh_mod.make_mesh2(2, 3, device.type),
              "(3, 2)": mesh_mod.make_mesh2(3, 2, device.type)}
    W, E = Weierstrass.create(BLS12_377), TwistedEdwards.create(ED_ON_BLS12_377)
    out = {}
    scs, pts = inputs["bls12-377"]
    s, p = W.scalars_from_ints(scs, device), W.points_from_ints(pts, device)
    for name in ("(2, 3)", "(3, 2)"):
        out[f"bls12-377 msm {name}"] = W.result_to_int(W.msm(s, p, c=C_SMALL, mesh=meshes[name]))
    scs, pts = inputs["ed-on-bls12-377"]
    s, p = E.scalars_from_ints(scs, device), E.points_from_ints(pts, device)
    out["ed-on-bls12-377 msm (3, 2)"] = E.result_to_int(E.msm(s, p, c=C_SMALL, mesh=meshes["(3, 2)"]))

    pool, L = inputs["pool"], inputs["L"]
    acc = _ProjAcc(W.ops, device)
    for K in (5, 4):
        mine = pool[rank * K * L:(rank + 1) * K * L]
        leaves = W.ops.pack_projective([(x, y, 1) for x, y in mine], device)
        leaves = tuple(a.reshape(a.shape[0], K, L) for a in leaves)
        for name, mesh in meshes.items():
            res = mesh_mod._hierarchical_combine(
                leaves, mesh, acc.add, ProjectivePoints,
                lambda k, L_: W.ops.proj_zeros(k, L_, device=device))
            Kl = res.X.shape[-2]
            out[f"combine K={K} {name}"] = (
                Kl, _affine(W, ProjectivePoints(*(a.reshape(a.shape[0], -1) for a in res))))
    out["foreign"] = foreign_modules()
    return out


def _measured(curve, run, device):
    """One warm run, then one run with the counts set to 0 just before it
    and read just after: its result, wall, counts and (on the card) peak
    device memory."""
    cuda = device.type == "cuda"
    run()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    counters.reset()
    t0 = time.perf_counter()
    res = run()
    if cuda:
        torch.cuda.synchronize(device)
    out = {"ms": (time.perf_counter() - t0) * 1e3, "counts": counters.snapshot(),
           "result": curve.result_to_int(res)}
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def card_ranks(rank, world, device, inputs):
    """The card's mesh runs (they run on CPU ranks too, with no memory
    figure): BLS12-377 ``msm`` (projective) on
    ``make_mesh()``, ``make_mesh2(1, world)`` and ``make_mesh2(world, 1)``,
    ed-on-bls12-377 ``msm`` (padded) on ``make_mesh()``, each measured by
    ``_measured``; then one ``make_compute_msm(mesh=make_mesh())`` call on
    int inputs, timed on the host clock. ``inputs``: "N", "seed" (of the
    scalars, ``random_scalars``), "bls12-377" and "ed-on-bls12-377" (int
    points), "compute_msm" (int scalars, int points)."""
    meshes = {"1-D": mesh_mod.make_mesh(device=device.type),
              f"(1, {world})": mesh_mod.make_mesh2(1, world, device.type),
              f"({world}, 1)": mesh_mod.make_mesh2(world, 1, device.type)}
    W, E = Weierstrass.create(BLS12_377), TwistedEdwards.create(ED_ON_BLS12_377)
    N, seed = inputs["N"], inputs["seed"]
    sw, pw = W.random_scalars(N, seed, device), W.points_from_ints(inputs["bls12-377"], device)
    se, pe = E.random_scalars(N, seed, device), E.points_from_ints(inputs["ed-on-bls12-377"], device)
    out = {}
    for name, mesh in meshes.items():
        out[f"bls12-377 msm {name}"] = _measured(W, lambda m=mesh: W.msm(sw, pw, mesh=m), device)
    out["ed-on-bls12-377 msm 1-D"] = _measured(E, lambda: E.msm(se, pe, mesh=meshes["1-D"]), device)
    scs, pts = inputs["compute_msm"]
    dist.barrier()
    counters.reset()
    t0 = time.perf_counter()
    got = make_compute_msm(BLS12_377, meshes["1-D"], device)(pts, scs)
    out["compute_msm 1-D"] = {"result": got, "ms": (time.perf_counter() - t0) * 1e3,
                              "counts": counters.snapshot()}
    out["foreign"] = foreign_modules()
    return out


def check_card_ranks(results, want: dict) -> None:
    """Raise unless every rank's every run of ``card_ranks`` equals
    ``want[first word of its label]``, launched every kernel of its path in
    its counted run, and the rank imported nothing of JAX."""
    for rank, res in enumerate(results):
        if res["foreign"]:
            raise AssertionError(f"rank {rank} imported {res['foreign']}")
        for label, run in res.items():
            if label == "foreign":
                continue
            curve = label.split()[0]
            if run["result"] != want[curve]:
                raise AssertionError(f"rank {rank}: {label} disagrees with the known-discrete-log result")
            missing = [k for k in CARD_PATHS[curve] if not run["counts"].get(k)]
            if missing:
                raise AssertionError(f"rank {rank}: {label} launched none of {missing}")
