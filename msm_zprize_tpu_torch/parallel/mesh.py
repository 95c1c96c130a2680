"""Multi-GPU MSM: one process a rank over a ``torch.distributed`` device mesh.

Mirror of ``msm_zprize_tpu/parallel/mesh.py``. Every rank passes the same
global (padded) scalars and points; rank r of the mesh (row-major, ``dcn``
major) takes the r-th contiguous block of N / d and runs the one-card
accumulation on it. Then the bucket partials are combined across ranks,
innermost mesh axis first:

1. ``all_to_all_single`` over the WINDOW axis: rank j of an axis of size d
   receives every rank's partials for the j-th block of windows (a
   reduce-scatter in bucket space: each leaf sent once, as one contiguous
   tensor);
2. a log-tree of the curve's own adds over the d source blocks (K4 or K11
   on the card), then the next axis on the 1/d slice;
3. the weighted bucket reduction over this rank's window slice only, an
   ``all_gather`` of the per-window sums (a few KB), reassembled in the
   order the combine split them (the inner axis major), and Horner.

The window axis is padded to a multiple of the mesh size with identity
windows, which flow through the reduction and Horner harmlessly. Every
rank returns the same result (the JAX package returns it on device 0), so
each process of the multi-controller API holds it.

Transport follows the process group's backend: NCCL exchanges device
tensors, gloo host tensors or CUDA tensors as given. Each exchange adds
its bytes and host-clock milliseconds (synchronised around it) to
``counters.COUNTS`` (``exchange_bytes``, ``exchange_ms``; the final gather
under ``gather_bytes``, ``gather_ms``).
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from ..counters import COUNTS
from ..curves.edwards import EdwardsOps, ExtPoints
from ..curves.weierstrass import AffinePoints, ProjectivePoints, WeierstrassOps
from ..fields.scalar import GlvScalar
from ..msm import engine
from ..msm.basic import EDWARDS_MODES, _EdAcc, accumulate_edwards, accumulate_edwards_padded
from ..msm.batched_affine import (
    MODES, _ProjAcc, accumulate_batched_affine, accumulate_glv_projective,
)
from ..msm.common import window_size

__all__ = ["make_mesh", "make_mesh2", "msm_batched_affine_sharded", "msm_edwards_sharded"]

AXIS = "dp"
AXIS_DCN = "dcn"
AXIS_ICI = "ici"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise torch.distributed (or run the ranks "
                           "through parallel.launch.spawn) before making a mesh")
    return dist.get_world_size()


def _mesh(device, shape, names):
    world = _world()
    if math.prod(shape) > world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, device="cuda"):
    """1-D ``("dp",)`` mesh over the first ``n_devices`` ranks of the
    default process group (all of them by default). ``device``: the ranks'
    device type, the card unless the caller asks for "cpu"."""
    return _mesh(device, (n_devices or _world(),), (AXIS,))


def make_mesh2(dcn: int, ici: int, device="cuda"):
    """2-D (hosts x cards-per-host) mesh, ranks row-major: the outer ``dcn``
    axis maps to the slow network between hosts, the inner ``ici`` axis to
    the cards of one host. The combine runs a full-volume exchange over
    ``ici`` first, then a 1/ici-volume one over ``dcn``."""
    return _mesh(device, (dcn, ici), (AXIS_DCN, AXIS_ICI))


def _position(mesh) -> int:
    """This rank's index in the mesh, row-major (the block of points it
    takes); ranks outside the mesh are refused."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    pos = 0
    for size, i in zip(mesh.shape, coord):
        pos = pos * size + i
    return pos


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _pad_windows(leaves, Kp: int, identity_like):
    """Pad the window axis (axis -2 of (.., K, L) leaves) to Kp with
    identity points. identity_like(k, L) -> identity leaves (.., k, L)."""
    K, L = leaves[0].shape[-2:]
    if Kp == K:
        return leaves
    pad = identity_like(Kp - K, L)
    return tuple(torch.cat([a, z], dim=-2) for a, z in zip(leaves, pad))


def _redistribute_windows(leaves, d: int, group):
    """all_to_all bucket partials over the window axis: (.., Kp, L) per rank
    -> (.., Kp/d, d, L), where the new axis indexes the SOURCE ranks'
    partials of this rank's window slice (within ``group``)."""
    out = []
    for a in leaves:
        lead, (Kp, L) = a.shape[:-2], a.shape[-2:]
        # block j of the window axis goes to rank j of the group
        send = a.reshape(-1, d, Kp // d, L).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        _sync(send)
        t0 = time.perf_counter()
        dist.all_to_all_single(recv, send, group=group)
        _sync(recv)
        COUNTS["exchange_ms"] += (time.perf_counter() - t0) * 1e3
        COUNTS["exchange_bytes"] += send.numel() * send.element_size()
        # (source, rows, Kp/d, L) -> (rows.., Kp/d, source, L)
        out.append(recv.permute(1, 2, 0, 3).reshape(lead + (Kp // d, d, L)))
    return tuple(out)


def _tree_add_sources(add_fn, pt_type, leaves):
    """Log-tree combine over the source-rank axis (axis -2 of each leaf)."""
    cur = pt_type(*leaves)
    dd = cur[0].shape[-2]
    while dd > 1:
        half = dd // 2
        left = pt_type(*(a[..., :half, :] for a in cur))
        right = pt_type(*(a[..., half : 2 * half, :] for a in cur))
        merged = add_fn(left, right)
        if dd % 2:  # the odd last source folds into the first
            odd = pt_type(*(a[..., -1:, :] for a in cur))
            first = add_fn(pt_type(*(a[..., :1, :] for a in merged)), odd)
            merged = pt_type(*(torch.cat([f, m[..., 1:, :]], dim=-2) for f, m in zip(first, merged)))
        cur = merged
        dd = half
    return pt_type(*(a[..., 0, :] for a in cur))


def _hierarchical_combine(leaves, mesh, add_fn, pt_type, identity_like):
    """Reduce-scatter bucket partials (.., K, L) over the window axis,
    innermost mesh axis first: a full-volume exchange and log-tree over
    ``ici``, then the (1/ici)-volume exchange and tree over ``dcn``. For a
    1-D mesh this is the single-tier combine. Returns this rank's fully
    combined (.., Kp / d, L) slice (Kp: K padded to a multiple of the mesh
    size d)."""
    K = leaves[0].shape[-2]
    n = mesh.size()
    leaves = _pad_windows(leaves, -(-K // n) * n, identity_like)
    for name, d in reversed(list(zip(mesh.mesh_dim_names, mesh.shape))):
        if d == 1:
            continue
        leaves = _redistribute_windows(leaves, d, mesh.get_group(name))
        leaves = tuple(_tree_add_sources(add_fn, pt_type, leaves))
    return pt_type(*leaves)


def _gather_windows(per_window, mesh):
    """All ranks' per-window sums (leaves (rows.., Kp / d)) -> the whole
    window axis (rows.., Kp) on every rank. The combine split the window
    axis innermost mesh axis first, so rank (i, j) of a (dcn, ici) mesh
    holds block j * dcn + i: gathering outermost axis first, each gather
    concatenated in its group's rank order, rebuilds the axis in order."""
    cur = torch.stack(tuple(per_window))  # (coords, rows.., Kp / d)
    for name, d in zip(mesh.mesh_dim_names, mesh.shape):
        if d == 1:
            continue
        parts = [torch.empty_like(cur) for _ in range(d)]
        _sync(cur)
        t0 = time.perf_counter()
        dist.all_gather(parts, cur, group=mesh.get_group(name))
        _sync(cur)
        COUNTS["gather_ms"] += (time.perf_counter() - t0) * 1e3
        COUNTS["gather_bytes"] += cur.numel() * cur.element_size()
        cur = torch.cat(parts, dim=-1)
    return type(per_window)(*cur.unbind(0))


def _shard(mesh, N: int):
    d = mesh.size()
    if N % d:
        raise ValueError(f"N = {N} points do not split over a mesh of {d} ranks: pad N to a "
                         "multiple of the mesh size (the curve API's msm does)")
    r = _position(mesh)
    return slice(r * N // d, (r + 1) * N // d)


def msm_batched_affine_sharded(W: WeierstrassOps, S: GlvScalar, mesh, scalars,
                               points: AffinePoints, c: int | None = None, safe: bool = True,
                               mode: str = "affine") -> ProjectivePoints:
    """The GLV MSM over a device mesh; N must divide by the mesh size.

    scalars: (n_scalar, N) and points: an affine batch of N, the same global
    inputs on every rank, on this rank's device. ``mode="projective"``
    accumulates with the padded engine (K3, K4); every other mode, as in the
    JAX package ``"halving"`` too, takes the halving engine with
    batched-affine adds (``safe`` as ``msm_unsafe`` sets it), whose affine
    bucket sums become projective with the canonical identity (0 : 1 : 0)
    on empty or infinite buckets (the complete formulas need curve points).
    Returns one projective point (batch 1), the same on every rank."""
    if mode not in MODES:
        raise ValueError(f"unknown MSM mode {mode!r}; expected one of {MODES}")
    N = points.x.shape[-1]
    sl = _shard(mesh, N)
    if c is None:
        c = window_size("batched-affine", max(N.bit_length() - 1, 1))
    device = points.x.device
    pts = AffinePoints(points.x[:, sl], points.y[:, sl], points.inf[sl])
    if mode == "projective":
        leaves = tuple(accumulate_glv_projective(W, S, scalars[:, sl], pts, c))
    else:
        sums, empty = accumulate_batched_affine(W, S, scalars[:, sl], pts, c, safe)
        F = W.F
        batch = sums.x.shape[1:]
        one, zero = F.ones_mont(*batch, device=device), F.zeros(*batch, device=device)
        is_id = empty | sums.inf.bool()
        leaves = (torch.where(is_id, zero, sums.x), torch.where(is_id, one, sums.y),
                  torch.where(is_id, zero, one))
    acc = _ProjAcc(W, device)
    mine = _hierarchical_combine(leaves, mesh, acc.add, ProjectivePoints,
                                 lambda k, L: W.proj_zeros(k, L, device=device))
    per_window = engine.reduce_buckets_log(mine, max((c - 1) // 2, 1), acc)
    return engine.horner(_gather_windows(per_window, mesh), c, acc.add, acc.double_k)


def msm_edwards_sharded(E: EdwardsOps, mesh, scalars, points: ExtPoints, scalar_bits: int,
                        c: int | None = None, mode: str = "padded") -> ExtPoints:
    """The twisted-Edwards MSM over a device mesh; N must divide by the mesh
    size. ``mode``: "padded" (the default: the padded engine, K10, K11) or
    "basic" (the halving engine, K11), as the one-card ``TwistedEdwards.msm``
    takes it. Returns one extended point (batch 1), the same on every rank."""
    if mode not in EDWARDS_MODES:
        raise ValueError(f"unknown Edwards MSM mode {mode!r}; expected one of {EDWARDS_MODES}")
    N = points.X.shape[-1]
    sl = _shard(mesh, N)
    if c is None:
        c = window_size("edwards", max(N.bit_length() - 1, 1))
    device = points.X.device
    pts = ExtPoints(*(a[:, sl] for a in points))
    accumulate = accumulate_edwards_padded if mode == "padded" else accumulate_edwards
    leaves = tuple(accumulate(E, scalars[:, sl], pts, scalar_bits, c))
    acc = _EdAcc(E, device)
    mine = _hierarchical_combine(leaves, mesh, acc.add, ExtPoints,
                                 lambda k, L: E.zeros(k, L, device=device))
    per_window = engine.reduce_buckets_log(mine, max((c - 1) // 2, 1), acc)
    return engine.horner(_gather_windows(per_window, mesh), c, acc.add, acc.double_k)
