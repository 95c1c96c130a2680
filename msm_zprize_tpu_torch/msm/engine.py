"""Pippenger engines: bucket accumulation, bucket reduction, Horner.

Mirror of ``msm_zprize_tpu/msm/engine.py``: the padded-bucket engine
(``slot_count``, ``accumulate_buckets_padded``), the halving engine
(``accumulate_buckets``), both bucket reductions (``reduce_buckets``, the
sequential one fed by affine buckets; ``reduce_buckets_log``) and
``horner``, generic over a point-ops adapter exactly as there, so an
integer model can stand in for curve points in tests. JAX control flow
becomes Python control flow: ``lax.while_loop``/``lax.cond`` read their
conditions on the host (each read is one ``host_sync`` count),
``lax.scan`` is a loop. The constants tuned on the TPU (slot budget 8M,
T = 2048, MR = 32) are kept for parity.

Point leaves are tuples of tensors shaped ``(rows.., batch..)``: curve
coordinates ``(n, W)``, integer models ``(W,)``; the engine only slices
and reshapes the trailing batch axes.
"""

from __future__ import annotations

import math

import torch

from ..counters import COUNTS
from .common import bucket_counts, halving_layout, sort_by_bucket

__all__ = [
    "slot_count",
    "select",
    "accumulate_buckets",
    "accumulate_buckets_padded",
    "reduce_buckets",
    "reduce_buckets_log",
    "horner",
]

I32 = torch.int32

# Slots of one main (sub-)round, and the window-chunk budget: the live
# gather and tree buffers scale with it (8M slots, kept from the TPU tuning).
MAX_SLOTS = 8 << 20


def slot_count(B: int, L: int) -> int:
    """Slots per bucket M of the main round: mean + 2 sqrt(mean) occupancy
    (2x mean below mean 16), a multiple of 4 and even (the fused level-1
    kernel halves the slot axis). Overflow goes to the residual rounds."""
    mean = max(B // L, 1)
    if mean >= 16:
        return (mean + math.ceil(2.0 * math.sqrt(mean)) + 3) & ~3
    return max(2 * mean, 2)


def _host(t: torch.Tensor) -> int:
    """A device value the control flow branches on: one host sync."""
    COUNTS["host_sync"] += 1
    return int(t.item())


def _stack(pts):
    """Concatenate point leaves ((r_i, W) or (W,)) into ONE (R, W) tensor so
    the slot gather moves every coordinate with one index vector."""
    leaves = [a if a.dim() == 2 else a[None] for a in pts]
    splits, off = [], 0
    for a in pts:
        r = a.shape[0] if a.dim() == 2 else 1
        splits.append((off, off + r, a.dim()))
        off += r
    return torch.cat(leaves, dim=0), tuple(splits)


def _unstack(arr, splits):
    """Leaves back from the stacked rows (views, no copies)."""
    return tuple(arr[lo:hi] if ndim == 2 else arr[lo] for lo, hi, ndim in splits)


def _as(pt_type, leaves):
    """Leaves as a point of pt_type (a NamedTuple, or a plain tuple)."""
    return tuple(leaves) if pt_type is tuple else pt_type(*leaves)


def select(mask, a, b):
    """Per-lane select between two point pytrees of one type: a where mask."""
    return _as(type(a), (torch.where(mask, fa, fb) for fa, fb in zip(a, b)))


def accumulate_buckets(points, digits, signs, L: int, pair_add, prepare, zero_like):
    """Accumulate signed points into per-window buckets by pair halving.

    points: point pytree with leaves (.., B), the base points.
    digits, signs: (K, B) int32 magnitudes in [0, L] (0 = skip) and flags.
    pair_add(P0, P1, has_partner, valid) -> points: adds the lanes where
        has_partner, passes P0 through elsewhere.
    prepare(P, flag): conditional negation plus any change of
        representation, applied once after the first gather (so the gather
        moves the narrowest form).
    zero_like(K, L): (K, L)-batched identity points.

    One sort per window orders the points by bucket; each level then pairs
    neighbours within a bucket (``halving_layout``) over all windows at once,
    so each level is one wide pair add. Widths follow the JAX schedule: a
    prefix of exact, shrinking widths, then a plateau at 2L that repeats
    until no bucket holds more than one element (a host check per level,
    bounded by ceil(log2 B) levels in all). Returns (bucket sums with leaves
    (.., K, L), ``empty`` (K, L) bool)."""
    K, B = digits.shape
    device = digits.device
    ids = torch.where(digits == 0, L, digits - 1).to(I32)
    iota = torch.arange(B, dtype=I32, device=device)[None, :].expand(K, B)
    order, sorted_ids = sort_by_bucket(ids, iota)
    counts = bucket_counts(sorted_ids, L)[:, :L]  # (K, L), sentinel dropped
    rows = torch.arange(K, dtype=I32, device=device)[:, None]

    # the first level: every point leaf stacked into one (R, B) tensor, so
    # the reorder is ONE gather; signs are per window (flat index + row)
    stacked, splits = _stack(tuple(points))
    g = stacked.index_select(-1, order.reshape(-1))  # (R, K*B)
    sorted_signs = signs.to(I32).reshape(-1).index_select(0, (order + rows * B).reshape(-1))
    P = prepare(_as(type(points), _unstack(g, splits)), sorted_signs)
    pt_type = type(P)
    P, splits = _stack(tuple(P))  # leaves may have changed shape or count

    def one_level(P, cur_counts, width: int, next_width: int):
        pos0, has_partner, valid, next_counts = halving_layout(cur_counts, next_width, width)
        flat0 = (pos0 + rows * width).reshape(-1)
        flat1 = (torch.clamp(pos0 + 1, max=width - 1) + rows * width).reshape(-1)
        out = pair_add(
            _as(pt_type, _unstack(P.index_select(-1, flat0), splits)),
            _as(pt_type, _unstack(P.index_select(-1, flat1), splits)),
            has_partner.reshape(-1),
            valid.reshape(-1),
        )
        return _stack(tuple(out))[0], next_counts

    # ceil(log2 B) levels bring every count to <= 1 in the worst case (all
    # points in one bucket); the exact-width prefix shrinks geometrically
    # toward plateau_w = 2L, the smallest w with (w + L) // 2 + 1 <= w
    n_levels = max((B - 1).bit_length(), 0)
    plateau_w = 2 * L
    widths = [B]
    need = B
    while True:
        need = (need + L) // 2 + 1
        if need >= widths[-1] or widths[-1] <= plateau_w:
            break
        widths.append(max(need, plateau_w))
    n_prefix = len(widths) - 1

    width, cur_counts = B, counts
    for level in range(n_prefix):
        P, cur_counts = one_level(P, cur_counts, widths[level], widths[level + 1])
        width = widths[level + 1]
    # the plateau exits on data; the static level bound guards it
    it = 0
    while it < n_levels - n_prefix and _host((cur_counts > 1).any()):
        P, cur_counts = one_level(P, cur_counts, width, width)
        it += 1

    # bucket b's sum (count <= 1) sits at its offset
    offsets = torch.cumsum(cur_counts, dim=-1, dtype=I32) - cur_counts
    idx = (torch.clamp(offsets, 0, width - 1) + rows * width).reshape(-1)
    sums = _unstack(P.index_select(-1, idx), splits)
    sums = _as(pt_type, (a.reshape(a.shape[:-1] + (K, L)) for a in sums))
    empty = cur_counts == 0
    return select(empty, zero_like(K, L), sums), empty


def accumulate_buckets_padded(
    point_leaves,
    digits,
    signs,
    L: int,
    pair_add,
    prepare,
    zero_like,
    pair_level1=None,
    window_chunks: int = 1,
    max_slots: int = MAX_SLOTS,
):
    """Bucket accumulation through a padded (slot, window, bucket) layout.

    point_leaves: tuple of tensors, each (r, B) or (B,) - the per-point data
        to gather (affine x, y on the main path).
    digits, signs: (K, B) int32 magnitudes in [0, L] (0 = skip) and flags.
    pair_add(leaves_a, leaves_b) -> leaves: complete add, identity-safe.
    prepare(gathered_leaves, sign, valid) -> accumulator leaves with the
        exact identity wherever ``valid`` is False.
    zero_like(K, L) -> identity accumulator leaves (.., K, L).
    pair_level1(a, b, sa, sb, va, vb), when given, fuses sign application,
        identity encoding and the first tree level (the K3 kernel).
    window_chunks: windows are processed in this many chunks (bounds the
        live slot buffers); max_slots sizes the main round's sub-rounds.

    Buckets whose window uses few distinct digits are spread over L virtual
    buckets by within-bucket rank (S = L // (max_id + 1)) and folded back at
    the end; occupancies above the main round's M slots go to a compact
    top-T residual, or to global residual rounds when more than T virtual
    buckets overflow. Returns accumulator leaves (.., K, L).
    """
    K, B = digits.shape
    if B >= 1 << 30:
        raise ValueError("sort payload packs position | sign << 30")
    device = digits.device
    ids_all = torch.where(digits == 0, L, digits - 1).to(I32)
    signs_all = signs.to(I32)

    M = slot_count(B, L)
    pos_bits = max((B - 1).bit_length(), 1)
    id_bits = (L + 1).bit_length()  # ids range over [0, L] (L = sentinel)
    packed = id_bits + 1 + pos_bits <= 31
    sign_shift = pos_bits if packed else 30
    POS_MASK = (1 << sign_shift) - 1

    stacked, splits = _stack(tuple(point_leaves))

    def arange(n):
        return torch.arange(n, dtype=I32, device=device)

    def window_block(ids, sgn):
        Kc = ids.shape[0]
        lanes_all = Kc * L
        max_id = torch.where(ids == L, 0, ids).amax(dim=1)  # (Kc,)
        S = torch.clamp(L // (max_id + 1), min=1).to(I32)[:, None]  # spread factor

        iota = arange(B)[None, :].expand(Kc, B)
        if packed:
            # (id, sign, position) in one int32 key: a single-key sort
            key = (ids << (pos_bits + 1)) | (sgn << pos_bits) | iota
            key = torch.sort(key, dim=1).values
            sorted_ids = key >> (pos_bits + 1)
            order = key & ((1 << (pos_bits + 1)) - 1)  # sign@pos_bits | pos
        else:
            order, sorted_ids = sort_by_bucket(ids, iota | (sgn << 30))
        counts = bucket_counts(sorted_ids, L)[:, :L]  # (Kc, L)
        offsets = (torch.cumsum(counts, dim=-1) - counts).to(I32)

        # virtual id v -> (id, r) = (v // S, v % S); its j-th point sits at
        # sorted position offsets[id] + r + S * j
        vid = arange(L)[None, :]
        v_id = vid // S
        v_r = vid - v_id * S
        rowsL = arange(Kc)[:, None] * L
        v_flat = (v_id + rowsL).reshape(-1)
        v_off = offsets.reshape(-1).index_select(0, v_flat).reshape(Kc, L)
        v_cnt = counts.reshape(-1).index_select(0, v_flat).reshape(Kc, L)
        order_flat = order.reshape(-1)

        def tree_from(cur, m: int, lanes: int):
            # cur leaves (.., m, lanes): pairwise adds of slot halves down to
            # one slot; an odd m first folds its last slot into the first
            while m > 1:
                if m % 2:
                    first = pair_add(
                        tuple(a[..., :1, :] for a in cur),
                        tuple(a[..., m - 1 : m, :] for a in cur),
                    )
                    cur = tuple(
                        torch.cat([f, a[..., 1 : m - 1, :]], dim=-2)
                        for f, a in zip(first, cur)
                    )
                    m -= 1
                half = m // 2
                cur = pair_add(
                    tuple(a[..., :half, :] for a in cur),
                    tuple(a[..., half:, :] for a in cur),
                )
                m = half
            return tuple(a.reshape(a.shape[:-2] + (lanes,)) for a in cur)

        def gather_and_sum(flat, rank_valid, m: int, lanes: int):
            # ONE index gather of packed (position | sign), one point gather,
            # then level 1 (fused or prepared) and the tree
            src2 = order_flat.index_select(0, flat)
            src = src2 & POS_MASK
            sg = src2 >> sign_shift
            leaves = _unstack(stacked.index_select(-1, src), splits)
            if pair_level1 is not None:
                hsz = (m // 2) * lanes
                P = pair_level1(
                    tuple(x[..., :hsz] for x in leaves),
                    tuple(x[..., hsz:] for x in leaves),
                    sg[:hsz], sg[hsz:], rank_valid[:hsz], rank_valid[hsz:],
                )
                cur = tuple(x.reshape(x.shape[:-1] + (m // 2, lanes)) for x in P)
                return tree_from(cur, m // 2, lanes)
            P = prepare(leaves, sg, rank_valid)
            cur = tuple(x.reshape(x.shape[:-1] + (m, lanes)) for x in P)
            return tree_from(cur, m, lanes)

        def one_round(acc, p: int, m: int):
            # slot layout (m, Kc, L), slot axis major
            kbase = (arange(Kc) * B)[None, :, None].expand(m, Kc, L).reshape(-1)
            j = arange(m)[:, None, None]
            rank = v_r[None] + (p + j) * S[None]
            valid = (rank < v_cnt[None]).reshape(-1)
            pos = torch.clamp(v_off[None] + rank, 0, B - 1)
            sums = gather_and_sum(pos.reshape(-1) + kbase, valid, m, lanes_all)
            return pair_add(acc, sums)

        def flat_zero(k, lanes):
            return tuple(a.reshape(a.shape[:-2] + (k * lanes,)) for a in zero_like(k, lanes))

        # main rounds cover ranks [0, M_cov); the slot axis streams in
        # sub-rounds when M * Kc * L exceeds the slot budget
        n_rounds = max(1, -(-(M * lanes_all) // max_slots))
        m1 = -(-M // n_rounds)
        m1 += m1 & 1  # the fused level-1 kernel splits slots into equal halves
        M_cov = n_rounds * m1
        acc = flat_zero(Kc, L)
        for r in range(n_rounds):
            acc = one_round(acc, r * m1, m1)

        # residual: per-virtual-bucket occupancy ceil((cnt - r) / S)
        occ = torch.clamp((v_cnt - v_r + S - 1) // S, min=0)
        n_over = _host((occ > M_cov).sum())
        T = min(2048, lanes_all)
        MR = min(32, M)
        MR += MR & 1

        if 0 < n_over <= T:
            # compact: only the T most occupied virtual buckets, MR slots a round
            top_occ, top_idx = torch.topk(occ.reshape(-1), T)
            g_off = v_off.reshape(-1)[top_idx]
            g_vr = v_r.reshape(-1)[top_idx]
            g_S = S.expand(Kc, L).reshape(-1)[top_idx]
            g_cnt = v_cnt.reshape(-1)[top_idx]
            kbase_t = (top_idx // L).to(I32) * B
            maxo = _host(top_occ[0])
            accT = flat_zero(1, T)
            jr = arange(MR)[:, None]
            for p in range(M_cov, maxo, MR):
                COUNTS["compact_residual_rounds"] += 1
                rank = g_vr[None, :] + (p + jr) * g_S[None, :]  # (MR, T)
                valid = (rank < g_cnt[None, :]).reshape(-1)
                pos = torch.clamp(g_off[None, :] + rank, 0, B - 1)
                sums = gather_and_sum((pos + kbase_t[None, :]).reshape(-1), valid, MR, T)
                accT = pair_add(accT, sums)
            # ONE full-width combine: the T partial sums scattered into an
            # identity-valued delta (non-overflowing entries add the identity)
            delta = tuple(
                z.index_copy(-1, top_idx, t) for z, t in zip(flat_zero(Kc, L), accT)
            )
            acc = pair_add(acc, delta)
        elif n_over > T:
            # global: further M2-slot rounds over every virtual bucket
            M2 = max(M // 4, 2)
            M2 += M2 & 1
            max_occ = _host(((counts + S - 1) // S).amax())
            for p in range(M_cov, max_occ, M2):
                COUNTS["global_residual_rounds"] += 1
                acc = one_round(acc, p, M2)
        acc = tuple(a.reshape(a.shape[:-1] + (Kc, L)) for a in acc)

        # fold virtual buckets back: logical id l owns the virtual run
        # [l*S, (l+1)*S); log2(L) strided masked adds collapse each run onto
        # its first position, then one small gather moves l*S to l
        in_run = vid - (vid // S) * S
        zeros = zero_like(Kc, L)
        step = 1
        while step < L:
            can = (in_run + step) < S
            shifted = tuple(
                torch.cat([a[..., step:], z[..., :step]], dim=-1) for a, z in zip(acc, zeros)
            )
            comb = pair_add(acc, shifted)
            acc = tuple(torch.where(can, cmb, a) for cmb, a in zip(comb, acc))
            step *= 2
        # ids the digits never produced (l >= max_id + 1) get the identity;
        # l * S runs past int32 for those (up to L^2 where no digit is set),
        # so it is formed in int64 and clamped: every gathered index is valid
        src_pos = torch.clamp(vid.long() * S, max=L - 1)
        flat_pos = (src_pos + rowsL).reshape(-1)
        n_logical = (max_id + 1)[:, None]
        out = []
        for a, z in zip(acc, zeros):
            g = a.reshape(a.shape[:-2] + (lanes_all,)).index_select(-1, flat_pos)
            out.append(torch.where(vid < n_logical, g.reshape(a.shape), z))
        return tuple(out)

    chunks = max(1, min(window_chunks, K))
    if chunks == 1:
        return window_block(ids_all, signs_all)
    Kc = -(-K // chunks)
    chunks = -(-K // Kc)
    pad_k = chunks * Kc - K
    if pad_k:  # all-sentinel padding windows: no rounds, identity sums
        ids_all = torch.cat([ids_all, torch.full((pad_k, B), L, dtype=I32, device=device)])
        signs_all = torch.cat([signs_all, torch.zeros((pad_k, B), dtype=I32, device=device)])
    outs = [
        window_block(ids_all[i * Kc : (i + 1) * Kc], signs_all[i * Kc : (i + 1) * Kc])
        for i in range(chunks)
    ]
    return tuple(torch.cat(parts, dim=-2)[..., :K, :] for parts in zip(*outs))


def _blocks(L: int, c0: int):
    """(c0, block, D): the bucket row L (a power of two) split into D blocks
    of 2^c0 buckets, c0 lowered until the block divides L."""
    if L & (L - 1):
        raise ValueError("bucket count must be a power of two")
    block = 1 << c0
    while L % block != 0:
        block //= 2
        c0 -= 1
    return c0, block, L // block


def reduce_buckets(bucket_sums, empty, c0: int, acc_ops):
    """Per-window weighted bucket reduction S_k = sum_l (l+1) B[k, l], the
    sequential form, for bucket sums that are not accumulators (affine
    buckets: acc_ops.add_point is the mixed add, K7).

    Split L = D * 2^c0; per block, the triangle T_d = sum_j (j+1) B[d, j] and
    the row R_d = sum_j B[d, j] come from one 2^c0-step suffix loop over
    (K*D)-wide lanes; then S = sum_d T_d + 2^c0 sum_d d R_d, the weighted
    rows from a (D-1)-step suffix loop. acc_ops provides zero(*batch),
    add_point(acc, bucket, nonempty), add(a, b) and double_k(a, k).
    Returns accumulator leaves (.., K)."""
    pt_type = type(bucket_sums)
    K, L = bucket_sums[0].shape[-2:]
    c0, block, D = _blocks(L, c0)
    bs = pt_type(*(a.reshape(a.shape[:-1] + (D, block)) for a in bucket_sums))
    emp = empty.reshape(K, D, block)

    running, total = acc_ops.zero(K, D), acc_ops.zero(K, D)
    for j in range(block - 1, -1, -1):  # running += B_j; total += running
        running = acc_ops.add_point(running, pt_type(*(a[..., j] for a in bs)), ~emp[..., j])
        total = acc_ops.add(total, running)
    # total[d] = T_d, running[d] = R_d

    acc_type = type(running)
    if D > 1:  # sum_d d R_d by a suffix loop over d = D-1 .. 1
        wr, racc = acc_ops.zero(K), acc_ops.zero(K)
        for d in range(D - 1, 0, -1):
            racc = acc_ops.add(racc, acc_type(*(a[..., d] for a in running)))
            wr = acc_ops.add(wr, racc)
        wr = type(wr)(*(a[..., None] for a in wr))  # (.., K, 1)
    else:
        wr = acc_ops.zero(K, 1)
    tot, n = total, D  # sum_d T_d: a log tree over D (a power of two)
    while n > 1:
        half = n // 2
        tot = acc_ops.add(type(tot)(*(a[..., :half] for a in tot)),
                          type(tot)(*(a[..., half:] for a in tot)))
        n = half
    if c0 > 0:
        wr = acc_ops.double_k(wr, c0)
    S = acc_ops.add(tot, wr)  # (.., K, 1)
    return type(S)(*(a[..., 0] for a in S))


def reduce_buckets_log(bucket_sums, c0: int, acc_ops):
    """Per-window weighted bucket reduction S_k = sum_l (l+1) B[k, l] in log
    depth, for accumulator-form bucket sums (leaves (rows.., K, L), L a power
    of two):

      suffix[j] = sum_{l >= j} B[l]            log2(block) doubling rounds
      T_d = sum_j suffix[j],  R_d = suffix[0]  per block of 2^c0 buckets
      W   = sum_d d R_d                        the same trick over blocks
      S   = sum_d T_d + 2^c0 W

    acc_ops provides zero(*batch) -> leaves, add(a, b) and double_k(a, k)."""
    pt_type = type(bucket_sums)
    K, L = bucket_sums[0].shape[-2:]
    c0, block, D = _blocks(L, c0)
    bs = pt_type(*(a.reshape(a.shape[:-1] + (D, block)) for a in bucket_sums))

    def shift_add(x, step):
        zero = pt_type(*acc_ops.zero(*x[0].shape[1:]))
        shifted = pt_type(
            *(torch.cat([a[..., step:], z[..., :step]], dim=-1) for a, z in zip(x, zero))
        )
        return acc_ops.add(x, shifted)

    def tree_sum(x, n):  # over the last axis; n a power of two
        while n > 1:
            half = n // 2
            x = acc_ops.add(
                pt_type(*(a[..., :half] for a in x)),
                pt_type(*(a[..., half : 2 * half] for a in x)),
            )
            n = half
        return x

    suf = bs
    step = 1
    while step < block:
        suf = shift_add(suf, step)
        step *= 2
    R = pt_type(*(a[..., 0] for a in suf))  # (.., K, D)
    T = pt_type(*(a[..., 0] for a in tree_sum(suf, block)))  # (.., K, D)
    tot = tree_sum(T, D)  # (.., K, 1)
    if D > 1:
        sufR = R
        step = 1
        while step < D:
            sufR = shift_add(sufR, step)
            step *= 2
        # W = sum_{j>=1} sufR[j]: drop j = 0, pad one identity, tree-sum
        zero = pt_type(*acc_ops.zero(K, 1))
        tail = pt_type(*(torch.cat([a[..., 1:], z], dim=-1) for a, z in zip(sufR, zero)))
        W = tree_sum(tail, D)
    else:
        W = pt_type(*acc_ops.zero(K, 1))
    if c0 > 0:
        W = acc_ops.double_k(W, c0)
    S = acc_ops.add(tot, W)  # (.., K, 1)
    return pt_type(*(a[..., 0] for a in S))


def horner(window_sums, c: int, add, double_k):
    """result = sum_k 2^(k*c) W_k from the top window down; window_sums
    leaves (.., K) -> leaves (.., 1). ``double_k(P, c)`` does c doublings
    in one call (the K5 kernel)."""
    pt_type = type(window_sums)
    K = window_sums[0].shape[-1]
    acc = pt_type(*(a[..., K - 1 : K] for a in window_sums))
    for k in range(K - 2, -1, -1):
        acc = double_k(acc, c)
        acc = add(acc, pt_type(*(a[..., k : k + 1] for a in window_sums)))
    return acc
