"""Plain PyTorch versions of the port's kernels — the counterpart of
``repro/kernels/ref.py``.

Each ``ref_*`` function states the kernel's contract in stock tensor ops.
It is what a kernel wrapper runs for a tensor on the CPU (the tests) and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ref_histogram", "ref_histogram_blocked", "ref_segment_max",
           "ref_segment_max_blocked", "ref_cms_update", "ref_cms_update_clustered",
           "ref_hll_update", "ref_segment_matmul", "ref_segment_max_features",
           "ref_segment_matmul_tiled", "ref_attention", "ref_attention_split"]


def ref_histogram(
    ids: torch.Tensor,
    num_bins: int,
    weights: Optional[torch.Tensor] = None,
    *,
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire=0.0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Weighted histogram: ``out[b] = init[b] + sum_{i: ids[i]==b} w[i]``.

    The contract of ``repro/kernels/ref.py:35-127`` (histogram and
    ``segmented_reduce(op="sum")``): ids outside ``[0, num_bins)`` are
    dropped; with ``gate_ids``, rows with ``gate_ids[i] != gate_value`` are
    dropped too; ``init`` seeds the sum; bins where ``valid_mask`` is False
    take ``retire`` last, after the ``init`` fold.  Sums accumulate in
    ``out_dtype`` (float32 by default; int32 sums are exact at any count).
    """
    acc = torch.float32 if out_dtype is None else out_dtype
    w = (torch.ones(ids.shape, dtype=acc, device=ids.device)
         if weights is None else weights.to(acc))
    ok = (ids >= 0) & (ids < num_bins)
    if gate_ids is not None:
        ok = ok & (gate_ids == gate_value)
    out = torch.zeros(num_bins + 1, dtype=acc, device=ids.device).index_add_(
        0, torch.where(ok, ids, num_bins), torch.where(ok, w, 0))[:num_bins]
    if init is not None:
        out = init.to(acc) + out
    if valid_mask is not None:
        out = out.masked_fill(~valid_mask, retire)
    return out


def ref_histogram_blocked(
    ids: torch.Tensor,
    num_bins: int,
    weights: Optional[torch.Tensor] = None,
    *,
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire=0.0,
    out_dtype: Optional[torch.dtype] = None,
    private: bool,
    blocks: int,
    threads: int = 1024,
    rows_in_flight: int = 4,
) -> torch.Tensor:
    """:func:`ref_histogram` by the decomposition of the CUDA kernel.  Rows
    go to warps in tiles of ``32 * rows_in_flight``, the tiles dealt round
    the ``blocks`` x ``threads // 32`` warps of the grid.  ``private``: each
    block sums its rows into its own copy of the bins; the copies are
    summed bin by bin in the kernel's fixed order (copy group g of G =
    min(warps a block, blocks) adds copies g, g + G, ... in turn, then the
    G partial sums are added in order); then ``init`` is added and masked
    bins take ``retire``.  Else (the scatter): a seed of ``init`` (or 0),
    ``retire`` where masked, then each warp round of 32 adjacent rows adds
    each run of equal kept ids whose bin is valid as one sum.  For tests;
    no path runs it.
    """
    acc = torch.float32 if out_dtype is None else out_dtype
    dev = ids.device
    n = ids.shape[0]
    w = (torch.ones(n, dtype=acc, device=dev) if weights is None
         else weights.to(acc))
    ok = (ids >= 0) & (ids < num_bins)
    if gate_ids is not None:
        ok = ok & (gate_ids == gate_value)
    valid = (torch.ones(num_bins, dtype=torch.bool, device=dev)
             if valid_mask is None else valid_mask)
    base = (torch.zeros(num_bins, dtype=acc, device=dev) if init is None
            else init.to(acc) + torch.zeros((), dtype=acc, device=dev))
    rows = torch.arange(n, device=dev)
    warps = threads // 32
    block = (rows // (32 * rows_in_flight)) % (blocks * warps) // warps
    if private:
        copies = torch.zeros(blocks, num_bins + 1, dtype=acc, device=dev).index_put_(
            (block, torch.where(ok, ids, num_bins).long()), torch.where(ok, w, 0),
            accumulate=True)[:, :num_bins]
        groups = min(warps, blocks)
        partial = []
        for g in range(groups):
            s = torch.zeros(num_bins, dtype=acc, device=dev)
            for k in range(g, blocks, groups):
                s = s + copies[k]
            partial.append(s)
        total = partial[0]
        for s in partial[1:]:
            total = total + s
        out = total if init is None else init.to(acc) + total
        return torch.where(valid, out, torch.tensor(retire, dtype=acc, device=dev))
    out = torch.where(valid, base, torch.tensor(retire, dtype=acc, device=dev))
    ok = ok & valid[torch.where(ok, ids, 0).long()]
    kept = torch.where(ok, ids, -1)
    head = (rows % 32 == 0) | (kept != torch.roll(kept, 1))
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    run_sum = torch.zeros(int(head.sum()), dtype=acc, device=dev).index_add_(
        0, run, torch.where(ok, w, 0))
    run_id = kept[head]
    return out.index_add_(0, run_id[run_id >= 0].long(), run_sum[run_id >= 0])


def ref_segment_max(
    vals: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    *,
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire=float("-inf"),
) -> torch.Tensor:
    """Per-segment float32 max: ``out[s] = max(init[s], max_{i: seg_ids[i]==s}
    vals[i])``.

    The contract of ``repro/kernels/ref.py:113-126`` (``op="max"``): ids
    outside ``[0, num_segments)`` are dropped, and with ``gate_ids`` so are
    rows with ``gate_ids[i] != gate_value``; empty segments give ``-inf``,
    the max monoid's identity; ``init`` folds in by ``torch.maximum``;
    segments where ``valid_mask`` is False take ``retire`` last.  Values are
    not NaN.
    """
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    if gate_ids is not None:
        ok = ok & (gate_ids == gate_value)
    out = torch.full((num_segments + 1,), float("-inf"), dtype=torch.float32,
                     device=seg_ids.device).scatter_reduce_(
        0, torch.where(ok, seg_ids, num_segments).long(),
        vals.to(torch.float32), reduce="amax")[:num_segments]
    if init is not None:
        out = torch.maximum(init.to(torch.float32), out)
    if valid_mask is not None:
        out = out.masked_fill(~valid_mask, retire)
    return out


def ref_segment_max_blocked(
    vals: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    *,
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire=float("-inf"),
    blocks: int = 16,
    block_rows: int = 1024,
) -> torch.Tensor:
    """:func:`ref_segment_max` by the decomposition of the CUDA kernel: a
    seed phase applies the mask (``valid_mask ? init or -inf : retire``),
    then the fold maxes the kept rows whose segment is valid into the seeded
    output, one grid-stride step of ``blocks`` x ``block_rows`` rows at a
    time; a masked segment keeps ``retire`` whatever rows it receives.  For
    tests; no path runs it.
    """
    dev = seg_ids.device
    n = seg_ids.shape[0]
    valid = (torch.ones(num_segments, dtype=torch.bool, device=dev)
             if valid_mask is None else valid_mask)
    seed = (torch.full((num_segments,), float("-inf"), device=dev)
            if init is None else init.to(torch.float32))
    out = torch.where(valid, seed, torch.tensor(float(retire), device=dev))
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    if gate_ids is not None:
        ok = ok & (gate_ids == gate_value)
    ok = ok & valid[torch.where(ok, seg_ids, 0).long()]
    v = vals.to(torch.float32)
    step = blocks * block_rows
    for r0 in range(0, n, step):
        rows = slice(r0, r0 + step)
        folded = torch.full((num_segments + 1,), float("-inf"), device=dev
                            ).scatter_reduce_(
            0, torch.where(ok[rows], seg_ids[rows], num_segments).long(), v[rows],
            reduce="amax")[:num_segments]
        out = torch.maximum(out, folded)
    return out


def ref_cms_update(
    counts: torch.Tensor,
    col_ids: torch.Tensor,
    proposals: torch.Tensor,
) -> torch.Tensor:
    """Conservative-update Count-Min fold, the contract of
    ``repro/kernels/ref.py:130-163``.

    ``out[r, c] = max(counts[r, c], max_{i: col_ids[r, i] == c}
    proposals[i])``: every depth row scatter-maxes the same proposals through
    its own hashed columns; ids outside ``[0, width)`` (``-1`` marks a masked
    proposal) are dropped.  Works in ``counts.dtype``, float32 or int32, with
    the dtype's minimum as the empty-cell sentinel.
    """
    depth, width = counts.shape
    dtype = counts.dtype
    sentinel = (float("-inf") if dtype.is_floating_point
                else torch.iinfo(dtype).min)
    ids = col_ids.to(torch.int32)
    ok = (ids >= 0) & (ids < width)
    rows = torch.arange(depth, dtype=torch.int32, device=ids.device)[:, None]
    fused = torch.where(ok, rows * width + ids, depth * width)
    props = proposals.to(dtype)[None, :].expand(ids.shape)
    upd = torch.full((depth * width + 1,), sentinel, dtype=dtype,
                     device=ids.device).scatter_reduce_(
        0, fused.reshape(-1).long(), torch.where(ok, props, sentinel).reshape(-1),
        reduce="amax")[:depth * width].reshape(depth, width)
    return torch.maximum(counts, upd)


def ref_cms_update_clustered(
    counts: torch.Tensor,
    col_ids: torch.Tensor,
    proposals: torch.Tensor,
    *,
    cluster: int = 8,
) -> torch.Tensor:
    """:func:`ref_cms_update` by the decomposition of the CUDA kernel's
    cluster path: a depth row's proposals cut into ``cluster`` equal
    shares, each maxed into its own copy of the row's cells (the cell
    type's minimum where nothing lands), then each cell stored once, as the
    max of the running count and the ``cluster`` copies, by the block that
    owns its column (``ceil(width / cluster)`` columns a block).  Raises if
    a cell is stored other than once.  For tests; no path runs it.
    """
    depth, width = counts.shape
    n = col_ids.shape[1]
    dtype = counts.dtype
    low = float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
    props = proposals.to(dtype)
    share = -(-n // cluster)
    cols = -(-width // cluster)
    out = torch.empty_like(counts)
    stored = torch.zeros(depth, width, dtype=torch.int32)
    for r in range(depth):
        copies = []
        for k in range(cluster):
            ids = col_ids[r, k * share:(k + 1) * share]
            ok = (ids >= 0) & (ids < width)
            copies.append(torch.full((width + 1,), low, dtype=dtype).scatter_reduce_(
                0, torch.where(ok, ids, width).long(),
                props[k * share:(k + 1) * share], reduce="amax")[:width])
        for k in range(cluster):  # block k's columns
            c = slice(k * cols, (k + 1) * cols)
            m = counts[r, c]
            for copy in copies:
                m = torch.maximum(m, copy[c])
            out[r, c] = m
            stored[r, c] += 1
    if not bool((stored == 1).all()):
        raise AssertionError("a cell stored other than once")
    return out


def ref_hll_update(
    registers: torch.Tensor,
    reg_ids: torch.Tensor,
    rhos: torch.Tensor,
) -> torch.Tensor:
    """HyperLogLog register fold: :func:`ref_segment_max` with the running
    registers as ``init`` (``repro/kernels/ref.py:166-176``)."""
    return ref_segment_max(rhos, reg_ids, registers.shape[0], init=registers)


def ref_segment_matmul(
    x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Feature aggregation: ``out[s, :] = sum_{i: seg_ids[i]==s} x[i, :]``
    (``repro/kernels/ref.py:179-188``); ids outside ``[0, num_segments)``
    are dropped.

    Sums in float32 and returns float32 ``(num_segments, d)`` whatever
    ``x``'s type, as the TPU kernel ``segment_matmul_pallas`` does; the
    reference's plain (``"xla"``) path returns ``x``'s type instead.
    """
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    rows = torch.where(ok[:, None], x.to(torch.float32), 0.0)
    return torch.zeros(num_segments + 1, x.shape[1], dtype=torch.float32,
                       device=x.device).index_add_(
        0, torch.where(ok, seg_ids, num_segments).long(), rows)[:num_segments]


def ref_segment_max_features(
    x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Feature-wise segment max: ``out[s, :] = max_{i: seg_ids[i]==s} x[i, :]``
    in float32, ``(num_segments, d)``; ids outside ``[0, num_segments)`` are
    dropped and empty segments are ``-inf`` (``jax.ops.segment_max``'s
    identity).  One ``scatter_reduce_(amax)`` into ``num_segments + 1``
    rows, the last the dropped rows' spill: its autograd splits a segment's
    gradient evenly among the rows that tie for its max.
    """
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = torch.where(ok, seg_ids, num_segments).long()[:, None].expand(
        -1, x.shape[1])
    return torch.full((num_segments + 1, x.shape[1]), float("-inf"),
                      dtype=torch.float32, device=x.device).scatter_reduce_(
        0, idx, x.to(torch.float32), reduce="amax")[:num_segments]


def ref_segment_matmul_tiled(
    x: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    *,
    ts: int,
    tf: int,
    cap: int,
    parts: int = 0,
    warps: int = 32,
    split_slack: int = 16,
) -> torch.Tensor:
    """:func:`ref_segment_matmul` by the decomposition of the CUDA kernel:
    one tile of ``ts`` segments x ``tf`` features at a time.  With
    ``parts`` = 0 (direct) a tile's source is every id; else the rows are
    first sorted by tile as the partitioned launch sorts them (``parts``
    contiguous chunks of rows counted per tile, each tile's counts turned
    into a prefix over the chunks, the tiles' starts the prefix of their
    totals, each row placed at its tile's start + its chunk's prefix + its
    rank in the chunk), and a tile's source is its run of that list.  The
    source is read in rounds of ``cap``; each round's rows that fall in the
    tile sorted by segment (stable, as a counting sort with ranks in source
    order would); each segment summed in float32 one row after another by
    the warp that owns it (``warps`` equal shares of the segments), or,
    where the round's largest segment holds more than ``split_slack`` rows
    above an equal share of the rows, by warps taking equal runs of the
    sorted rows: a segment in pieces, one for each run it spans, added in
    run order; the sum stored in the first round or added to the stored
    one later.
    Raises if an element of the result is stored other than once, or if
    the sorted list is not the in-range rows grouped by tile.  For tests;
    no path runs it.
    """
    n, d = x.shape
    out = torch.empty(num_segments, d, dtype=torch.float32, device=x.device)
    stored = torch.zeros(num_segments, d, dtype=torch.int32, device=x.device)
    ids = seg_ids.to(torch.int64)
    tiles = -(-num_segments // ts)
    rows_of = None
    if parts:
        ok = (ids >= 0) & (ids < num_segments)
        tile = torch.where(ok, ids // ts, -1)
        bounds = [n * g // parts for g in range(parts + 1)]  # chunk g's rows
        counts = torch.zeros(tiles, parts, dtype=torch.int64)
        for g in range(parts):
            t = tile[bounds[g]:bounds[g + 1]]
            counts[:, g] = torch.bincount(t[t >= 0], minlength=tiles)
        prefix = torch.cumsum(counts, 1) - counts
        totals = counts.sum(1)
        starts = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(totals, 0)])
        perm = torch.full((int(starts[-1]),), -1, dtype=torch.int64)
        for g in range(parts):
            rank = torch.zeros(tiles, dtype=torch.int64)
            for i in range(bounds[g], bounds[g + 1]):
                t = int(tile[i])
                if t >= 0:
                    perm[int(starts[t] + prefix[t, g] + rank[t])] = i
                    rank[t] += 1
        hit = torch.nonzero(ok).flatten()
        if not (torch.equal(torch.sort(perm).values, hit)
                and torch.equal(tile[perm], torch.sort(tile[hit]).values)):
            raise AssertionError("the sorted rows are not the in-range rows by tile")
        rows_of = [perm[int(starts[t]):int(starts[t + 1])] for t in range(tiles)]
    for s0 in range(0, num_segments, ts):
        rows = min(ts, num_segments - s0)
        source = torch.arange(n) if rows_of is None else rows_of[s0 // ts]
        for f0 in range(0, d, tf):
            cols = min(tf, d - f0)
            for r0 in range(0, max(len(source), 1), cap):
                src = source[r0:r0 + cap]
                part = ids[src] - s0
                hit = torch.nonzero((part >= 0) & (part < rows)).flatten()
                order = torch.sort(part[hit], stable=True).indices
                hit, local = src[hit[order]], part[hit][order]
                per = -(-len(hit) // warps)  # rows a warp's run
                offset = torch.searchsorted(local, torch.arange(rows + 1)).tolist()
                biggest = max((b - a for a, b in zip(offset, offset[1:])), default=0)
                split = biggest > per + split_slack
                for l in range(rows):
                    acc = torch.zeros(cols, dtype=torch.float32, device=x.device)
                    q = offset[l]
                    while True:  # the owner's piece, then the next runs' heads
                        end = (min(offset[l + 1], (q // per + 1) * per) if split
                               else offset[l + 1])
                        piece = torch.zeros(cols, dtype=torch.float32, device=x.device)
                        for i in hit[q:end].tolist():
                            piece = piece + x[i, f0:f0 + cols].to(torch.float32)
                        acc = piece if q == offset[l] else acc + piece
                        q = end
                        if q >= offset[l + 1]:
                            break
                    if r0 == 0:
                        out[s0 + l, f0:f0 + cols] = acc
                        stored[s0 + l, f0:f0 + cols] += 1
                    else:
                        out[s0 + l, f0:f0 + cols] += acc
    if not bool((stored == 1).all()):
        raise AssertionError("a result element stored other than once")
    return out


def ref_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(Grouped-query) attention, the contract of ``repro/kernels/ref.py:191``
    and of the TPU kernel ``flash_attention_pallas``.

    q ``(B, Hq, Lq, D)``; k, v ``(B, Hkv, Lkv, D)`` with ``Hq % Hkv == 0``,
    query head ``h`` reading kv head ``h // (Hq // Hkv)``.  The ends of the
    two ranges align: query ``i`` sits at position ``i + Lkv - Lq``; with
    ``causal`` it sees keys at or before it, with ``window`` only keys in
    ``(pos - window, pos]``.  Computes in float32 and returns q's type.  A
    row that sees no key (only when ``Lq > Lkv``) is 0, the kernel's
    ``l == 0`` case; the reference gives NaN there.

    Differentiable: its autograd is the backward of the attention kernel's
    ``autograd.Function`` (``kernels/flash_attention.py``), as ``jax.vjp``
    of the reference's ``ref_attention`` is ``_fa_bwd``'s.  Nothing is
    written in place into a tensor autograd saves, and each kv head is
    widened to its query heads by ``expand``, whose backward is a sum over
    the group (a deterministic reduction, where ``repeat_interleave``'s is
    an atomic ``index_add_``), so two backward passes over the same inputs
    are bit-equal.
    """
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    def widen(x):  # (B, Hkv, Lkv, D) -> (B, Hq, Lkv, D), float32
        x = x.to(torch.float32)[:, :, None].expand(b, hkv, group, lkv, d)
        return x.reshape(b, hq, lkv, d)

    kk, vv = widen(k), widen(v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) * scale
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lkv - lq)
    k_pos = torch.arange(lkv, device=q.device)[None, :]
    mask = torch.ones(lq, lkv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    probs = torch.softmax(logits.masked_fill_(~mask, float("-inf")), dim=-1)
    del logits  # (B, Hq, Lq, Lkv) float32: 8.6 GB at Lq = Lkv = 8192, Hq = 32
    # out of place: softmax saves its output for the backward, so the rows
    # that see no key are zeroed in one more (B, Hq, Lq, Lkv) float32 buffer
    probs = probs.masked_fill(~mask.any(dim=-1, keepdim=True), 0.0)
    return (probs @ vv).to(q.dtype)


def ref_attention_split(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    begin: int = 0,
    chunk_keys: int = 64,
) -> torch.Tensor:
    """:func:`ref_attention` by the arithmetic of the CUDA kernel's decode
    path, in float32: the GQA group's query heads packed into rows of one kv
    head, a partial (row max ``m``, sum ``l``, unnormalised accumulator) per
    kv chunk ``[begin + c * chunk_keys, + chunk_keys)`` up to Lkv, then the
    chunks rescaled by ``exp(m_c - max m)`` and summed.  A chunk that sees no
    key of a row has ``m = -inf`` and ``l = 0`` and adds nothing; a row that
    sees no key at all is 0.  Keys before ``begin`` are left out, as the
    kernel leaves out keys below the band.  For tests; no path runs it.
    """
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    rows = q.to(torch.float32).reshape(b, hkv, group * lq, d)  # row gi * lq + qi
    q_pos = torch.arange(lq, device=q.device).repeat(group)[:, None] + (lkv - lq)
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    parts = []
    for c0 in range(begin, max(lkv, begin + 1), chunk_keys):
        c1 = min(lkv, c0 + chunk_keys)
        kc = k[:, :, c0:c1].to(torch.float32)
        s = torch.einsum("bhrd,bhkd->bhrk", rows, kc) * scale
        k_pos = torch.arange(c0, c1, device=q.device)[None, :]
        mask = torch.ones(group * lq, c1 - c0, dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True) if c1 > c0 else neg_inf.expand(
            b, hkv, group * lq, 1)
        p = torch.exp(s - torch.where(m == neg_inf, 0.0, m))  # the -inf guard
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      p @ v[:, :, c0:c1].to(torch.float32)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total = torch.zeros_like(m_all)
    acc = torch.zeros_like(rows)
    for m, l, a in parts:
        w = torch.where(m == neg_inf, 0.0, torch.exp(m - m_all))
        total = total + l * w
        acc = acc + a * w
    out = torch.where(total > 0, acc / torch.where(total > 0, total, 1.0), 0.0)
    return out.reshape(b, hq, lq, d).to(q.dtype)
