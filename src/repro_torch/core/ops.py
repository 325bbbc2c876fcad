"""Relational primitives — the port of ``repro/core/ops.py``: the packed
sort, group-by, ``unique``/``value_counts``/``drop_duplicates``, ``isin``,
``semi_join``, top-k and the permutations.

Every op keeps the reference's static-shape contract: arrays of a fixed
``capacity`` with the first ``n_valid`` rows live, results tail-padded with
an ``n_groups``/``n_unique`` count, padding identical to the reference's so
that whole buffers compare bit for bit.

Three things differ from JAX and shape the code:

* **Packed sort keys live in int64.**  The reference fuses one or two
  32-bit keys into a ``uint64`` and sorts that; torch does not promise a
  ``uint64`` sort on CUDA, so the port packs ``(int64(hi_signed) << 32) |
  lo_biased_u32`` into a signed int64, which orders the same way.  The
  invalid sentinel is ``INT64_MAX``, which unpacks to the same
  ``(INT32_MAX, INT32_MAX)`` tail the reference's ``UINT64_MAX`` does.
  torch has no multi-operand sort either, so three or more keys, which
  the reference sorts in one comparator sort, sort in stable passes of
  one word each, least significant first: one more sort than the
  reference's for ``(win, src, dst)``.
* **uint32 words are int64 in ``[0, 2^32)``.**  torch has no ``>>`` or
  ``%`` for ``uint32``, so :func:`mix32` and hashed keys compute in int64,
  masked to 32 bits after every step that can leave the range.  A key
  tensor of dtype int64 is read as such a word.
* **int32 reductions name their dtype.**  ``torch.sum``/``cumsum`` of int32
  return int64; where the reference's int32 result (and its wraparound) is
  part of the output, the port passes ``dtype=torch.int32``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "multi_key_sort",
    "segment_sum",
    "segment_ids_from_sorted",
    "GroupResult",
    "groupby_aggregate",
    "UniqueResult",
    "unique",
    "value_counts",
    "drop_duplicates",
    "factorize",
    "isin",
    "semi_join",
    "masked_max",
    "clamp_k",
    "top_k",
    "argmax_top_k",
    "mix32",
    "random_permutation",
    "hash_permutation",
]

_U32_MASK = 0xFFFFFFFF
_I32_BIAS = 1 << 31
_I64_MAX = torch.iinfo(torch.int64).max


def _count(n, cap: int, device) -> torch.Tensor:
    """A live-row count as a 0-d int32 tensor on ``device`` (None = cap).
    A Python int becomes one by a fill on the device, not by a copy from
    the host, which would synchronize (and cannot be captured in a CUDA
    graph)."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32)
    return torch.full((), cap if n is None else int(n), dtype=torch.int32,
                      device=device)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


# -----------------------------------------------------------------------------
# Packed-key sorting (reference: ops.py:59-242)
# -----------------------------------------------------------------------------

def _word(k: torch.Tensor) -> torch.Tensor:
    """Order-preserving unsigned 32-bit word of a key, as int64."""
    if k.dtype == torch.int32:
        return k.to(torch.int64) + _I32_BIAS
    if k.dtype == torch.int64:  # already a uint32 word
        return k
    raise ValueError(f"sort keys must be int32 or uint32 words, got {k.dtype}")


def _unword(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (w - _I32_BIAS).to(torch.int32) if dtype == torch.int32 else w


def _stable_partition_perm(valid: torch.Tensor) -> torch.Tensor:
    """Gather permutation moving live rows to the prefix, order-preserving."""
    cap = valid.shape[0]
    n_valid = valid.sum(dtype=torch.int64)
    live_pos = torch.cumsum(valid, 0) - 1
    dead_pos = n_valid + torch.cumsum(~valid, 0) - 1
    dest = torch.where(valid, live_pos, dead_pos)
    return torch.empty(cap, dtype=torch.int64, device=valid.device).scatter_(
        0, dest, torch.arange(cap, device=valid.device))


def _pass_word(keys: Sequence[torch.Tensor],
               invalid: Optional[torch.Tensor]) -> torch.Tensor:
    """One sort pass's int64 word of one or two keys; ``invalid`` rows go
    last (the validity flag above a single key, ``INT64_MAX`` for a pair)."""
    if len(keys) == 1:
        packed = _word(keys[0])
        if invalid is not None:
            packed = packed | (invalid.to(torch.int64) << 32)
        return packed
    packed = ((_word(keys[0]) - _I32_BIAS) << 32) | _word(keys[1])
    return packed if invalid is None else torch.where(invalid, _I64_MAX, packed)


def _multi_pass_order(keys: Sequence[torch.Tensor],
                      invalid: Optional[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order of three or more keys: one stable sort
    per pass, least significant pass first, each pass pairing two keys into
    one int64 word (an odd count leaves the least significant key to sort
    alone, first, in its own dtype).  The most significant pass carries
    validity; a live row whose two leading keys are both ``INT32_MAX``
    collides with its sentinel, and earlier passes may have put it behind
    padding, so a stable partition on validity repairs the order."""
    passes = [keys[i:i + 2] for i in range(0, len(keys), 2)]
    order = None
    for i, group in enumerate(reversed(passes)):
        lead = i == len(passes) - 1
        if order is not None:
            group = [k[order] for k in group]
        if len(group) == 1 and group[0].dtype == torch.int32:
            word = group[0]  # a lone trailing key sorts as it is
        else:
            bad = None
            if lead and invalid is not None:
                bad = invalid if order is None else invalid[order]
            word = _pass_word(group, bad)
        _, o = torch.sort(word, stable=True)
        order = o if order is None else order[o]
    if invalid is not None:
        order = order[_stable_partition_perm(~invalid[order])]
    return order


def multi_key_sort(
    keys: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    n_valid=None,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Stable lexicographic sort by 32-bit ``keys``, carrying ``payloads``;
    live rows (prefix ``n_valid`` or ``valid_mask``) first.

    One or two keys take ONE ``torch.sort(stable=True)`` of one int64 word
    per row:

    * 1 key: the high word carries the validity flag, the low word the key;
    * 2 keys: the leading key (signed) is the high word, the trailing key
      (biased) the low word, invalid rows become ``INT64_MAX``.  A valid
      row with both keys at ``INT32_MAX`` collides with that sentinel:
      with prefix validity stability keeps it ahead of the padding, and
      with a ``valid_mask`` a stable partition on the carried validity
      repairs the order after the sort (one cumsum + scatter, no sort).

    Three or more keys, where the reference runs one multi-operand sort,
    take one stable sort per pair of keys (:func:`_multi_pass_order`): two
    for ``(win, src, dst)``.

    Returns (sorted_keys, sorted_payloads), as the reference does.  The live
    prefix, payload order included, equals the reference's stable sort; the
    tail keys unpack to ``INT32_MAX`` in the 2-key layout and, as in the
    reference, are undefined with three or more keys.
    """
    if not keys:
        raise ValueError("multi_key_sort needs at least one key")
    cap = keys[0].shape[0]
    device = keys[0].device
    if valid_mask is not None:
        invalid = ~valid_mask
    elif n_valid is not None:
        invalid = _iota(cap, device) >= _count(n_valid, cap, device)
    else:
        invalid = None
    if len(keys) > 2:
        order = _multi_pass_order(keys, invalid)
        return (tuple(k[order] for k in keys),
                tuple(p[order] for p in payloads))
    spacked, order = torch.sort(_pass_word(keys, invalid), stable=True)
    if len(keys) == 2 and valid_mask is not None:
        perm = _stable_partition_perm(valid_mask[order])
        spacked, order = spacked[perm], order[perm]
    lo = spacked & _U32_MASK
    if len(keys) == 1:
        skeys = (_unword(lo, keys[0].dtype),)
    else:
        hi = (spacked >> 32) + _I32_BIAS
        skeys = (_unword(hi, keys[0].dtype), _unword(lo, keys[1].dtype))
    return skeys, tuple(p[order] for p in payloads)


# -----------------------------------------------------------------------------
# Segment structure and group-by (reference: ops.py:245-389)
# -----------------------------------------------------------------------------

def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ``out[s] = sum(values[seg == s])``.

    ``seg`` must lie in ``[0, num_segments)`` (the plan's padding rows carry
    ``capacity`` and callers size the buffer ``capacity + 1``)."""
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, values)


def _segment_extreme(values, seg, num_segments, reduce: str, ident):
    out = torch.full((num_segments,), ident, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, seg.long(), values, reduce=reduce)


def segment_ids_from_sorted(
    sorted_keys: Sequence[torch.Tensor], n_valid
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group structure of pre-sorted keys: ``(seg_ids, first_flags,
    n_groups)``; padding rows carry ``seg_ids == capacity``."""
    cap = sorted_keys[0].shape[0]
    device = sorted_keys[0].device
    valid = _iota(cap, device) < _count(n_valid, cap, device)
    neq = torch.zeros(cap, dtype=torch.bool, device=device)
    neq[:1] = True
    for k in sorted_keys:
        neq[1:] |= k[1:] != k[:-1]
    first = (neq & valid).to(torch.int32)
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    seg = torch.where(valid, seg, cap).to(torch.int32)
    return seg, first, first.sum(dtype=torch.int32)


def _max_ident(dtype):
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def _min_ident(dtype):
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def _scatter_firsts(col, seg, first, cap: int) -> torch.Tensor:
    """First-occurrence values of ``col`` in their group slot; padding slots
    hold the dtype max so key outputs stay sorted ascending."""
    dst = torch.where(first.bool(), seg, cap).long()
    buf = torch.full((cap + 1,), _max_ident(col.dtype), dtype=col.dtype,
                     device=col.device)
    return buf.scatter_(0, dst, col)[:cap]


_AGGS = ("sum", "count", "max", "min", "mean")


@dataclasses.dataclass(frozen=True)
class GroupResult:
    """Result of a group-by: group keys + aggregates, tail-padded."""

    keys: Tuple[torch.Tensor, ...]
    aggs: Dict[str, torch.Tensor]
    n_groups: torch.Tensor  # 0-d int32

    def mask(self) -> torch.Tensor:
        return _iota(self.keys[0].shape[0], self.n_groups.device) < self.n_groups


def groupby_aggregate(
    keys: Sequence[torch.Tensor],
    values: Optional[Dict[str, Tuple[torch.Tensor, str]]] = None,
    n_valid=None,
    count_name: Optional[str] = "count",
    valid_mask: Optional[torch.Tensor] = None,
) -> GroupResult:
    """``df.groupby(keys).agg(values)`` — one packed sort + segment reductions.

    ``values`` maps output name -> (value column, agg) with agg in
    ``{"sum","count","max","min","mean"}``.
    """
    cap = keys[0].shape[0]
    device = keys[0].device
    if valid_mask is not None:
        n_valid = valid_mask.sum(dtype=torch.int32)
    else:
        n_valid = _count(n_valid, cap, device)
    values = dict(values or {})
    for name, (_, agg) in values.items():
        if agg not in _AGGS:
            raise ValueError(f"unknown agg {agg!r} for {name!r}")

    skeys, spayloads = multi_key_sort(
        keys, [v for v, _ in values.values()], n_valid=n_valid,
        valid_mask=valid_mask,
    )
    seg, first, n_groups = segment_ids_from_sorted(skeys, n_valid)
    valid = _iota(cap, device) < n_valid

    out_keys = tuple(_scatter_firsts(k, seg, first, cap) for k in skeys)
    aggs: Dict[str, torch.Tensor] = {}
    counts = None
    if count_name is not None or any(
        a in ("mean", "count") for _, a in values.values()
    ):
        counts = segment_sum(valid.to(torch.int32), seg, cap + 1)[:cap]
    if count_name is not None:
        aggs[count_name] = counts

    for (name, (_, agg)), col in zip(values.items(), spayloads):
        if agg in ("sum", "mean"):
            s = segment_sum(torch.where(valid, col, 0), seg, cap + 1)[:cap]
            if agg == "sum":
                aggs[name] = s
            else:
                div_dtype = s.dtype if s.dtype.is_floating_point else torch.float32
                aggs[name] = s / torch.clamp(counts, min=1).to(div_dtype)
        elif agg == "count":
            aggs[name] = counts
        else:
            ident = _min_ident(col.dtype) if agg == "max" else _max_ident(col.dtype)
            aggs[name] = _segment_extreme(
                torch.where(valid, col, ident), seg, cap + 1,
                "amax" if agg == "max" else "amin", ident,
            )[:cap]
    return GroupResult(keys=out_keys, aggs=aggs, n_groups=n_groups)


@dataclasses.dataclass(frozen=True)
class UniqueResult:
    """Sorted distinct values, their multiplicities, and the live count."""

    values: torch.Tensor
    counts: torch.Tensor
    weight_sums: Optional[torch.Tensor]
    n_unique: torch.Tensor  # 0-d int32

    def mask(self) -> torch.Tensor:
        return _iota(self.values.shape[0], self.n_unique.device) < self.n_unique


def unique(
    x: torch.Tensor,
    n_valid=None,
    weights: Optional[torch.Tensor] = None,
    valid_mask: Optional[torch.Tensor] = None,
) -> UniqueResult:
    """``np.unique(return_counts=True)`` with static shapes: one group-by
    sort, ``weights`` summed per value when given."""
    values = {"w": (weights, "sum")} if weights is not None else None
    g = groupby_aggregate([x], values, n_valid=n_valid, count_name="count",
                          valid_mask=valid_mask)
    return UniqueResult(values=g.keys[0], counts=g.aggs["count"],
                        weight_sums=g.aggs.get("w"), n_unique=g.n_groups)


def value_counts(x: torch.Tensor, n_valid=None) -> UniqueResult:
    """``df[col].value_counts()`` (in value order; counts + mask)."""
    return unique(x, n_valid=n_valid)


def drop_duplicates(keys: Sequence[torch.Tensor], n_valid=None) -> GroupResult:
    """``df[cols].drop_duplicates()`` — the distinct key rows."""
    return groupby_aggregate(keys, None, n_valid=n_valid, count_name="count")


def factorize(x: torch.Tensor, sorted_uniques: torch.Tensor) -> torch.Tensor:
    """Rank of each element of ``x`` in the tail-padded ascending
    ``sorted_uniques`` (a binary search, not a sort)."""
    return torch.searchsorted(sorted_uniques, x, side="left").to(torch.int32)


def isin(
    x: torch.Tensor,
    sorted_uniques: torch.Tensor,
    n_uniques,
    n_valid=None,
) -> torch.Tensor:
    """``df[col].isin(values)`` against the tail-padded ascending
    ``sorted_uniques`` (first ``n_uniques`` live): one binary search per
    element.  Returns a (capacity,) bool mask, False on padding rows
    (past ``n_valid``).  ``x`` and ``sorted_uniques`` must share a dtype."""
    cap = x.shape[0]
    device = x.device
    pos = torch.searchsorted(sorted_uniques, x, side="left").to(torch.int32)
    safe = torch.clamp(pos, max=sorted_uniques.shape[0] - 1).long()
    hit = (pos < _count(n_uniques, 0, device)) & (sorted_uniques[safe] == x)
    return hit & (_iota(cap, device) < _count(n_valid, cap, device))


def semi_join(
    left_keys: Sequence[torch.Tensor],
    right_keys: Sequence[torch.Tensor],
    left_n_valid=None,
    right_n_valid=None,
) -> torch.Tensor:
    """Multi-key semi-join membership: does left row i appear in right?

    The engine's sort-merge: both sides concatenated with a side flag
    (left 1, right 0), sorted by (keys..., flag), and every equal-key run
    whose least flag is 0 holds a right row, so its left rows are members.
    The flag is one more sort key, so two keys plus the flag take the two
    stable passes of :func:`multi_key_sort` where the reference sorts once.
    Returns a (left_capacity,) bool mask, False on left padding rows.
    """
    lcap = left_keys[0].shape[0]
    rcap = right_keys[0].shape[0]
    device = left_keys[0].device
    l_nv = _count(left_n_valid, lcap, device)
    r_nv = _count(right_n_valid, rcap, device)
    both = [torch.cat([l, r]) for l, r in zip(left_keys, right_keys)]
    is_left = torch.cat([torch.ones(lcap, dtype=torch.int32, device=device),
                         torch.zeros(rcap, dtype=torch.int32, device=device)])
    idx = torch.cat([_iota(lcap, device),
                     torch.full((rcap,), lcap, dtype=torch.int32, device=device)])
    pos = _iota(lcap + rcap, device)
    valid = torch.where(pos < lcap, pos < l_nv, pos - lcap < r_nv)

    skeys_and_side, (s_idx,) = multi_key_sort([*both, is_left], [idx],
                                              valid_mask=valid)
    *skeys, s_is_left = skeys_and_side
    n_total = l_nv + r_nv
    live = pos < n_total
    seg, _, _ = segment_ids_from_sorted(skeys, n_total)
    # a run is hit iff it holds a right row (side flag 0 -> run min 0)
    run_min_side = _segment_extreme(
        torch.where(live, s_is_left, 1), seg, lcap + rcap + 1, "amin",
        _max_ident(torch.int32))
    member = (run_min_side[seg.long()] == 0) & (s_is_left == 1) & live
    # non-members go to the dump slot lcap, as the reference's .at[].set
    out = torch.zeros(lcap + 1, dtype=torch.bool, device=device)
    return out.scatter_(0, torch.where(member, s_idx, lcap).long(), member)[:lcap]


def masked_max(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over the masked entries with a zero floor (all-masked -> 0)."""
    return torch.where(mask, values, 0).max()


def clamp_k(k: int, capacity: int) -> int:
    """``min(k, capacity)`` — the static top-k clamp."""
    return min(k, capacity)


def top_k(
    values: torch.Tensor,
    k: int,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Largest ``k`` live entries of ``values``: ``(vals, indices, n_live)``.

    ``lax.top_k``'s tie rule, lowest index first, from one stable descending
    sort (``torch.topk`` promises no order among ties).  Slots past
    ``n_live = min(k, #valid)`` hold the dtype min and index 0; ``k`` is
    clamped to the buffer capacity.
    """
    k = clamp_k(k, values.shape[0])
    ident = _min_ident(values.dtype)
    masked = values if valid_mask is None else torch.where(
        valid_mask, values, ident)
    vals, idx = torch.sort(masked, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    n_live = (_count(values.shape[0], 0, values.device) if valid_mask is None
              else valid_mask.sum(dtype=torch.int32))
    n_live = torch.clamp(n_live, max=k)
    keep = _iota(k, values.device) < n_live
    return (torch.where(keep, vals, ident),
            torch.where(keep, idx, 0).to(torch.int32), n_live)


def argmax_top_k(
    values: torch.Tensor,
    k: int,
    valid_mask: Optional[torch.Tensor] = None,
    *,
    n_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free top-k: ``k`` rounds of masked argmax -> ``(vals, indices,
    n_live)``.

    ``torch.argmax`` returns the first maximal index, which is the
    reference's tie rule (lowest index wins); ``torch.topk`` promises no
    tie order, so it is not used.  Selected slots are retired to the dtype
    min, so live values must exceed it (true for the non-negative counts
    and packet sums this serves).  ``n_valid`` replaces the mask recount
    when the mask is already retired into ``values``.
    """
    k = clamp_k(k, values.shape[0])
    device = values.device
    ident = _min_ident(values.dtype)
    cur = values.clone() if valid_mask is None else torch.where(
        valid_mask, values, ident)
    vals = torch.full((k,), ident, dtype=values.dtype, device=device)
    idx = torch.zeros(k, dtype=torch.int32, device=device)
    for i in range(k):
        j = torch.argmax(cur).view(1)  # 1-d index: no host round trip
        vals[i:i + 1] = cur[j]
        idx[i:i + 1] = j
        cur.index_fill_(0, j, ident)
    if n_valid is not None:
        n_live = _count(n_valid, 0, device)
    elif valid_mask is not None:
        n_live = valid_mask.sum(dtype=torch.int32)
    else:
        n_live = _count(values.shape[0], 0, device)
    n_live = torch.clamp(n_live, max=k)
    keep = _iota(k, device) < n_live
    return torch.where(keep, vals, ident), torch.where(keep, idx, 0), n_live


# -----------------------------------------------------------------------------
# Permutations (reference: ops.py:649-692)
# -----------------------------------------------------------------------------

def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style finalizer, a bijection on uint32 words.

    Takes int32 (read as its two's-complement bits) or an int64 word and
    returns the int64 word.  Each product of two values below 2^32 wraps in
    int64, but its low 32 bits — all the mask keeps — are exact.
    """
    x = x.to(torch.int64) & _U32_MASK
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32_MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32_MASK
    return x ^ (x >> 16)


def _permutation_from_keys(r: torch.Tensor, n_valid) -> torch.Tensor:
    """Rank-scatter of a 1-key sort: ``out[rank]`` is that rank's new slot."""
    cap = r.shape[0]
    iota = _iota(cap, r.device)
    (_,), (ranks,) = multi_key_sort([r], [iota], n_valid=n_valid)
    return torch.zeros(cap, dtype=torch.int32, device=r.device).scatter_(
        0, ranks.long(), iota)


def random_permutation(
    generator: torch.Generator, capacity: int, n_valid
) -> torch.Tensor:
    """Uniform random permutation of ``[0, n_valid)`` in a static buffer.

    Random 32-bit sort keys drawn from ``generator`` (on the device the
    permutation is built on), invalid tail pushed last by the validity key,
    ranks scattered.  Tail entries map into ``[n_valid, capacity)``.
    """
    r = torch.randint(0, 1 << 32, (capacity,), generator=generator,
                      dtype=torch.int64, device=generator.device)
    return _permutation_from_keys(r, n_valid)


def hash_permutation(capacity: int, n_valid: torch.Tensor,
                     salt: int = 0x9E3779B9) -> torch.Tensor:
    """Deterministic HashGraph-style permutation: ranks sorted by
    ``mix32(rank + salt)``, one sort — bit-identical to the reference."""
    iota = torch.arange(capacity, dtype=torch.int64, device=n_valid.device)
    return _permutation_from_keys(mix32(iota + salt), n_valid)
