"""IP-address anonymization (paper §IV) — the port of ``repro/core/anonymize.py``.

The paper's recipe in data-science ops: ``unique`` over the union of the src
and dst columns, a permutation of ``iota(N)``, and a gather of the new ids.
``method="hash"`` (the deterministic HashGraph-style permutation) is
bit-identical to the reference.  ``method="shuffle"`` draws its sort keys
from a ``torch.Generator``, so it is a uniform permutation like the
reference's but not the same one: JAX's random bits cannot be reproduced.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ops import factorize, hash_permutation, random_permutation
from .queries import unique_ips
from .table import Table

__all__ = ["AnonymizationResult", "anonymize"]


@dataclasses.dataclass(frozen=True)
class AnonymizationResult:
    table: Table              # same schema, src/dst replaced by anonymized ids
    ip_values: torch.Tensor   # sorted distinct original IPs (tail-padded)
    new_ids: torch.Tensor     # new_ids[rank] = anonymized id of ip_values[rank]
    n_ips: torch.Tensor       # 0-d int32


def anonymize(
    t: Table,
    generator: Optional[torch.Generator] = None,
    *,
    method: str = "shuffle",
    rounds: int = 1,
) -> AnonymizationResult:
    """Anonymize ``src``/``dst`` of a packet table.

    Args:
      t: packet table with ``src`` and ``dst`` columns.
      generator: ``torch.Generator`` on the table's device (required for
        ``method='shuffle'``).
      method: ``'shuffle'`` or ``'hash'``.
      rounds: shuffle rounds; composing uniform permutations is shuffling
        again (paper §IV).
    """
    ips = unique_ips(t)
    cap = ips.values.shape[0]
    n = ips.n_unique
    if method == "shuffle":
        if generator is None:
            raise ValueError("method='shuffle' requires a torch.Generator")
        perm = random_permutation(generator, cap, n)
        for _ in range(1, rounds):
            perm = perm[random_permutation(generator, cap, n).long()]
    elif method == "hash":
        perm = hash_permutation(cap, n)
        for r in range(1, rounds):
            perm = perm[hash_permutation(cap, n, salt=0x9E3779B9 + r).long()]
    else:
        raise ValueError(f"unknown method {method!r}")

    src_rank = factorize(t["src"], ips.values).long()
    dst_rank = factorize(t["dst"], ips.values).long()
    anon = t.with_columns(src=perm[src_rank], dst=perm[dst_rank])
    return AnonymizationResult(table=anon, ip_values=ips.values, new_ids=perm,
                               n_ips=n)
