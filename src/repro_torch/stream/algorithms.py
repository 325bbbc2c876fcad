"""Streaming graph algorithms — the port of ``repro/stream/algorithms.py``.

BFS, connected components, PageRank and triangle counts are functions of
the accumulated traffic matrix alone, so an answer after k micro-batches
equals a one-shot batch run over the concatenated stream.
:func:`snapshot_algorithms` lifts the state's link table (stable-id rows
weighted by ``n_packets``) through the plan pair into the (A, A^T) CSR pair
and hands it to :func:`repro_torch.core.algorithms.graph_algorithms`: two
sorts over ``link_capacity`` rows a call, none in the iterations.  The
vertex domain is the dictionary's stable-id range: ``ip_capacity`` slots,
of which the first ``state.n_ips`` are live (ids are first-seen dense).
"""
from __future__ import annotations

from ..core.algorithms import AlgorithmResults, graph_algorithms
from ..core.queries import table_csrs
from .engine import link_table
from .state import StreamState

__all__ = ["snapshot_algorithms"]


def snapshot_algorithms(
    state: StreamState,
    source=0,
    *,
    damping: float = 0.85,
    tol: float = 1e-6,
    pagerank_iters: int = 100,
    backend: str = "auto",
) -> AlgorithmResults:
    """All four graph algorithms over everything streamed so far.

    ``source`` is a BFS source in the stable-id domain.  Results are exact
    iff ``state.overflow == 0``.
    """
    csr_src, csr_dst = table_csrs(link_table(state))
    return graph_algorithms(
        csr_src, csr_dst, state.ip_capacity,
        n_live=state.n_ips, source=source,
        damping=damping, tol=tol, pagerank_iters=pagerank_iters,
        backend=backend,
    )
