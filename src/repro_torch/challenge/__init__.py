"""repro_torch.challenge — the end-to-end Anonymized Network Sensing workload
on PyTorch (the port of ``repro.challenge``): the timed phases over one
static-shape table, with the one-program path (one CUDA graph on the card).
``distributed_scalar_queries`` is not ported yet (ROADMAP.md queue 1 item
10).  CLI:

    PYTHONPATH=src python -m repro_torch.challenge.run --scale 20
"""
from .pipeline import (
    ChallengeConfig,
    ChallengePhaseTimings,
    ChallengeResults,
    ChallengeRun,
    analyze,
    cross_window_ip_overlap,
    run_challenge,
)

__all__ = [
    "ChallengeConfig",
    "ChallengePhaseTimings",
    "ChallengeResults",
    "ChallengeRun",
    "analyze",
    "cross_window_ip_overlap",
    "run_challenge",
]
