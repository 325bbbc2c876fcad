"""Capture substrate of the port (copies of ``repro/data``): RMAT traffic
and adversarial scenarios, columnar ``plq`` and row-major ``pcaplite``
captures, the background ``Prefetcher``, the synthetic LM batches
(``lm_batches``), the GraphSAGE neighbour sampler (``sampler``), and the
fault layer the streaming service reads through (seeded chaos, retries,
quarantine, the health ledger)."""
