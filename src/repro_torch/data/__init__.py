"""Capture substrate of the port (copies of ``repro/data``): RMAT traffic
and adversarial scenarios, columnar ``plq`` and row-major ``pcaplite``
captures, the background ``Prefetcher`` and the ingest health ledger."""
