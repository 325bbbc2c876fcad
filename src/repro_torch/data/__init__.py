"""Capture substrate of the port (copies of ``repro/data``): RMAT traffic,
columnar ``plq`` and row-major ``pcaplite`` captures."""
