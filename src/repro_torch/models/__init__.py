"""Models served by the port — the counterpart of ``repro/models``: the
dense decoder-only transformer (``transformer``), the GNNs (``gnn``:
SchNet, PNA, EGNN, GraphSAGE) and their layers (``layers``).  MoE and
recsys are not ported yet."""
