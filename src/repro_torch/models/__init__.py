"""Models served by the port — the counterpart of ``repro/models``: the
dense decoder-only transformer (``transformer``) and its layers
(``layers``).  MoE, the GNNs and recsys are not ported yet."""
