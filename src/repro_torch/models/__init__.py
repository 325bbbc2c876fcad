"""Models served by the port — the counterpart of ``repro/models``: the
decoder-only transformer, dense and mixture-of-experts (``transformer``,
``moe``), the GNNs (``gnn``: SchNet, PNA, EGNN, GraphSAGE), xDeepFM
(``recsys``) and their layers (``layers``)."""
