"""Model configurations served by the port — the counterpart of
``repro/configs``.  The decoders (``granite_8b``, ``minicpm_2b``,
``qwen2_72b``, and the mixtures of experts ``mixtral_8x7b`` and
``arctic_480b``): ``ARCH_ID``, ``full_config()`` (the published widths and
depth) and ``smoke_config()`` (the reference's small test size) of each,
and ``optimized_config()`` of the MoE two (the reference's batched
dispatch).  The GNNs (``schnet``, ``pna``, ``egnn``, ``graphsage_reddit``,
over ``common_gnn``): ``ARCH_ID``, ``make_cfg(info)`` (the published widths
for a shape of ``common_gnn.GNN_SHAPES``), ``smoke()`` and ``SPEC``.
xDeepFM (``xdeepfm``): ``ARCH_ID``, ``SHAPES``, ``CFG``, ``OPT``,
``serve_fn(shape)`` and ``smoke()``.  All with the reference's numbers.
The reference's ``ArchSpec`` and sharding machinery (``configs/common.py``)
is not ported."""
