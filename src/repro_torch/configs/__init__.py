"""Model configurations served by the port — the counterpart of
``repro/configs`` for the dense decoders: ``full_config()`` (the published
widths and depth) and ``smoke_config()`` (the reference's small test size)
of each, with the reference's numbers.  The reference's ``ArchSpec`` and
sharding machinery (``configs/common.py``) is not ported."""
