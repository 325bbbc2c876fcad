"""repro_torch.launch — entry points of the port: ``serve`` (the
fault-tolerant streaming service, ``python -m repro_torch.launch.serve``)
and ``train`` (LM training, ``python -m repro_torch.launch.train``).  The
reference's other launchers (dry runs, the roofline and autotune lanes,
meshes) are not ported yet (ROADMAP.md queue 1 items 9 and 11)."""
