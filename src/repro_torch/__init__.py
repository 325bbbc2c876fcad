"""repro_torch — the Anonymized Network Sensing Graph Challenge on PyTorch
and CUDA (NVIDIA Hopper), ported from the JAX package ``repro``.

The layout mirrors ``repro`` (``core/``, ``kernels/``, ``data/``, ``obs/``,
``challenge/``, ``stream/``, ``models/``, ``train/``, ``launch/``) and each
module names its reference counterpart.  The port
imports nothing of ``repro`` and nothing of JAX; ``convert`` carries tables
and results across for the tests that hold the two against each other.
"""

__version__ = "0.1.0"
