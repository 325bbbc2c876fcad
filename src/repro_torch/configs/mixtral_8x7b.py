"""mixtral-8x7b [arXiv:2401.04088; hf]: 8-expert top-2 MoE + sliding-window
attention. 32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000, SWA 4096.

The port of ``repro/configs/mixtral_8x7b.py``: the same numbers and ``SPEC``."""
import dataclasses

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .common import lm_spec

ARCH_ID = "mixtral-8x7b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, sliding_window=4096, dtype=torch.bfloat16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336, capacity_factor=1.25),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=128, sliding_window=8,
        dtype=torch.float32, remat=False,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=96),
    )


SPEC = lm_spec(ARCH_ID, full_config, smoke_config, full_attention_only=False)


def optimized_config() -> TransformerConfig:
    """The reference's adopted variant: batched (per-sequence) MoE dispatch
    and capacity factor 1.0."""
    c = full_config()
    return dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, dispatch="batched", capacity_factor=1.0))
