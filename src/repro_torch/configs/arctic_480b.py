"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 128-expert top-2 MoE
with a parallel dense residual branch (dense-MoE hybrid).

35L d_model=7168 56H (kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.

The port of ``repro/configs/arctic_480b.py``: the same numbers and ``SPEC``."""
import dataclasses

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .common import lm_spec

ARCH_ID = "arctic-480b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab=32000, dtype=torch.bfloat16,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864,
                      capacity_factor=1.25, dense_residual_d_ff=4864),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=96, vocab=128, dtype=torch.float32, remat=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, dense_residual_d_ff=64),
    )


SPEC = lm_spec(ARCH_ID, full_config, smoke_config, full_attention_only=True)


def optimized_config() -> TransformerConfig:
    """The reference's adopted variant: batched (per-sequence) MoE
    dispatch."""
    c = full_config()
    return dataclasses.replace(c, moe=dataclasses.replace(c.moe, dispatch="batched"))
