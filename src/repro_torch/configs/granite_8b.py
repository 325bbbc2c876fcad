"""granite-8b [arXiv:2405.04324; hf]: llama-arch code model, GQA 32H/8KV.

36L d_model=4096 32H (kv=8) d_ff=14336 vocab=49152."""
import torch

from ..models.transformer import TransformerConfig
from .common import lm_spec

ARCH_ID = "granite-8b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=49152, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=128, dtype=torch.float32, remat=False,
    )


SPEC = lm_spec(ARCH_ID, full_config, smoke_config, full_attention_only=True)
