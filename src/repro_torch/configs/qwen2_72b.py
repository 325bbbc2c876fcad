"""qwen2-72b [arXiv:2407.10671; hf]: dense, GQA (64H/8KV), QKV bias.

80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064."""
import torch

from ..models.transformer import TransformerConfig
from .common import lm_spec

ARCH_ID = "qwen2-72b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=160, vocab=128, qkv_bias=True, dtype=torch.float32,
        remat=False,
    )


SPEC = lm_spec(ARCH_ID, full_config, smoke_config, full_attention_only=True)
