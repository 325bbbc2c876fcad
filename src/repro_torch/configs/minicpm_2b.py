"""minicpm-2b [arXiv:2404.06395; hf]: llama-like dense, MHA, tied
embeddings. 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753."""
import torch

from ..models.transformer import TransformerConfig
from ..train.optimizer import AdamWConfig
from .common import lm_spec

ARCH_ID = "minicpm-2b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753, tie_embeddings=True, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=48, n_heads=6,
        n_kv_heads=6, d_ff=96, vocab=128, tie_embeddings=True,
        dtype=torch.float32, remat=False,
    )


SPEC = lm_spec(
    ARCH_ID, full_config, smoke_config, full_attention_only=True,
    opt=AdamWConfig(lr=1e-2, schedule="wsd", warmup_steps=500,
                    total_steps=10_000, decay_fraction=0.1),
)
