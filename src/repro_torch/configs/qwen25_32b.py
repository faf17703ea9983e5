"""qwen2.5-32b — dense decoder, GQA 40:8, QKV bias.

[hf:Qwen/Qwen2.5-32B] 64L d_model=5120 40H (kv=8) d_ff=27648 vocab=152064.
"""

from ..models.config import ModelConfig

ARCH = "qwen2.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=27648, vocab=152064,
        qkv_bias=True, rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_head=16,
        d_ff=192, vocab=512,
        qkv_bias=True, rope_theta=1e6, dtype="float32", remat="none",
    )
