"""yi-9b — llama-architecture dense decoder, GQA 32:4.

[arXiv:2403.04652] 48L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000.
"""

from ..models.config import ModelConfig

ARCH = "yi-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
        d_ff=11008, vocab=64000, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab=512, rope_theta=1e4, dtype="float32", remat="none",
    )
