"""glm4-9b — dense decoder, extreme GQA (32 q heads : 2 kv heads).

[hf:THUDM/glm-4-9b] 40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552,
RoPE (partial-rotary in HF; standard rotary here — noted in DESIGN.md),
attention bias on QKV.
"""

from ..models.config import ModelConfig

ARCH = "glm4-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
        d_ff=13696, vocab=151552,
        qkv_bias=True, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab=512,
        qkv_bias=True, rope_theta=1e4, dtype="float32", remat="none",
    )
