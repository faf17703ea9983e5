"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32L d_model=4096 d_ff=14336 vocab=65536; head dim 64
(64 heads), LoRA-factored decay/token-shift mixers.  Recurrent state =>
``long_500k`` runs (O(1) state per layer).
"""

from ..models.config import ModelConfig, RWKVConfig

ARCH = "rwkv6-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_head=64,
        d_ff=14336, vocab=65536,
        layer_pattern="r",
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk=256),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=160, vocab=512,
        layer_pattern="r",
        rwkv=RWKVConfig(head_dim=16, decay_lora=16, chunk=16),
        dtype="float32", remat="none",
    )
