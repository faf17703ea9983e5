"""olmoe-1b-7b — fully-open MoE, 64 experts top-8, no shared experts.

[arXiv:2409.02060] 16L d_model=2048 16H (kv=16) d_ff_expert=1024
vocab=50304.
"""

from ..models.config import ModelConfig, MoEConfig

ARCH = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1024, vocab=50304,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
        rope_theta=1e4, dtype="float32", remat="none",
    )
