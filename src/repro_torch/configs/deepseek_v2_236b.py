"""deepseek-v2-236b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434] 60L d_model=5120 128H d_ff_expert=1536 vocab=102400;
160 routed experts top-6 + 2 shared; MLA: kv_lora=512, q_lora=1536,
rope_dim=64, nope_dim=128, v_dim=128 (decode caches the 512-d compressed
latent + 64-d rope key instead of full KV).  Simplification vs HF ckpt:
every layer is MoE (the real model's layer 0 is dense) — DESIGN.md §7.
"""

from ..models.config import MLAConfig, ModelConfig, MoEConfig

ARCH = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=192,
        d_ff=1536, vocab=102400,
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                      n_shared=2, d_ff_shared=1536),
        mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64,
                      nope_dim=128, v_dim=128),
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=24,
        d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                      n_shared=1, d_ff_shared=64),
        mla=MLAConfig(q_lora=32, kv_lora=16, rope_dim=8,
                      nope_dim=16, v_dim=16),
        rope_theta=1e4, dtype="float32", remat="none",
    )
