"""qwen2-vl-7b — VLM decoder backbone with M-RoPE.

[arXiv:2409.12191] 28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064;
M-RoPE splits the 128-d rotary dim into (temporal, h, w) = (16, 24, 24)
sections.  The vision tower is a STUB per the task spec: ``input_specs``
supplies fused patch/text embeddings (1280-d, the ViT hidden size); the
backbone projects and decodes.  Dynamic resolution shows up only as the
sequence length of the supplied embeddings.
"""

from ..models.config import ModelConfig

ARCH = "qwen2-vl-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
        d_ff=18944, vocab=152064,
        qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        frontend="vision", frontend_dim=1280,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab=512,
        qkv_bias=True, rope_theta=1e6,
        mrope_sections=(4, 6, 6),
        frontend="vision", frontend_dim=32,
        dtype="float32", remat="none",
    )
