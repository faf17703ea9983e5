"""gemma2-27b — dense decoder with local/global alternation + softcaps.

[arXiv:2408.00118] 46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000;
sliding window 4096 on local layers, attn softcap 50, final softcap 30,
post-block RMSNorms, sqrt(d) embedding scaling.  Layer pattern 'lg'
(local, global) × 23.
"""

from ..models.config import ModelConfig

ARCH = "gemma2-27b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
        d_ff=36864, vocab=256000,
        layer_pattern="lg", window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, embed_scale=True, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=192, vocab=512,
        layer_pattern="lg", window=16,
        attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, embed_scale=True, rope_theta=1e4,
        dtype="float32", remat="none",
    )
