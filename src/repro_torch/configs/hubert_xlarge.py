"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).

[arXiv:2106.07447] 48L d_model=1280 16H (kv=16) d_ff=5120, 504 cluster
targets.  The conv waveform frontend is a STUB per the task spec:
``input_specs`` supplies precomputed frame embeddings (512-d, the conv
extractor's output dim); the backbone projects and encodes them.
Bidirectional (``causal=False``) => no decode shapes.
"""

from ..models.config import ModelConfig

ARCH = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
        d_ff=5120, vocab=504,
        causal=False, frontend="audio", frontend_dim=512, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=160, vocab=64,
        causal=False, frontend="audio", frontend_dim=32,
        rope_theta=1e4, dtype="float32", remat="none",
    )
