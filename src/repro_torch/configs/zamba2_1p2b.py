"""zamba2-1.2b — Mamba2 backbone + *shared* attention block.

[arXiv:2411.15242] 38L d_model=2048, ssm_state=64; the attention+MLP block
(32H kv=32, d_ff=8192) has ONE weight set reused at interleave points
(Zamba2's parameter-sharing trick).  Here: unit = 18 Mamba2 blocks + 1
shared-attention application, ×2 repeats = 38 layers.  The shared block
uses a 4096 sliding window so state stays O(window) — this is what makes
``long_500k`` runnable (recorded in DESIGN.md §Arch-applicability).
"""

from ..models.config import ModelConfig, SSMConfig

ARCH = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
        d_ff=8192, vocab=32000,
        layer_pattern="m" * 18 + "a", window=4096,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=192, vocab=512,
        layer_pattern="mmma", window=16,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
        rope_theta=1e4, dtype="float32", remat="none",
    )
