"""Model configuration for the unified LM substrate (a copy of the JAX
package's ``models/config.py``).

One :class:`ModelConfig` describes every assigned architecture; the block
stack is a repeating ``layer_pattern`` unit over block kinds:

  * ``g`` — global (full) attention block
  * ``l`` — local sliding-window attention block (gemma2)
  * ``a`` — *shared* attention block (zamba2: one weight set reused)
  * ``m`` — Mamba2 (SSD) block
  * ``r`` — RWKV6 (Finch) block

``n_layers`` must be divisible by ``len(layer_pattern)``; the stack runs
``n_layers / len(pattern)`` repetitions of the unit.  ``remat`` and
``scan_layers`` are the JAX package's compile knobs, kept so that the two
packages share one configuration; the port's eager forward reads neither.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # per shared expert (dsv2: == d_ff_expert)
    router_scale: bool = True     # normalise top-k weights
    capacity_factor: float = 1.25  # only used by the capacity fallback path


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    layer_pattern: str = "g"
    causal: bool = True
    rope_theta: float = 1e6
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 4096              # for 'l' blocks
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    post_norms: bool = False        # gemma2 post-block norms
    embed_scale: bool = False       # gemma2 sqrt(d) embedding scaling
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    frontend: Optional[str] = None  # None | 'audio' | 'vision'
    frontend_dim: int = 0           # stub input embedding dim

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"         # compute/activation dtype
    param_dtype: str = "float32"

    remat: str = "full"             # none | dots | full
    scan_layers: bool = True

    def __post_init__(self):
        assert self.n_layers % len(self.layer_pattern) == 0, (
            self.name, self.n_layers, self.layer_pattern)
        if "m" in self.layer_pattern:
            assert self.ssm is not None
        if "r" in self.layer_pattern:
            assert self.rwkv is not None
        if self.family == "moe":
            assert self.moe is not None

    @property
    def pattern_repeats(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm.head_dim if self.ssm else 0

    @property
    def decoder(self) -> bool:
        """Whether the arch has an autoregressive decode step."""
        return self.causal

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, f, v, h, kv, dh = (self.d_model, self.d_ff, self.vocab,
                              self.n_heads, self.n_kv_heads, self.d_head)
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += d * v
        per_unit = 0
        for ch in self.layer_pattern:
            if ch in ("g", "l"):
                if self.mla:
                    m = self.mla
                    per_unit += d * m.q_lora + m.q_lora * h * (m.nope_dim + m.rope_dim)
                    per_unit += d * m.kv_lora + m.kv_lora * h * (m.nope_dim + m.v_dim)
                    per_unit += d * m.rope_dim + h * m.v_dim * d
                else:
                    per_unit += d * (h + 2 * kv) * dh + h * dh * d
                if self.moe is not None:
                    per_unit += d * self.moe.n_experts
                    per_unit += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                    per_unit += self.moe.n_shared * 3 * d * self.moe.d_ff_shared
                else:
                    per_unit += 3 * d * f
            elif ch == "a":  # shared attention: counted once below
                pass
            elif ch == "m":
                s = self.ssm
                din = self.d_inner_ssm
                nh = self.n_ssm_heads
                per_unit += d * (2 * din + 2 * s.d_state + nh)
                per_unit += din * d + 3 * nh
            elif ch == "r":
                per_unit += 5 * d * d + 2 * d * self.rwkv.decay_lora  # time mix
                per_unit += 2 * d * f + d * d                          # channel mix
        total += per_unit * self.pattern_repeats
        if "a" in self.layer_pattern:
            total += d * (h + 2 * kv) * dh + h * dh * d + 3 * d * f
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return int(self.param_count() - inactive * self._n_moe_layers())

    def _n_moe_layers(self) -> int:
        return sum(1 for ch in self.layer_pattern if ch in "gl") * self.pattern_repeats
