"""Shared model components: norms, RoPE, gated MLPs, embeddings, init.

The port of the JAX package's ``models/common.py``.  Parameters are plain
nested dicts of tensors, as there.  Every init function takes ``device``
without a default and draws from an explicit ``torch.Generator`` that
lives on that device.

Left out: M-RoPE (qwen2-vl's sections) raises until the frontends' slice
(ROADMAP A13.11); the ``*_specs`` builders belong to the mesh (ROADMAP
A13.5).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def truncnorm(shape, dtype, generator: torch.Generator, device,
              scale: float = 0.02) -> torch.Tensor:
    """Normal draws of std ``scale`` truncated at +-2 ``scale``, with no
    variance correction (so the sample std is 0.8796 ``scale``), as the
    JAX package's ``truncated_normal`` initializer; not its bits."""
    t = torch.empty(shape, dtype=dtype, device=device)
    return torch.nn.init.trunc_normal_(t, std=scale, a=-2.0 * scale,
                                       b=2.0 * scale, generator=generator)


# ---- RMSNorm -----------------------------------------------------------------
def rmsnorm_init(d: int, dtype=torch.float32, *, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMS-normalise the last axis in f32 and scale by ``1 + scale``."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


# ---- RoPE --------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def rope_tables(positions: torch.Tensor, d_head: int, theta: float,
                sections: Optional[Tuple[int, int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (cos, sin), each (B, S, 1, D/2), of (B, S) positions: made
    once per forward and shared by every layer's q and k."""
    if sections is not None:
        raise NotImplementedError("M-RoPE (qwen2-vl) comes with the "
                                  "frontends' slice, ROADMAP A13.11")
    ang = positions[..., None].float() * rope_freqs(d_head, theta,
                                                    positions.device)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """Rotate (B, S, H, D) by :func:`rope_tables`' (cos, sin): split-half
    rotation in f32, then a cast back to x's dtype.  The JAX package's
    ``apply_rope(x, positions, theta)`` is ``apply_rope(x,
    rope_tables(positions, D, theta))``."""
    cos, sin = rope
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---- Gated MLP (SwiGLU) -------------------------------------------------------
def mlp_init(d: int, f: int, generator: torch.Generator, dtype=torch.float32,
             *, device):
    return {
        "wi": truncnorm((d, 2, f), dtype, generator, device),  # [gate; up]
        "wo": truncnorm((f, d), dtype, generator, device,
                        scale=0.02 / math.sqrt(2)),
    }


def mlp_apply(params, x):
    """SwiGLU: ``silu(x wi_gate) * (x wi_up)``, then ``wo`` (the JAX
    package's default ``act``, the only one its dense blocks use)."""
    dt = x.dtype
    h = torch.einsum("bsd,dcf->bscf", x, params["wi"].to(dt))
    gate, up = h[:, :, 0], h[:, :, 1]
    return torch.einsum("bsf,fd->bsd", F.silu(gate) * up, params["wo"].to(dt))


class _CastGradBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def cast_cotangent_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward casts the cotangent to bf16 (the JAX
    package's ``cast_cotangent_bf16``): placed at the logits, the loss
    math stays f32 while the gradient flowing back through the layers is
    bf16."""
    return _CastGradBf16.apply(x)


# ---- Embedding / unembedding ---------------------------------------------------
def embed_init(vocab: int, d: int, generator: torch.Generator,
               dtype=torch.float32, *, device):
    return {"tok": truncnorm((vocab, d), dtype, generator, device)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  softcap: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32 (with optional final logit softcap)."""
    lf = logits.float()
    if softcap > 0:
        lf = softcap * torch.tanh(lf / softcap)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)
