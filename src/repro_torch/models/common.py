"""Shared model components: norms, RoPE, gated MLPs, embeddings, init.

The port of the JAX package's ``models/common.py``.  Parameters are plain
nested dicts of tensors, as there.  Every init function takes ``device``
without a default and draws from an explicit ``torch.Generator`` that
lives on that device.  The dense family's ``*_specs`` builders give
each init's partition-spec tree under a
:class:`~repro_torch.dist.sharding.Runtime`, the JAX package's specs
(compared by ``tuple``).

On a model axis (a mesh step's body, ``rt.model_size > 1``) the
functions run on the rank's slices: :func:`mlp_apply` on its slice of
the FFN width, returning a partial sum; :func:`embed_lookup` on its
slice of the vocabulary, ids outside it reading zeros, summed over the
axis; :func:`cross_entropy` on its slice of the logits, with the max,
the sum of exponentials and the gold logit reduced over the axis (the
logits themselves never cross it).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.collectives import all_reduce, model_leave
from ..dist.sharding import Runtime

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


def rmsnorm_specs(rt: Runtime):
    return {"scale": rt.spec(None)}


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
    once per forward and shared by every layer's q and k.

    With ``sections`` (M-RoPE, qwen2-vl's temporal, height and width
    parts of the half dimension) ``positions`` is (3, B, S): each section
    of the frequencies is multiplied by its own position row, and the
    sections are concatenated, as the JAX package's ``apply_rope``.  A
    section past the D/2 frequencies takes what is left of them (none at
    the smoke config's (4, 6, 6) over D/2 = 8), as the slices there do.
    """
    freqs = rope_freqs(d_head, theta, positions.device)
    if sections is None:
        ang = positions[..., None].float() * freqs
    else:
        if positions.ndim != 3 or positions.shape[0] != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        parts, start = [], 0
        for sec, pos in zip(sections, positions):
            parts.append(pos[..., None].float() * freqs[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)
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


def mlp_specs(rt: Runtime, d: int, f: int):
    return {"wi": rt.spec_div(("fsdp", None, "tp"), (d, 2, f)),
            "wo": rt.spec_div(("tp", "fsdp"), (f, d))}


def mlp_apply(params, x):
    """SwiGLU: ``silu(x wi_gate) * (x wi_up)``, then ``wo`` (the JAX
    package's default ``act``, the only one its dense blocks use).  On
    the rank's slice of the width (``wi``'s last dim, ``wo``'s first)
    the result is the rank's partial sum."""
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


def embed_specs(rt: Runtime, vocab: int, d: int):
    if rt.tp_size > 1:
        return {"tok": rt.spec_div(("tp", "fsdp"), (vocab, d))}
    # pure FSDP: shard d, so that the row gather is shard-local
    return {"tok": rt.spec_div((None, "fsdp"), (vocab, d))}


def _vocab_slice(rt: Runtime, ids: torch.Tensor, v_local: int):
    """(ids inside the rank's slice of the vocabulary, their offsets in
    it, clamped into range)."""
    idx = ids.long() - rt.model_index * v_local
    inside = (idx >= 0) & (idx < v_local)
    return inside, idx.clamp(0, v_local - 1)


def embed_lookup(params, tokens: torch.Tensor, dtype,
                 rt: Optional[Runtime] = None) -> torch.Tensor:
    """The rows of ``params["tok"]`` for ``tokens``, cast to ``dtype``
    (gather, then cast: the bits of the JAX package's cast table).  With
    ``rt`` (a body whose model axis splits the vocabulary) the table is
    the rank's slice: ids outside it read zeros, and the rows are summed
    over the axis."""
    tok = params["tok"]
    if rt is None:
        return tok[tokens].to(dtype)
    inside, idx = _vocab_slice(rt, tokens, tok.shape[0])
    x = torch.where(inside[..., None], tok[idx].to(dtype),
                    torch.zeros((), dtype=dtype, device=tok.device))
    return model_leave(x, rt)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  softcap: float = 0.0,
                  rt: Optional[Runtime] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32 (with optional final logit
    softcap).  With ``rt`` (a body whose model axis splits the
    vocabulary) ``logits`` are the rank's slice of it: the max over the
    vocabulary, then the sum of exponentials and the gold logit (from
    the rank that owns the label) are reduced over the axis."""
    lf = logits.float()
    if softcap > 0:
        lf = softcap * torch.tanh(lf / softcap)
    if rt is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        return torch.mean(lse - gold)
    m = all_reduce(lf.detach().amax(dim=-1), rt.model_group, rt.model_wire,
                   op="max")
    sum_exp = torch.exp(lf - m[..., None]).sum(dim=-1)
    inside, idx = _vocab_slice(rt, labels, lf.shape[-1])
    gold = torch.where(inside, torch.gather(lf, -1, idx[..., None])[..., 0],
                       torch.zeros((), dtype=lf.dtype, device=lf.device))
    sum_exp, gold = model_leave(torch.stack([sum_exp, gold]), rt)
    return torch.mean(torch.log(sum_exp) + m - gold)
