"""Multi-head latent attention (deepseek-v2, arXiv:2405.04434) on one
device.

The port of the JAX package's ``models/mla.py`` without a mesh:

* q: low rank, ``x -> W_DQ (q_lora) -> norm -> W_UQ``, each head's
  ``[nope | rope]``;
* kv: the latent ``x -> W_DKV (kv_lora) -> norm``, which is what the
  cache keeps, expanded by ``W_UKV`` into each head's ``[k_nope | v]``;
* one RoPE key ``x -> W_KR (rope_dim)`` shared by every head.

Prefill and training expand K and V from the latent and run flash
attention (:func:`repro_torch.kernels.flash_attention`: on a CUDA tensor
the hand-written K5 kernel, here with q and k ``nope + rope`` = 192 wide
and v ``v_dim`` = 128 at deepseek-v2's widths; on a CPU tensor its plain
version), then write the latent and the rope key into the cache.

Decode takes the absorbed form of the JAX package's ``_mla_decode``:
q_nope is folded through ``W_UK``, the logits are taken against the
cache's f32 latent and rope key, ``o_lat = softmax . latent`` and ``o =
o_lat W_UV``.  Its query is ``kv_lora + rope_dim`` = 576 wide, beyond
K5's 256, and the JAX package computes it with einsums outside any
Pallas kernel; so does the port, in f32 as there, over the cache's live
prefix (the slots the JAX package's ``written`` mask keeps).

A cache is ``{"latent": (B, L, kv_lora + rope_dim), "pos"}`` with
``pos``, the number of tokens written, an int32 tensor on the host as
:mod:`repro_torch.models.attention` keeps it; prefill and decode write
the latent in place and return the same dict.  :func:`mla_specs` and
:func:`mla_cache_specs` are the JAX package's; the sequence-sharded
decode with its log-sum-exp combine comes with ROADMAP A13.5.3d.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..dist.sharding import P, Runtime
from ..kernels import flash_attention
from . import common
from .config import ModelConfig

__all__ = ["mla_init", "mla_specs", "mla_apply", "init_mla_cache",
           "mla_cache_specs"]


def mla_init(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.float32, *, device):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wdq": common.truncnorm((d, m.q_lora), dtype, generator, device),
        "q_ln": common.rmsnorm_init(m.q_lora, dtype, device=device),
        "wuq": common.truncnorm((m.q_lora, h, m.nope_dim + m.rope_dim),
                                dtype, generator, device),
        "wdkv": common.truncnorm((d, m.kv_lora), dtype, generator, device),
        "kv_ln": common.rmsnorm_init(m.kv_lora, dtype, device=device),
        "wukv": common.truncnorm((m.kv_lora, h, m.nope_dim + m.v_dim),
                                 dtype, generator, device),
        "wkr": common.truncnorm((d, m.rope_dim), dtype, generator, device),
        "wo": common.truncnorm((h, m.v_dim, d), dtype, generator, device,
                               scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def mla_specs(rt: Runtime, cfg: ModelConfig):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wdq": rt.spec_div(("fsdp", "tp"), (d, m.q_lora)),
        "q_ln": common.rmsnorm_specs(rt),
        "wuq": rt.spec_div(("fsdp", "tp", None),
                           (m.q_lora, h, m.nope_dim + m.rope_dim)),
        "wdkv": rt.spec_div(("fsdp", None), (d, m.kv_lora)),
        "kv_ln": common.rmsnorm_specs(rt),
        "wukv": rt.spec_div(("fsdp", "tp", None),
                            (m.kv_lora, h, m.nope_dim + m.v_dim)),
        "wkr": rt.spec_div(("fsdp", None), (d, m.rope_dim)),
        "wo": rt.spec_div(("tp", None, "fsdp"), (h, m.v_dim, d)),
    }


def mla_apply(params, cfg: ModelConfig, rt: Runtime, x, rope, *,
              cache: Optional[dict] = None):
    """x: (B, S, D); ``rope``: :func:`common.rope_tables` of the (B, S)
    positions at ``rope_dim``.  Returns (out, cache): prefill when
    ``cache`` is None or S > 1 (a given cache is filled), the absorbed
    decode when S == 1 and a cache is given."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dt = x.dtype

    cq = common.rmsnorm(params["q_ln"], x @ params["wdq"].to(dt),
                        cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["wuq"].to(dt))
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = common.apply_rope(q_rope, rope)
    latent = common.rmsnorm(params["kv_ln"], x @ params["wdkv"].to(dt),
                            cfg.norm_eps)
    k_rope = common.apply_rope((x @ params["wkr"].to(dt))[:, :, None, :],
                               rope)[:, :, 0]              # (B, S, rope)
    scale = float(m.nope_dim + m.rope_dim) ** -0.5

    if cache is not None and s == 1:
        out, cache = _mla_decode(params, cfg, q_nope, q_rope, latent,
                                 k_rope, cache, scale)
        o = torch.einsum("bshv,hvd->bsd", out, params["wo"].to(dt))
        return o, cache

    kv = torch.einsum("bsr,rhk->bshk", latent, params["wukv"].to(dt))
    k_nope, v = kv[..., :m.nope_dim], kv[..., m.nope_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h,
                                                        m.rope_dim)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(qfull.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal, window=0,
                          softcap=cfg.attn_softcap, scale=scale)
    o = torch.einsum("bhsv,hvd->bsd", out, params["wo"].to(dt))
    if cache is not None:   # prefill fill-up
        n = min(s, cache["latent"].shape[1])
        cache["latent"][:, :n] = torch.cat([latent, k_rope], dim=-1)[:, :n]
        cache["pos"].fill_(s)
    return o, cache


def init_mla_cache(rt: Runtime, cfg: ModelConfig, batch: int, length: int,
                   dtype=torch.bfloat16, *, device):
    """latent (B, L, kv_lora + rope_dim) on ``device``; pos 0 on the
    host."""
    m = cfg.mla
    return {"latent": torch.zeros((batch, length, m.kv_lora + m.rope_dim),
                                  dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32)}


def mla_cache_specs(rt: Runtime, cfg: ModelConfig, batch: int, length: int):
    """The batch over the data axes; the sequence entry None until the
    sequence-sharded decode (ROADMAP A13.5.3d)."""
    m = cfg.mla
    seq_entry = None
    return {"latent": rt.spec_div(("fsdp", seq_entry, None),
                                  (batch, length, m.kv_lora + m.rope_dim)),
            "pos": P()}


def _mla_decode(params, cfg: ModelConfig, q_nope, q_rope, latent, k_rope,
                cache, scale):
    """The absorbed decode of one token against the latent cache:
    ``q_abs[h] = q_nope[h] W_UK[h]^T``, logits ``q_abs . latent + q_rope .
    k_rope`` in f32, ``o_lat = softmax . latent``, ``o[h] = o_lat
    W_UV[h]``.  The new token's entry goes to slot ``pos`` while ``pos <
    L`` (a full cache keeps its slots, as the JAX package's does); the
    slots ``< min(pos + 1, L)`` are attended."""
    m = cfg.mla
    dt = q_nope.dtype
    wuk = params["wukv"][..., :m.nope_dim].to(dt)       # (r, h, nope)
    wuv = params["wukv"][..., m.nope_dim:].to(dt)       # (r, h, v)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, wuk)
    lc = cache["latent"]
    l = lc.shape[1]
    pos = int(cache["pos"])
    if pos < l:
        lc[:, pos] = torch.cat([latent, k_rope], dim=-1)[:, 0]
    live = lc[:, :min(pos + 1, l)].float()
    lat_c, kr_c = live[..., :m.kv_lora], live[..., m.kv_lora:]
    s = (torch.einsum("bshr,bkr->bhsk", q_abs.float(), lat_c)
         + torch.einsum("bshr,bkr->bhsk", q_rope.float(), kr_c)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o_lat = torch.einsum("bhsk,bkr->bhsr", p, lat_c) / p.sum(-1, keepdim=True)
    out = torch.einsum("bhsr,rhv->bshv", o_lat.to(dt), wuv)
    cache["pos"].add_(1)
    return out, cache
