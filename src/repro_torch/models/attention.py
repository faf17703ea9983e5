"""Attention blocks: GQA + RoPE + window + softcap, prefill and decode.

The port of the JAX package's ``models/attention.py`` on one device.
Both the prefill attention and the decode attention go through
:func:`repro_torch.kernels.flash_attention`: on a CUDA tensor the
hand-written kernel (``kernels/csrc/flash_attention.cu``), on a CPU
tensor its plain version ``kernels.ref.attention_ref``.  The JAX
package's ``dense_attention`` and ``flash_chunked`` forward compute that
one semantics; its custom VJP belongs to training (ROADMAP A13.3), and
its sequence-sharded decode with the log-sum-exp combine comes with
ROADMAP A13.5.3d.  :func:`attn_specs` and :func:`kv_cache_specs` are
the JAX package's (the cache's sequence dim replicated until then).

On a model axis that splits the query heads (a mesh step's body,
``rt.splits(n_heads)``) :func:`attn_apply` runs on the rank's heads and
returns ``wo``'s partial sum, the caller entering and leaving the model
region around it (``repro_torch.models.model``); K5 runs at the local
head counts.  Where the KV heads do not divide over the axis, ``wk``,
``wv`` and their biases stay whole (divide-or-replicate), and the rank
reads the KV heads that its query heads read (query head ``i`` reads
``i // (H / Hkv)``) through :func:`~repro_torch.dist.collectives.model_enter`,
which sums their gradients over the axis.  Where the query heads do not
divide, the block runs whole on every rank.

A KV cache is ``{"k", "v": (B, L, KV, dh), "pos"}``.  ``pos`` is the
number of tokens written so far, kept as an int32 tensor on the host:
it sets the length of the live prefix a decode step attends, a shape, so
the host reads it without waiting on the card.  Prefill and decode write
into the cache's tensors in place and return the same dict.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..dist.collectives import model_enter
from ..dist.sharding import P, Runtime
from ..kernels import flash_attention
from . import common
from .config import ModelConfig


# -----------------------------------------------------------------------------
# Parameter init and specs.
# -----------------------------------------------------------------------------
def attn_init(cfg: ModelConfig, generator: torch.Generator,
              dtype=torch.float32, *, device):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": common.truncnorm((d, h, dh), dtype, generator, device),
        "wk": common.truncnorm((d, kv, dh), dtype, generator, device),
        "wv": common.truncnorm((d, kv, dh), dtype, generator, device),
        "wo": common.truncnorm((h, dh, d), dtype, generator, device,
                               scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, dh), dtype=dtype, device=device)
    return p


def attn_specs(rt: Runtime, cfg: ModelConfig):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = {
        "wq": rt.spec_div(("fsdp", "tp", None), (d, h, dh)),
        "wk": rt.spec_div(("fsdp", "tp", None), (d, kv, dh)),
        "wv": rt.spec_div(("fsdp", "tp", None), (d, kv, dh)),
        "wo": rt.spec_div(("tp", None, "fsdp"), (h, dh, d)),
    }
    if cfg.qkv_bias:
        s["bq"] = rt.spec_div(("tp", None), (h, dh))
        s["bk"] = rt.spec_div(("tp", None), (kv, dh))
        s["bv"] = rt.spec_div(("tp", None), (kv, dh))
    return s


# -----------------------------------------------------------------------------
# Full attention block (projections + rope + residual-ready output).
# -----------------------------------------------------------------------------
def attn_apply(params, cfg: ModelConfig, rt: Runtime, x, rope, *,
               window: int = 0, cache: Optional[dict] = None):
    """x: (B, S, D); ``rope``: :func:`common.rope_tables` of the
    positions (the JAX package passes the positions themselves).
    Returns (out, cache).

    Prefill when ``cache`` is None or S > 1 (a given cache is filled);
    decode when S == 1 and a cache is given.
    """
    s = x.shape[1]
    dt = x.dtype
    if rt.splits(cfg.n_heads):
        params = _local_kv(params, cfg, rt)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = common.apply_rope(q, rope)
    k = common.apply_rope(k, rope)
    scale = float(cfg.d_head) ** -0.5

    if cache is not None and s == 1:
        out, cache = _decode_attend(cfg, rt, q, k, v, cache, window, scale)
        o = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
        return o, cache

    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal,
                          window=window, softcap=cfg.attn_softcap,
                          scale=scale).transpose(1, 2)
    o = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    if cache is not None:  # prefill fill-up
        cache = _fill_cache(rt, cache, k, v, s, window)
    return o, cache


def kv_heads_read(cfg: ModelConfig, rt: Runtime):
    """The KV heads (a list of indices) that the rank's query heads read
    where the query heads split over the model axis and the KV heads do
    not: ``lo .. lo + n - 1`` where each of n heads serves ``H_local /
    n`` consecutive local query heads (a GQA group, or a rank's part of
    one), else one KV head per local query head."""
    h_loc = cfg.n_heads // rt.model_size
    group = cfg.n_heads // cfg.n_kv_heads
    q0 = rt.model_index * h_loc
    idx = [(q0 + i) // group for i in range(h_loc)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if h_loc % n == 0 and idx == [lo + i // (h_loc // n)
                                  for i in range(h_loc)]:
        return list(range(lo, lo + n))
    return idx


def _local_kv(params, cfg: ModelConfig, rt: Runtime):
    """``params`` with whole (replicated) KV projections narrowed to the
    heads the rank reads, through ``model_enter``; as given where the KV
    heads split too."""
    if rt.splits(cfg.n_kv_heads):
        return params
    sel = kv_heads_read(cfg, rt)
    out = dict(params)
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in params:
            w = model_enter(params[name], rt)
            out[name] = w[:, sel] if dim == 1 else w[sel]
    return out


def init_kv_cache(rt: Runtime, cfg: ModelConfig, batch: int, length: int,
                  window: int = 0, dtype=torch.bfloat16, *, device):
    """Cache leaves: k/v (B, L, KV, dh) on ``device``, L = ``length``
    capped at ``window`` when it is positive; pos 0 on the host."""
    l = length if window <= 0 else min(length, window)
    shape = (batch, l, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


def kv_cache_specs(rt: Runtime, cfg: ModelConfig, batch: int, length: int,
                   window: int = 0):
    """The partition specs of :func:`init_kv_cache`'s leaves, the JAX
    package's: the batch over the data axes, L capped at ``window`` and
    at least the model axis' size.  The sequence entry is None; the
    sequence-sharded decode (ROADMAP A13.5.3d) makes it ``"tp"``."""
    l = length if window <= 0 else min(length, window)
    l = max(l, rt.tp_size)
    seq_entry = None
    spec = rt.spec_div(("fsdp", seq_entry, None, None),
                       (batch, l, cfg.n_kv_heads, cfg.d_head))
    return {"k": spec, "v": spec, "pos": P()}


def _fill_cache(rt, cache, k, v, s, window):
    """Prefill: write the first ``s`` slots, or, when the sequence is at
    least as long as the cache, its last L tokens (token ``s - L + j`` in
    slot ``j``)."""
    l = cache["k"].shape[1]
    if s >= l:
        cache["k"].copy_(k[:, s - l:])
        cache["v"].copy_(v[:, s - l:])
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    cache["pos"].fill_(s)
    return cache


def _decode_attend(cfg: ModelConfig, rt: Runtime, q, k_new, v_new, cache,
                   window: int, scale: float):
    """One-token decode over the cache.

    q: (B, 1, H, dh); cache k/v: (B, L, KV, dh).  The new token's k/v is
    written at ``pos % L`` (a ring buffer for windowed layers); then the
    slots ``< min(pos + 1, L)`` are attended, non-causally.  Those are
    exactly the slots the JAX package's ``written``, ``valid`` and
    ``slot`` terms keep on one device.  q and the cache's live prefix go
    to the kernel in the wider of their two dtypes (the JAX package
    computes this attention in f32 either way); the output comes back in
    q's dtype.
    """
    l = cache["k"].shape[1]
    pos = int(cache["pos"])
    slot = pos % l
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    n = min(pos + 1, l)
    dt = torch.promote_types(q.dtype, cache["k"].dtype)
    # The kernel reads (B, KV, n, dh) contiguous: a transposed copy of the
    # live prefix, made in the kernel's wrapper.
    out = flash_attention(q.transpose(1, 2).to(dt),
                          cache["k"][:, :n].transpose(1, 2).to(dt),
                          cache["v"][:, :n].transpose(1, 2).to(dt),
                          causal=False, window=0,
                          softcap=cfg.attn_softcap, scale=scale)
    cache["pos"].add_(1)
    return out.transpose(1, 2).to(q.dtype), cache
