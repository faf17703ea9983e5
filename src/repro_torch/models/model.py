"""Model assembly for the dense attention family on one device.

The port of the JAX package's ``models/model.py`` for the ``g`` (global
attention) and ``l`` (sliding-window attention) blocks: yi-9b, glm4-9b,
qwen2.5-32b and gemma2-27b.  The parameter tree is the JAX package's:
``params["blocks"][str(i)]`` holds unit position ``i``'s parameters
stacked per repeat with a leading ``pattern_repeats`` dimension, and
caches are stacked the same way.

The repeats run as a Python loop over that leading dimension (the JAX
package's ``scan_layers`` is an XLA compile knob; eager PyTorch has no
counterpart).  Each stacked leaf is unbound once a forward, so that its
gradient comes back as one stacked tensor.  ``cfg.remat``: under grad
mode, ``"full"`` runs each unit of the layer pattern (one repeat)
through ``torch.utils.checkpoint`` without saving anything inside it,
the JAX package's ``nothing_saveable`` on its unit; ``"none"`` saves
every activation; ``"dots"`` (matmul outputs saveable) raises, ROADMAP
A13.13.  Without grad the forward is the same either way.

Not ported yet, and raising ``NotImplementedError``: the shared
attention block ``a`` and the Mamba2 blocks ``m`` (zamba2, ROADMAP
A13.9), RWKV blocks ``r`` (A13.10), mixture-of-experts MLPs (A13.7),
multi-head latent attention (A13.8), the audio and vision frontends and
M-RoPE (A13.11).  ``param_specs`` / ``cache_specs`` belong to the mesh
(A13.5).

Public API:
  init_params / init_cache / cast_params
  forward(params, cfg, rt, batch, cache=None)  -> logits (+ cache) + aux
  loss_fn(params, cfg, rt, batch)              -> (loss, {"ce", "aux"})
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..dist.sharding import Runtime
from . import attention as attn_mod
from . import common
from .config import ModelConfig

__all__ = ["check_supported", "init_params", "init_cache", "cast_params",
           "forward", "loss_fn", "AUX_COEF"]

AUX_COEF = 0.01

_BLOCKS = {"a": "the shared attention block (zamba2), ROADMAP A13.9",
           "m": "Mamba2 blocks (zamba2), ROADMAP A13.9",
           "r": "RWKV6 blocks, ROADMAP A13.10"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet,
    naming the ROADMAP item that ports it."""
    missing = [_BLOCKS[ch] for ch in sorted(set(cfg.layer_pattern))
               if ch in _BLOCKS]
    if cfg.moe is not None:
        missing.append("mixture-of-experts MLPs, ROADMAP A13.7")
    if cfg.mla is not None:
        missing.append("multi-head latent attention, ROADMAP A13.8")
    if cfg.frontend is not None or cfg.mrope_sections is not None:
        missing.append("the audio and vision frontends and M-RoPE, "
                       "ROADMAP A13.11")
    if missing:
        raise NotImplementedError(f"{cfg.name}: the port does not run "
                                  + "; ".join(missing) + " yet")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -----------------------------------------------------------------------------
# Init.
# -----------------------------------------------------------------------------
def _block_init(cfg: ModelConfig, generator, dtype, device):
    p = {"ln1": common.rmsnorm_init(cfg.d_model, dtype, device=device),
         "ln2": common.rmsnorm_init(cfg.d_model, dtype, device=device),
         "attn": attn_mod.attn_init(cfg, generator, dtype, device=device),
         "mlp": common.mlp_init(cfg.d_model, cfg.d_ff, generator, dtype,
                                device=device)}
    if cfg.post_norms:
        p["ln1_post"] = common.rmsnorm_init(cfg.d_model, dtype,
                                            device=device)
        p["ln2_post"] = common.rmsnorm_init(cfg.d_model, dtype,
                                            device=device)
    return p


def _stacked(fn, r: int):
    """``fn()``'s tree with every leaf stacked ``r`` times, the draws of
    repeat ``j`` made before those of repeat ``j + 1`` (each leaf is
    allocated once, stacked, and filled a repeat at a time)."""
    first = fn()
    out = _tree_map(lambda t: t.new_empty((r,) + tuple(t.shape)), first)

    def put(dst, src, j):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, j)
            else:
                dst[k][j].copy_(v)

    put(out, first, 0)
    del first
    for j in range(1, r):
        put(out, fn(), j)
    return out


def init_params(cfg: ModelConfig, rt: Runtime, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (``cuda``
    without a card raises), drawn from ``generator`` (which lives on
    ``device``) in a fixed order: the embedding, each unit position's
    repeats, the LM head.  The tree, its shapes and dtypes are the JAX
    package's; its values are not."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = common.dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": common.embed_init(cfg.vocab, cfg.d_model, generator, dtype,
                                   device=device)}
    params["blocks"] = {
        str(i): _stacked(lambda: _block_init(cfg, generator, dtype, device),
                         cfg.pattern_repeats)
        for i in range(len(cfg.layer_pattern))}
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype,
                                               device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": common.truncnorm(
            (cfg.d_model, cfg.vocab), dtype, generator, device)}
    return params


def cast_params(params, cfg: ModelConfig, device=None):
    """The tree with every weight that the forward casts to ``cfg.dtype``
    at its use cast once, on ``device`` (the params' own by default); the
    norms' scales, which the forward reads in f32, keep their dtype.  The
    forward on the result gives the same bits as on ``params``."""
    dt = common.dtype_of(cfg.dtype)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(device or v.device,
                              v.dtype if k == "scale" else dt))
                for k, v in tree.items()}
    return cast(params)


# -----------------------------------------------------------------------------
# Caches.
# -----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, rt: Runtime, batch: int, length: int,
               dtype=torch.bfloat16, *, device):
    """One KV cache per unit position, stacked per repeat: k/v (R, B, L,
    KV, dh) on ``device`` (``cuda`` without a card raises), L capped at
    ``cfg.window`` for ``l`` blocks; pos (R,) on the host."""
    r = cfg.pattern_repeats
    device = resolve_device(device)
    out = {}
    for i, ch in enumerate(cfg.layer_pattern):
        window = cfg.window if ch == "l" else 0
        one = attn_mod.init_kv_cache(rt, cfg, batch, length, window, dtype,
                                     device=device)
        out[str(i)] = _tree_map(
            lambda x: x[None].repeat((r,) + (1,) * x.ndim), one)
    return out


# -----------------------------------------------------------------------------
# Forward.
# -----------------------------------------------------------------------------
def _apply_block(bp, cfg: ModelConfig, rt: Runtime, char: str, x, rope,
                 cache):
    """One ``g`` or ``l`` block; returns (x, cache)."""
    h = common.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    window = cfg.window if char == "l" and cfg.window > 0 else 0
    h, cache = attn_mod.attn_apply(bp["attn"], cfg, rt, h, rope,
                                   window=window, cache=cache)
    if cfg.post_norms:
        h = common.rmsnorm(bp["ln1_post"], h, cfg.norm_eps)
    x = x + h
    h = common.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    h = common.mlp_apply(bp["mlp"], h)
    if cfg.post_norms:
        h = common.rmsnorm(bp["ln2_post"], h, cfg.norm_eps)
    return x + h, cache


def forward(params, cfg: ModelConfig, rt: Runtime, batch: Dict[str, Any],
            cache: Optional[dict] = None):
    """Logits (B, S, V) in ``cfg.dtype`` and the f32 auxiliary loss (0:
    no experts); with a cache, ``(logits, cache, aux)``, the cache
    updated in place.  ``batch["tokens"]`` (B, S) lies on the params'
    device; ``batch["positions"]`` (B, S) is optional."""
    check_supported(cfg)
    dt = common.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    # Gather, then cast: the same bits as the JAX package's cast table.
    x = params["embed"]["tok"][tokens].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model) ** 0.5, dtype=dt)

    if "positions" in batch:
        positions = batch["positions"]
    else:
        b, s = tokens.shape
        if cache is not None and s == 1:
            # The first cache leaf that has a pos: every block's is the same.
            pos0 = int(cache["0"]["pos"][0])
            positions = torch.full((b, 1), pos0, dtype=torch.int32,
                                   device=x.device)
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
    rope = common.rope_tables(positions, cfg.d_head, cfg.rope_theta,
                              cfg.mrope_sections)

    unit = cfg.layer_pattern
    r = cfg.pattern_repeats
    # Each stacked leaf as r views, taken once: their gradients return to
    # the (R, ...) leaf as one stacked tensor.
    blocks = {i: _tree_map(lambda p: torch.unbind(p, 0),
                           params["blocks"][str(i)])
              for i in range(len(unit))}
    remat = torch.is_grad_enabled() and cfg.remat != "none"
    if remat and cfg.remat != "full":
        raise NotImplementedError(
            f"{cfg.name}: remat={cfg.remat!r} (matmul outputs saveable) is "
            "not ported; ROADMAP A13.13.  Use 'full' or 'none'")

    def unit_body(x, j):
        for i, ch in enumerate(unit):
            bp = _tree_map(lambda views: views[j], blocks[i])
            c = (_tree_map(lambda t: t[j], cache[str(i)])
                 if cache is not None else None)
            x, _ = _apply_block(bp, cfg, rt, ch, x, rope, c)
        return x

    for j in range(r):
        if remat:
            x = checkpoint(unit_body, x, j, use_reentrant=False)
        else:
            x = unit_body(x, j)

    x = common.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x,
                              params["embed"]["tok"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              params["lm_head"]["w"].to(x.dtype))
    if logits.dtype == torch.bfloat16:
        logits = common.cast_cotangent_bf16(logits)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is not None:
        return logits, cache, aux
    return logits, aux


def loss_fn(params, cfg: ModelConfig, rt: Runtime, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss: next-token cross-entropy (f32, final softcap
    applied) over the batch's tokens shifted by one, plus ``AUX_COEF``
    times the auxiliary loss; returns ``(total, {"ce", "aux"})``."""
    logits, aux = forward(params, cfg, rt, batch)
    labels = batch["labels"]
    if cfg.causal and cfg.frontend is None:
        loss = common.cross_entropy(logits[:, :-1], labels[:, 1:],
                                    cfg.final_softcap)
    else:
        loss = common.cross_entropy(logits, labels, cfg.final_softcap)
    total = loss + AUX_COEF * aux
    return total, {"ce": loss, "aux": aux}
