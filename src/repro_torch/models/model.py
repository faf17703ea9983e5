"""Model assembly on one device.

The port of the JAX package's ``models/model.py`` for every block kind:
``g`` (global attention) and ``l`` (sliding-window attention) blocks, the
dense GQA family (yi-9b, glm4-9b, qwen2.5-32b, gemma2-27b) and the
mixture-of-experts family (olmoe-1b-7b; deepseek-v2-236b, whose blocks
take multi-head latent attention, ``models/mla.py``, and experts,
``models/moe.py``); the Mamba2 blocks ``m`` (``models/ssm.py``) and the
shared attention block ``a`` of zamba2; the RWKV6 blocks ``r``
(``models/rwkv.py``) of rwkv6-7b.  The parameter tree is the JAX
package's: ``params["blocks"][str(i)]`` holds unit position ``i``'s
parameters stacked per repeat with a leading ``pattern_repeats``
dimension (empty for an ``a`` position), ``params["shared_attn"]`` the
one weight set that every ``a`` block of every repeat applies (its
gradient sums over them), and caches are stacked per repeat the same
way (an ``a`` block's KV cache is its repeat's own).

The repeats run as a Python loop over that leading dimension (the JAX
package's ``scan_layers`` is an XLA compile knob; eager PyTorch has no
counterpart).  Each stacked leaf is unbound once a forward, so that its
gradient comes back as one stacked tensor.  ``cfg.remat``: under grad
mode, ``"full"`` runs each unit of the layer pattern (one repeat)
through ``torch.utils.checkpoint`` without saving anything inside it,
the JAX package's ``nothing_saveable`` on its unit, and, where the
pattern is longer than 2 blocks (zamba2's 19), each block through a
checkpoint of its own inside the unit's, as there: the unit's recompute
then keeps one block's internals at a time; ``"dots"`` runs the unit
through a selective checkpoint that saves the outputs of the weight
products (:func:`_dots_policy`) and recomputes the rest, with the same
per-block checkpoints inside as ``"full"``; ``"none"`` saves every
activation.  Without grad the forward is the same either way, and every
policy gives the same bits.  The experts' load-balance loss of each
block is summed over a unit (also out of the checkpointed unit, so that
its gradient survives the recompute) and over the repeats; the forward
returns that sum, 0 without experts.

Frontends (qwen2-vl-7b's vision, hubert-xlarge's audio): the model
takes ``batch["embeds"]`` (B, S, ``frontend_dim``), the stubbed tower's
patch or frame embeddings, through ``params["frontend"]["proj"]``
instead of the token table.  qwen2-vl keeps a token table
``params["embed"]`` that the forward never reads (the JAX package draws
it too); hubert has none.  qwen2-vl's M-RoPE takes (3, B, S) positions,
or broadcasts (B, S) ones to its three sections.

``param_specs`` and ``cache_specs`` are the JAX package's partition-spec
trees for every config, with a stacked leaf's repeat dim replicated; the
experts' under ``moe_mode="tp"`` (expert parallelism comes with ROADMAP
A13.5.3c) and the caches' sequence dims replicated (the
sequence-sharded decode comes with A13.5.3d).

Tensor parallelism (a mesh step's body on a model axis above 1, ROADMAP
A13.5.3b; the ``g`` and ``l`` blocks, dense or with experts, and the
frontends): the parameters are the rank's model-axis slices under
``param_specs``, and each dimension that the divide-or-replicate rule
splits (``rt.splits``) runs as a model region.  The token table is
looked up vocab-parallel; a frontend's projection, split on ``d``, is
all-gathered on ``d``; attention (on the rank's heads) and the MLP (on
its slice of the width) enter their region and leave it summed; the
experts handle their own region (``models/moe.py``); the LM head
(``lm_head`` or the tied table, split on the vocabulary) gives the
rank's slice of the logits, which :func:`loss_fn`'s cross-entropy reads
vocab-parallel.  Under ``rt.sequence_parallel``, where the model axis
divides S (else as without it, as the JAX package falls back), the
residual stream between blocks is the rank's S / tp rows: the norms run
on the rows (their scales entering the region, since each rank's
gradient of them is its rows' part), the sequence is all-gathered at a
block's body and its summed output sliced back to the rows.

Public API:
  init_params / param_specs / init_cache / cache_specs / cast_params
  forward(params, cfg, rt, batch, cache=None)  -> logits (+ cache) + aux
  loss_fn(params, cfg, rt, batch)              -> (loss, {"ce", "aux"})
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..dist.collectives import (model_enter, model_gather, model_leave,
                                model_split)
from ..dist.sharding import P, Runtime
from . import attention as attn_mod
from . import common, mla, moe, rwkv, ssm
from .config import ModelConfig

__all__ = ["init_params", "param_specs", "init_cache", "cache_specs",
           "cast_params", "forward", "loss_fn", "AUX_COEF",
           "check_model_axis"]

AUX_COEF = 0.01

# Leaves that the forward reads in f32 whatever the compute dtype: the
# norms' scales, the SSM's decay, step bias and skip, RWKV6's decay base
# and bonus.  ``cast_params`` keeps their dtype.
_F32_LEAVES = frozenset({"scale", "A_log", "dt_bias", "D", "w0", "u"})


def check_model_axis(cfg: ModelConfig, tp_size: int) -> None:
    """Raise where ``cfg`` has no model-axis body yet and ``tp_size`` is
    above 1: multi-head latent attention, Mamba2 (zamba2's shared block
    with it) and RWKV6 blocks (ROADMAP A13.5.3e)."""
    if tp_size > 1 and (cfg.mla is not None
                        or any(ch in "mar" for ch in cfg.layer_pattern)):
        raise NotImplementedError(
            f"{cfg.name} on a model axis of {tp_size}: the model-axis "
            "bodies of MLA, Mamba2 and RWKV6 blocks come with ROADMAP "
            "A13.5.3e; fold the model axis into the data axes "
            "(tp_disabled=True) to train it data parallel")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -----------------------------------------------------------------------------
# Init.
# -----------------------------------------------------------------------------
def _block_init(cfg: ModelConfig, char: str, generator, dtype, device):
    def norm():
        return common.rmsnorm_init(cfg.d_model, dtype, device=device)
    if char == "a":
        return {}  # the shared weights live outside the stacked blocks
    if char == "m":
        return {"ln1": norm(),
                "ssm": ssm.ssm_init(cfg, generator, dtype, device=device)}
    if char == "r":
        return {"ln1": norm(), "ln2": norm(),
                "rwkv": rwkv.rwkv_init(cfg, generator, dtype,
                                       device=device)}
    p = {"ln1": norm(), "ln2": norm()}
    if cfg.mla is not None:
        p["attn"] = mla.mla_init(cfg, generator, dtype, device=device)
    else:
        p["attn"] = attn_mod.attn_init(cfg, generator, dtype, device=device)
    if cfg.moe is not None:
        p["moe"] = moe.moe_init(cfg, generator, dtype, device=device)
    else:
        p["mlp"] = common.mlp_init(cfg.d_model, cfg.d_ff, generator, dtype,
                                   device=device)
    if cfg.post_norms:
        p["ln1_post"] = norm()
        p["ln2_post"] = norm()
    return p


def _shared_block_init(cfg: ModelConfig, generator, dtype, device):
    """zamba2's shared attention block: norms, GQA attention, SwiGLU."""
    return {"ln1": common.rmsnorm_init(cfg.d_model, dtype, device=device),
            "attn": attn_mod.attn_init(cfg, generator, dtype, device=device),
            "ln2": common.rmsnorm_init(cfg.d_model, dtype, device=device),
            "mlp": common.mlp_init(cfg.d_model, cfg.d_ff, generator, dtype,
                                   device=device)}


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
    ``device``) in a fixed order: a frontend's projection, the token
    embedding (none for the audio frontend), each unit position's
    repeats, the shared attention block (zamba2), the LM head.  The
    tree, its shapes and dtypes are the JAX package's; its values are
    not."""
    device = resolve_device(device)
    dtype = common.dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {}
    if cfg.frontend is not None:
        params["frontend"] = {"proj": common.truncnorm(
            (cfg.frontend_dim, cfg.d_model), dtype, generator, device)}
    if cfg.frontend in (None, "vision"):
        params["embed"] = common.embed_init(cfg.vocab, cfg.d_model,
                                            generator, dtype, device=device)
    params["blocks"] = {
        str(i): _stacked(lambda ch=ch: _block_init(cfg, ch, generator, dtype,
                                                   device),
                         cfg.pattern_repeats)
        for i, ch in enumerate(cfg.layer_pattern)}
    if "a" in cfg.layer_pattern:
        params["shared_attn"] = _shared_block_init(cfg, generator, dtype,
                                                   device)
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype,
                                               device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": common.truncnorm(
            (cfg.d_model, cfg.vocab), dtype, generator, device)}
    return params


def _block_specs(rt: Runtime, cfg: ModelConfig, char: str):
    if char == "a":
        return {}   # the shared weights' specs are their own
    if char == "m":
        return {"ln1": common.rmsnorm_specs(rt),
                "ssm": ssm.ssm_specs(rt, cfg)}
    if char == "r":
        return {"ln1": common.rmsnorm_specs(rt),
                "ln2": common.rmsnorm_specs(rt),
                "rwkv": rwkv.rwkv_specs(rt, cfg)}
    s = {"ln1": common.rmsnorm_specs(rt), "ln2": common.rmsnorm_specs(rt),
         "attn": (mla.mla_specs(rt, cfg) if cfg.mla is not None
                  else attn_mod.attn_specs(rt, cfg))}
    if cfg.moe is not None:
        s["moe"] = moe.moe_specs(rt, cfg)
    else:
        s["mlp"] = common.mlp_specs(rt, cfg.d_model, cfg.d_ff)
    if cfg.post_norms:
        s["ln1_post"] = common.rmsnorm_specs(rt)
        s["ln2_post"] = common.rmsnorm_specs(rt)
    return s


def _shared_block_specs(rt: Runtime, cfg: ModelConfig):
    return {"ln1": common.rmsnorm_specs(rt),
            "attn": attn_mod.attn_specs(rt, cfg),
            "ln2": common.rmsnorm_specs(rt),
            "mlp": common.mlp_specs(rt, cfg.d_model, cfg.d_ff)}


def _stack_specs(tree):
    """A stacked tree's specs: the leading repeat dim replicated."""
    return _tree_map(lambda s: P(None, *s), tree)


def param_specs(cfg: ModelConfig, rt: Runtime) -> Dict[str, Any]:
    """The partition spec of every leaf of ``init_params``' tree under
    ``rt`` (the JAX package's; a stacked block leaf's leading repeat dim
    is replicated)."""
    specs: Dict[str, Any] = {}
    if cfg.frontend is not None:
        specs["frontend"] = {
            "proj": rt.spec_div(("fsdp", "tp"),
                                (cfg.frontend_dim, cfg.d_model))}
    if cfg.frontend in (None, "vision"):
        specs["embed"] = common.embed_specs(rt, cfg.vocab, cfg.d_model)

    specs["blocks"] = {str(i): _stack_specs(_block_specs(rt, cfg, ch))
                       for i, ch in enumerate(cfg.layer_pattern)}
    if "a" in cfg.layer_pattern:
        specs["shared_attn"] = _shared_block_specs(rt, cfg)
    specs["final_norm"] = common.rmsnorm_specs(rt)
    if not cfg.tie_embeddings:
        head = ("fsdp", "tp") if rt.tp_size > 1 else (None, "fsdp")
        specs["lm_head"] = {"w": rt.spec_div(head, (cfg.d_model, cfg.vocab))}
    return specs


def cast_params(params, cfg: ModelConfig, device=None):
    """The tree with every weight that the forward casts to ``cfg.dtype``
    at its use cast once, on ``device`` (the params' own by default); the
    leaves that the forward reads in f32 (the norms' scales, the SSM's
    ``A_log``, ``dt_bias`` and ``D``, RWKV6's ``w0`` and ``u``) keep
    their dtype.  The forward on the result gives the same bits as on
    ``params``."""
    dt = common.dtype_of(cfg.dtype)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(device or v.device,
                              v.dtype if k in _F32_LEAVES else dt))
                for k, v in tree.items()}
    return cast(params)


# -----------------------------------------------------------------------------
# Caches.
# -----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, rt: Runtime, batch: int, length: int,
               dtype=torch.bfloat16, *, device):
    """One cache per unit position, stacked per repeat, on ``device``
    (``cuda`` without a card raises): k/v (R, B, L, KV, dh), L capped at
    ``cfg.window`` for ``l`` and ``a`` blocks, or under multi-head latent
    attention the latent (R, B, L, kv_lora + rope_dim) of a ``g`` block,
    with pos (R,) on the host; an ``m`` block's f32 SSM state and conv
    window, an ``r`` block's f32 state and boundary tokens (no pos; the
    JAX package makes both in f32 whatever ``dtype``)."""
    r = cfg.pattern_repeats
    device = resolve_device(device)
    out = {}
    for i, ch in enumerate(cfg.layer_pattern):
        if ch == "g" and cfg.mla is not None:
            one = mla.init_mla_cache(rt, cfg, batch, length, dtype,
                                     device=device)
        elif ch == "m":
            one = ssm.init_ssm_cache(rt, cfg, batch, device=device)
        elif ch == "r":
            one = rwkv.init_rwkv_cache(rt, cfg, batch, device=device)
        else:
            window = cfg.window if ch in ("l", "a") else 0
            one = attn_mod.init_kv_cache(rt, cfg, batch, length, window,
                                         dtype, device=device)
        out[str(i)] = _tree_map(
            lambda x: x[None].repeat((r,) + (1,) * x.ndim), one)
    return out


def _block_cache_specs(rt: Runtime, cfg: ModelConfig, char: str, batch: int,
                       length: int):
    if char == "g" and cfg.mla is not None:
        return mla.mla_cache_specs(rt, cfg, batch, length)
    if char == "m":
        return ssm.ssm_cache_specs(rt, cfg, batch)
    if char == "r":
        return rwkv.rwkv_cache_specs(rt, cfg, batch)
    window = cfg.window if char in ("l", "a") else 0
    return attn_mod.kv_cache_specs(rt, cfg, batch, length, window)


def cache_specs(cfg: ModelConfig, rt: Runtime, batch: int, length: int):
    """The partition spec of every leaf of ``init_cache``'s tree under
    ``rt`` (the JAX package's; the leading repeat dim replicated)."""
    return {str(i): _stack_specs(_block_cache_specs(rt, cfg, ch, batch,
                                                    length))
            for i, ch in enumerate(cfg.layer_pattern)}


# -----------------------------------------------------------------------------
# Forward.
# -----------------------------------------------------------------------------
def _norm(p, x, cfg: ModelConfig, rt: Runtime, sp: bool):
    """RMSNorm; on the rank's rows under sequence parallelism (``sp``),
    its scale entering the model region."""
    if sp:
        p = {"scale": model_enter(p["scale"], rt)}
    return common.rmsnorm(p, x, cfg.norm_eps)


def _region(fn, h, rt: Runtime, split: bool, sp: bool):
    """``fn`` on the block input ``h`` (the rank's rows under sequence
    parallelism ``sp``, gathered first): inside a model region where
    ``split`` (its partial output summed over the axis), else whole;
    the output sliced back to the rows under ``sp``."""
    if sp:
        h = model_gather(h, rt, 1)
    h = model_leave(fn(model_enter(h, rt)), rt) if split else fn(h)
    return model_split(h, rt, 1) if sp else h


def _apply_block(bp, cfg: ModelConfig, rt: Runtime, char: str, x, rope,
                 cache, shared=None, sp: bool = False):
    """One block; returns (x, cache, aux): aux is the experts' f32
    load-balance loss, None without experts.  An ``a`` block applies
    ``shared`` (attention windowed at ``cfg.window``, then the MLP);
    ``m`` and ``r`` blocks write a given cache in place.  On a model
    axis the attention and the MLP run in model regions (:func:`_region`)
    where it splits them; ``sp``: ``x`` is the rank's rows of the
    residual stream (sequence parallelism)."""
    if char == "m":
        h, cache = ssm.ssm_apply(bp["ssm"], cfg, rt,
                                 common.rmsnorm(bp["ln1"], x, cfg.norm_eps),
                                 cache=cache)
        return x + h, cache, None
    if char == "r":
        # The time and channel mixes' own residuals on normed streams.
        p = bp["rwkv"]
        h, state, tm_last = rwkv.time_mix(
            p["tm"], cfg, rt, common.rmsnorm(bp["ln1"], x, cfg.norm_eps),
            cache["state"] if cache is not None else None,
            cache["tm_last"] if cache is not None else None)
        x = x + h
        h, cm_last = rwkv.channel_mix(
            p["cm"], cfg, common.rmsnorm(bp["ln2"], x, cfg.norm_eps),
            cache["cm_last"] if cache is not None else None)
        if cache is not None:
            cache = rwkv.write_cache(cache, state, tm_last, cm_last)
        return x + h, cache, None
    if char == "a":
        bp = shared
    window = cfg.window if char in ("l", "a") and cfg.window > 0 else 0

    def attend(h):
        nonlocal cache
        if cfg.mla is not None and char != "a":
            h, cache = mla.mla_apply(bp["attn"], cfg, rt, h, rope,
                                     cache=cache)
        else:
            h, cache = attn_mod.attn_apply(bp["attn"], cfg, rt, h, rope,
                                           window=window, cache=cache)
        return h

    h = _region(attend, _norm(bp["ln1"], x, cfg, rt, sp), rt,
                rt.splits(cfg.n_heads), sp)
    if cfg.post_norms:
        h = _norm(bp["ln1_post"], h, cfg, rt, sp)
    x = x + h
    h = _norm(bp["ln2"], x, cfg, rt, sp)
    aux = None
    if cfg.moe is not None and char != "a":
        def experts(t):
            # The experts enter and leave their region themselves: the
            # routing runs on the replicated input, outside it.
            nonlocal aux
            t, aux = moe.moe_apply(bp["moe"], cfg, rt, t)
            return t

        h = _region(experts, h, rt, False, sp)
    else:
        h = _region(lambda t: common.mlp_apply(bp["mlp"], t), h, rt,
                    rt.splits(cfg.d_ff), sp)
    if cfg.post_norms:
        h = _norm(bp["ln2_post"], h, cfg, rt, sp)
    return x + h, cache, aux


_AT = torch.ops.aten


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: save the outputs of ``mm``, ``addmm`` and of
    ``bmm`` over a batch of 1, recompute every other op.  PyTorch runs
    the models' weight einsums as ``bmm`` over a batch of 1 (and ``x @
    W`` as ``mm``), and an einsum with batch dimensions (the SSD's chunk
    products, RWKV6's state reads) as ``bmm`` over their product.  So
    this is the JAX package's ``dots_with_no_batch_dims_saveable`` but in
    two places: an einsum whose batch dimensions multiply to 1 (the SSD's
    at B 1 and one chunk) is saved here, not there, and the experts'
    products, one ``mm`` per expert here, are saved, where the JAX
    package's ``ecd,edf`` einsum has the experts as a batch dimension.
    K5 is no aten op, so its forward is recomputed, as under ``"full"``.
    """
    if op in (_AT.mm.default, _AT.addmm.default) or (
            op is _AT.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(params, cfg: ModelConfig, rt: Runtime, batch: Dict[str, Any],
            cache: Optional[dict] = None):
    """Logits (B, S, V) in ``cfg.dtype`` and the f32 auxiliary loss (the
    experts' load-balance loss summed over the blocks, 0 without
    experts); with a cache, ``(logits, cache, aux)``, the cache updated
    in place.  ``batch["tokens"]`` (B, S), or for a frontend
    ``batch["embeds"]`` (B, S, ``frontend_dim``), lies on the params'
    device; ``batch["positions"]`` (B, S), or M-RoPE's (3, B, S), is
    optional."""
    dt = common.dtype_of(cfg.dtype)
    tp = rt.model_size > 1
    check_model_axis(cfg, rt.model_size)
    if tp and cache is not None:
        raise NotImplementedError("decode on a model axis is the "
                                  "sequence-sharded decode (ROADMAP "
                                  "A13.5.3d)")
    if cfg.frontend is None:
        # Gather, then cast: the same bits as the JAX package's cast table.
        x = common.embed_lookup(params["embed"], batch["tokens"], dt,
                                rt if rt.splits(cfg.vocab) else None)
    else:
        x = torch.einsum("bsf,fd->bsd", batch["embeds"].to(dt),
                         params["frontend"]["proj"].to(dt))
        if rt.splits(cfg.d_model):   # the projection's slice of d
            x = model_gather(x, rt, 2)
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model) ** 0.5, dtype=dt)

    b, s = x.shape[:2]
    # Sequence parallelism where the model axis divides S (the JAX
    # package's fallback otherwise): the residual stream is the rank's
    # rows between blocks.
    sp = tp and rt.sequence_parallel and s % rt.model_size == 0
    if "positions" in batch:
        positions = batch["positions"]
    else:
        if cache is not None and s == 1:
            # The first unit position with a pos (a KV or a latent
            # cache's; every such block's is the same); 0 where none has
            # one (recurrent blocks read no position).
            pos0 = next((int(c["pos"][0]) for c in (
                cache[str(i)] for i in range(len(cfg.layer_pattern)))
                if "pos" in c), 0)
            positions = torch.full((b, 1), pos0, dtype=torch.int32,
                                   device=x.device)
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
    if cfg.mrope_sections is not None and positions.ndim == 2:
        # Text spans: the temporal, height and width positions are one.
        positions = positions[None].expand(3, b, s)
    # Multi-head latent attention rotates its rope_dim part only.
    rope = common.rope_tables(positions, cfg.mla.rope_dim if cfg.mla
                              else cfg.d_head, cfg.rope_theta,
                              cfg.mrope_sections)

    unit = cfg.layer_pattern
    r = cfg.pattern_repeats
    # Each stacked leaf as r views, taken once: their gradients return to
    # the (R, ...) leaf as one stacked tensor.
    blocks = {i: _tree_map(lambda p: torch.unbind(p, 0),
                           params["blocks"][str(i)])
              for i in range(len(unit))}
    remat = torch.is_grad_enabled() and cfg.remat != "none"
    if remat and cfg.remat not in ("full", "dots"):
        raise ValueError(f"{cfg.name}: remat={cfg.remat!r}; expected "
                         "'none', 'dots' or 'full'")
    # The unit's checkpoint saves nothing under "full", the weight
    # products' outputs under "dots".
    unit_kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}
        if cfg.remat == "dots" else {})

    # Per-block checkpoints inside the unit's, as the JAX package's (its
    # unit recompute at zamba2's 19 blocks would otherwise keep every
    # block's SSD internals at once).
    inner = remat and len(unit) > 2
    shared = params.get("shared_attn")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if sp:
        x = model_split(x, rt, 1)

    def unit_body(x, aux, j):
        for i, ch in enumerate(unit):
            bp = _tree_map(lambda views: views[j], blocks[i])
            c = (_tree_map(lambda t: t[j], cache[str(i)])
                 if cache is not None else None)
            args = (bp, cfg, rt, ch, x, rope, c, shared, sp)
            x, _, block_aux = (checkpoint(_apply_block, *args,
                                          use_reentrant=False)
                               if inner else _apply_block(*args))
            if block_aux is not None:
                aux = aux + block_aux
        return x, aux

    for j in range(r):
        if remat:
            x, aux = checkpoint(unit_body, x, aux, j, use_reentrant=False,
                                **unit_kw)
        else:
            x, aux = unit_body(x, aux, j)

    x = _norm(params["final_norm"], x, cfg, rt, sp)
    if sp:
        x = model_gather(x, rt, 1)
    if rt.splits(cfg.vocab):   # the rank's slice of the logits
        x = model_enter(x, rt)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x,
                              params["embed"]["tok"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              params["lm_head"]["w"].to(x.dtype))
    if logits.dtype == torch.bfloat16:
        logits = common.cast_cotangent_bf16(logits)
    if cache is not None:
        return logits, cache, aux
    return logits, aux


def loss_fn(params, cfg: ModelConfig, rt: Runtime, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss: next-token cross-entropy (f32, final softcap
    applied) over the batch's tokens shifted by one, plus ``AUX_COEF``
    times the auxiliary loss; returns ``(total, {"ce", "aux"})``.  On a
    model axis that splits the vocabulary the cross-entropy reads the
    rank's slice of the logits."""
    logits, aux = forward(params, cfg, rt, batch)
    labels = batch["labels"]
    vocab_rt = rt if rt.splits(cfg.vocab) else None
    if cfg.causal and cfg.frontend is None:
        loss = common.cross_entropy(logits[:, :-1], labels[:, 1:],
                                    cfg.final_softcap, vocab_rt)
    else:
        loss = common.cross_entropy(logits, labels, cfg.final_softcap,
                                    vocab_rt)
    total = loss + AUX_COEF * aux
    return total, {"ce": loss, "aux": aux}
