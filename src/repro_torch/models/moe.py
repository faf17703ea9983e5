"""Mixture-of-experts MLP block (olmoe: 64 experts top-8; deepseek-v2: 160
top-6 and 2 shared experts) on one device and in a data-parallel mesh
step's body.

The port of the JAX package's ``models/moe.py`` without a model axis:
its ``moe_apply`` there, ``_moe_body_tp(do_psum=False)``.
Routing is token-choice and dropless:

* the router's logits in f32, softmax, top-k, the k weights renormalised
  to sum to 1 under ``router_scale``;
* the switch-style load-balance loss ``E sum_e f_e p_e``: ``f_e`` the
  share of the (token, k) choices that picked expert e (counts, so no
  gradient flows through it), ``p_e`` the router's mean probability.
  In a mesh step's body (``rt.batch_group`` set) both are the global
  batch's, as the JAX package's pjit step takes them: the (E,) counts
  and sums of probabilities are summed over the group before the
  product (a mean over the ranks of each rank's own loss would differ,
  a mean of products not being a product of means);
* the (token, k) rows sorted by expert (a stable sort, as ``jnp.argsort``
  is), each expert's SwiGLU on its own contiguous rows, the rows put
  back in token order and combined over k as ``(t, k, d) * topw`` summed
  over k; the shared experts' MLP added on every token.

The JAX package runs the experts' products as ``jax.lax.ragged_dot``
outside any Pallas kernel; here each expert with rows is three
``torch.matmul`` calls on its slice.  The group sizes reach the host once
a layer (they set the slices' shapes), and experts that no row chose are
skipped.  :func:`moe_specs` is the JAX package's under its default
``moe_mode="tp"``; expert parallelism (``moe_mode="ep"``, its specs and
the all-to-all body) comes with ROADMAP A13.5.3c.

On a model axis (a mesh step's body, ROADMAP A13.5.3b) the experts run
the JAX package's ``_moe_body_tp`` with its psum over ``model``: ``w1``
and ``w3`` are the rank's slices of ``d_ff_expert``, ``w2`` of its
first dim, and the shared experts' MLP is split the same way where its
width divides.  The routing runs whole on every rank from the
replicated input; the experts' rows and ``topw`` enter the model region
(:func:`~repro_torch.dist.collectives.model_enter`, so that the router's
gradient, of which each rank sees a part through its partial outputs,
is summed over the axis), and the partial output leaves it summed.  The
load-balance loss is the rank's data shard's own (the JAX package's
``pmean`` over the axes of each shard's aux), which the mesh step
averages over the data ranks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.collectives import model_enter, model_leave, replicated_sum
from ..dist.sharding import Runtime
from . import common
from .config import ModelConfig

__all__ = ["moe_init", "moe_specs", "moe_apply", "route"]


def moe_init(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.float32, *, device):
    """The router (D, E), the experts' ``w1``/``w3`` (E, D, F) and ``w2``
    (E, F, D) and, with shared experts, their SwiGLU MLP of width
    ``n_shared * d_ff_shared``; the JAX package's leaves and scales."""
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": common.truncnorm((d, m.n_experts), dtype, generator,
                                   device),
        "w1": common.truncnorm((m.n_experts, d, m.d_ff_expert), dtype,
                               generator, device),
        "w3": common.truncnorm((m.n_experts, d, m.d_ff_expert), dtype,
                               generator, device),
        "w2": common.truncnorm((m.n_experts, m.d_ff_expert, d), dtype,
                               generator, device,
                               scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if m.n_shared > 0:
        p["shared"] = common.mlp_init(d, m.n_shared * m.d_ff_shared,
                                      generator, dtype, device=device)
    return p


def moe_specs(rt: Runtime, cfg: ModelConfig):
    """The partition specs of :func:`moe_init`'s leaves: the JAX
    package's under ``moe_mode="tp"`` (the experts' FFN width over the
    model axis, D over the data axes)."""
    m = cfg.moe
    d = cfg.d_model
    s = {
        "router": rt.spec_div(("fsdp", None), (d, m.n_experts)),
        "w1": rt.spec_div((None, "fsdp", "tp"),
                          (m.n_experts, d, m.d_ff_expert)),
        "w3": rt.spec_div((None, "fsdp", "tp"),
                          (m.n_experts, d, m.d_ff_expert)),
        "w2": rt.spec_div((None, "tp", "fsdp"),
                          (m.n_experts, m.d_ff_expert, d)),
    }
    if m.n_shared > 0:
        s["shared"] = common.mlp_specs(rt, d, m.n_shared * m.d_ff_shared)
    return s


def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
          rt: Optional[Runtime] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(topw in x's dtype, topi int64, aux f32) of (T, D) tokens: the JAX
    package's ``_route``.  With ``rt.batch_group`` the aux is the global
    batch's: every rank's counts and probability sums summed over the
    group (:func:`~repro_torch.dist.collectives.replicated_sum`, whose
    backward gives each rank the whole batch's share of the gradient,
    as the mesh step's mean over the ranks needs)."""
    m = cfg.moe
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, m.top_k, dim=-1)
    if m.router_scale:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    counts = torch.bincount(topi.reshape(-1), minlength=m.n_experts).float()
    group = rt.batch_group if rt is not None else None
    if group is None:
        p_e = probs.mean(dim=0)
    else:
        counts, p_sum = replicated_sum(
            torch.cat([counts, probs.sum(dim=0)]), group).split(m.n_experts)
        p_e = p_sum / (counts.sum() / m.top_k)   # over the global tokens
    f_e = counts / torch.clamp(counts.sum(), min=1.0)
    aux = m.n_experts * torch.sum(f_e * p_e)
    return topw.to(x_flat.dtype), topi, aux


def _expert_ffn_sorted(xs, counts, w1, w3, w2):
    """SwiGLU of each expert on its contiguous rows of ``xs`` (sorted by
    expert, ``counts[e]`` rows for expert e), experts without rows
    skipped.  Each weight is cast once and unbound once, so that its
    gradient comes back as one (E, ...) tensor."""
    dt = xs.dtype
    w1, w3, w2 = (torch.unbind(w.to(dt)) for w in (w1, w3, w2))
    outs = []
    for e, rows in enumerate(torch.split(xs, counts)):
        if counts[e]:
            h = F.silu(rows @ w1[e]) * (rows @ w3[e])
            outs.append(h @ w2[e])
    return torch.cat(outs)


def moe_apply(params, cfg: ModelConfig, rt: Runtime, x
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, the f32 aux loss)."""
    m = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    topw, topi, aux = route(x_flat, params["router"], cfg, rt)
    experts_split = rt.splits(m.d_ff_expert)
    shared_split = m.n_shared > 0 and rt.splits(m.n_shared * m.d_ff_shared)
    x_in = x
    if experts_split:
        x_flat = model_enter(x_flat, rt)
        topw = model_enter(topw, rt)
    if shared_split:
        x_in = model_enter(x, rt)
    eid = topi.reshape(-1)                                 # (T k,)
    order = torch.argsort(eid, stable=True)
    # Token-major rows (token i's k choices at i k .. i k + k - 1), sorted:
    # a permutation, so the backward scatters each row once.
    xs = torch.repeat_interleave(x_flat, m.top_k, dim=0)[order]
    counts = torch.bincount(eid, minlength=m.n_experts).tolist()
    ys = _expert_ffn_sorted(xs, counts, params["w1"], params["w3"],
                            params["w2"])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y = (ys[inv].reshape(t, m.top_k, d) * topw[..., None]).sum(dim=1)
    if experts_split:
        y = model_leave(y, rt)
    if "shared" in params:
        sh = common.mlp_apply(params["shared"], x_in).reshape(t, d)
        y = y + (model_leave(sh, rt) if shared_split else sh)
    return y.reshape(b, s, d), aux
