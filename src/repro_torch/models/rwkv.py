"""RWKV6 "Finch" block (arXiv:2404.05892) on one device: an
attention-free time mix with data-dependent decay and a squared-ReLU
channel mix.

The port of the JAX package's ``models/rwkv.py``.  Time mix per head (K
= V = head_dim):

    w_t = exp(-exp(w0 + tanh(xw_t @ A) @ B))      (data-dependent decay, LoRA)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)

followed by a per-head RMS norm, a SiLU gate g and the output
projection; token-shift mixing (a static mu per r/k/v/g/w) precedes
every projection.

The recurrence is the exact sequential one, in f32 and in the JAX
package's order (y from ``S + u kv``, then ``S = S w + kv``), a Python
loop over the tokens where the JAX package has a ``lax.scan``.  There
it is jnp code outside any Pallas kernel; here it is plain PyTorch on
either device (a chunked WKV kernel is ROADMAP B').  Its state is
O(H K V) a sequence.

A cache is ``{"state": (B, H, K, V), "tm_last": (B, D), "cm_last": (B,
D)}``, all f32, with no ``pos``; the boundary tokens are cast to the
stream's dtype where they are used.  :func:`rwkv_specs` and
:func:`rwkv_cache_specs` are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.sharding import Runtime
from . import common
from .config import ModelConfig

__all__ = ["rwkv_init", "rwkv_specs", "time_mix", "wkv_recurrence",
           "channel_mix", "rwkv_apply", "write_cache", "init_rwkv_cache",
           "rwkv_cache_specs"]


def rwkv_init(cfg: ModelConfig, generator: torch.Generator,
              dtype=torch.float32, *, device):
    """The time mix's and the channel mix's leaves and scales, the JAX
    package's (``w0`` its deterministic ``linspace(-6, -0.5, D)``)."""
    r = cfg.rwkv
    d, f = cfg.d_model, cfg.d_ff
    nh = d // r.head_dim
    scale_o = 0.02 / math.sqrt(2 * cfg.n_layers)

    def tn(shape, scale=0.02):
        return common.truncnorm(shape, dtype, generator, device, scale=scale)
    return {
        "tm": {  # time mix
            "mu": tn((5, d), 0.1),                           # r, k, v, g, w
            "wr": tn((d, d)), "wk": tn((d, d)), "wv": tn((d, d)),
            "wg": tn((d, d)),
            "w0": torch.tensor(np.linspace(-6.0, -0.5, d), dtype=dtype,
                               device=device),
            "wa": tn((d, r.decay_lora)), "wb": tn((r.decay_lora, d)),
            "u": tn((nh, r.head_dim), 0.3),
            "ln": common.rmsnorm_init(d, dtype, device=device),
            "wo": tn((d, d), scale_o),
        },
        "cm": {  # channel mix
            "mu": tn((2, d), 0.1),                           # k, r
            "wk": tn((d, f)), "wv": tn((f, d), scale_o), "wr": tn((d, d)),
        },
    }


def rwkv_specs(rt: Runtime, cfg: ModelConfig):
    r = cfg.rwkv
    d, f = cfg.d_model, cfg.d_ff
    nh = d // r.head_dim
    dd = rt.spec_div(("fsdp", "tp"), (d, d))
    return {
        "tm": {
            "mu": rt.spec_div((None, "fsdp"), (5, d)),
            "wr": dd, "wk": dd, "wv": dd, "wg": dd,
            "w0": rt.spec_div(("fsdp",), (d,)),
            "wa": rt.spec_div(("fsdp", None), (d, r.decay_lora)),
            "wb": rt.spec_div((None, "fsdp"), (r.decay_lora, d)),
            "u": rt.spec_div(("tp", None), (nh, r.head_dim)),
            "ln": common.rmsnorm_specs(rt),
            "wo": rt.spec_div(("tp", "fsdp"), (d, d)),
        },
        "cm": {
            "mu": rt.spec_div((None, "fsdp"), (2, d)),
            "wk": rt.spec_div(("fsdp", "tp"), (d, f)),
            "wv": rt.spec_div(("tp", "fsdp"), (f, d)),
            "wr": dd,
        },
    }


def _token_shift(x, last: Optional[torch.Tensor]):
    """x_{t-1}: zero or the cached boundary token (f32, cast to x's
    dtype) before the first."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last.to(x.dtype)[:, None, :], x[:, :-1]], dim=1)


def time_mix(p, cfg: ModelConfig, rt: Runtime, x, state, last):
    """x: (B, L, D); state: (B, H, K, V) f32 or None; last: (B, D) or
    None.  Returns ``(out, new state, x's last token in f32)``."""
    b, l, d = x.shape
    hd = cfg.rwkv.head_dim
    nh = d // hd
    dt = x.dtype
    prev = _token_shift(x, last)
    mu = p["mu"].to(dt)
    xr = x + (prev - x) * mu[0]
    xk = x + (prev - x) * mu[1]
    xv = x + (prev - x) * mu[2]
    xg = x + (prev - x) * mu[3]
    xw = x + (prev - x) * mu[4]
    r = torch.einsum("bld,de->ble", xr, p["wr"].to(dt))
    k = torch.einsum("bld,de->ble", xk, p["wk"].to(dt))
    v = torch.einsum("bld,de->ble", xv, p["wv"].to(dt))
    g = F.silu(torch.einsum("bld,de->ble", xg, p["wg"].to(dt)))
    lora = torch.tanh(torch.einsum("bld,dr->blr", xw, p["wa"].to(dt)))
    wlog = p["w0"].float() + torch.einsum("blr,re->ble", lora,
                                          p["wb"].to(dt)).float()
    w = torch.exp(-torch.exp(wlog))                    # (B, L, D) in (0, 1)

    y, s = wkv_recurrence(*(t.reshape(b, l, nh, hd).float()
                            for t in (r, k, v, w)), p["u"], state)
    y = y.reshape(b, l, d).to(dt)
    y = common.rmsnorm(p["ln"], y, cfg.norm_eps) * g
    out = torch.einsum("bld,de->ble", y, p["wo"].to(dt))
    return out, s, x[:, -1, :].float()


def wkv_recurrence(r, k, v, w, u, state=None):
    """The exact sequential WKV recurrence in f32: r, k, v, w (B, L, H,
    K) f32, the bonus ``u`` (H, K), the state (B, H, K, V) or zeros.
    Per token ``y = r (S + u k v^T)``, then ``S = S w + k v^T``.  Returns
    ``(y (B, L, H, V), the final state)``."""
    b, l, nh, hd = r.shape
    # The elementwise k v^T and u k v^T of every token at once (the same
    # products), then each operand unbound once into per-token views: a
    # token's slice then costs no launch, and autograd returns each
    # operand's gradient as one stacked tensor, not a full-size zero
    # tensor per token.
    kv = k[..., :, None] * v[..., None, :]                 # (B, L, H, K, V)
    ukv = u.float()[None, None, :, :, None] * kv
    rs = r.transpose(0, 1).contiguous().unbind(0)   # each (B, H, K) dense
    ws, kvs, ukvs = (t.transpose(0, 1).unbind(0) for t in (w, kv, ukv))
    s = state if state is not None else torch.zeros(
        (b, nh, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(l):
        ys.append(torch.einsum("bhk,bhkv->bhv", rs[t], s + ukvs[t]))
        s = s * ws[t][..., None] + kvs[t]
    return torch.stack(ys, dim=1), s


def channel_mix(p, cfg: ModelConfig, x, last):
    """Returns ``(sigmoid(r) * (relu(x_k W_k)^2 W_v), x's last token in
    f32)``."""
    dt = x.dtype
    prev = _token_shift(x, last)
    mu = p["mu"].to(dt)
    xk = x + (prev - x) * mu[0]
    xr = x + (prev - x) * mu[1]
    k = torch.square(F.relu(torch.einsum("bld,df->blf", xk,
                                         p["wk"].to(dt))))
    kv = torch.einsum("blf,fd->bld", k, p["wv"].to(dt))
    r = torch.sigmoid(torch.einsum("bld,de->ble", xr, p["wr"].to(dt)))
    return r * kv, x[:, -1, :].float()


def write_cache(cache, state, tm_last, cm_last):
    """Write a block's new state and boundary tokens into ``cache`` in
    place; returns it."""
    cache["state"].copy_(state)
    cache["tm_last"].copy_(tm_last)
    cache["cm_last"].copy_(cm_last)
    return cache


def rwkv_apply(params, cfg: ModelConfig, rt: Runtime, x, *,
               cache: Optional[dict] = None) -> Tuple[torch.Tensor,
                                                      Optional[dict]]:
    """The RWKV6 block without its norms: time mix and channel mix with
    their residuals (the model's ``r`` block norms each mix's input).  A
    given cache is read, then written in place."""
    st = cache["state"] if cache is not None else None
    tl = cache["tm_last"] if cache is not None else None
    cl = cache["cm_last"] if cache is not None else None
    h, new_state, new_tl = time_mix(params["tm"], cfg, rt, x, st, tl)
    x = x + h
    h2, new_cl = channel_mix(params["cm"], cfg, x, cl)
    if cache is not None:
        cache = write_cache(cache, new_state, new_tl, new_cl)
    return x + h2, cache


def init_rwkv_cache(rt: Runtime, cfg: ModelConfig, batch: int, *, device):
    """Cache leaves on ``device``, all f32: the state (B, H, K, V) and
    the time and channel mixes' boundary tokens (B, D)."""
    r = cfg.rwkv
    d = cfg.d_model
    nh = d // r.head_dim
    return {
        "state": torch.zeros((batch, nh, r.head_dim, r.head_dim),
                             dtype=torch.float32, device=device),
        "tm_last": torch.zeros((batch, d), dtype=torch.float32,
                               device=device),
        "cm_last": torch.zeros((batch, d), dtype=torch.float32,
                               device=device),
    }


def rwkv_cache_specs(rt: Runtime, cfg: ModelConfig, batch: int):
    r = cfg.rwkv
    d = cfg.d_model
    nh = d // r.head_dim
    return {
        "state": rt.spec_div(("fsdp", "tp", None, None),
                             (batch, nh, r.head_dim, r.head_dim)),
        "tm_last": rt.spec_div(("fsdp", None), (batch, d)),
        "cm_last": rt.spec_div(("fsdp", None), (batch, d)),
    }
