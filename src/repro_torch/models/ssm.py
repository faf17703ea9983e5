"""Mamba2 (SSD) block for zamba2 (arXiv:2411.15242 / 2405.21060) on one
device.

The port of the JAX package's ``models/ssm.py``.  Recurrence per head h
(P = head_dim, N = d_state):

    h_t = a_t * h_{t-1} + dt_t * x_t (outer) B_t        h: (P, N)
    y_t = (h_t . C_t) + D * x_t

with a_t = exp(-exp(A_log) * dt_t), dt_t = softplus(dt_raw + dt_bias),
B_t/C_t shared across heads (n_groups = 1), a depthwise causal conv
(width 4) over the (x, B, C) channels, and a gated RMSNorm before the
out-projection.

Two paths with one semantics, as there:

* :func:`ssd_scan`: the exact sequential recurrence, a Python loop over
  the tokens (the JAX package's ``lax.scan``); the decode step (L == 1)
  and sequences up to ``2 * chunk``;
* :func:`ssd_chunked`: the SSD block decomposition, within-chunk (Q x Q)
  decay matrices (every exponent <= 0) and an inter-chunk state loop;
  longer sequences (training).

Both run in f32 whatever the stream's dtype, with the JAX package's
casts; neither reaches a Pallas kernel there, so both are plain PyTorch
here on either device (a hand-written SSD kernel is ROADMAP B').  TF32
stays off: the einsums are f32 products as the reference's.

A cache is ``{"state": (B, H, P, N) f32, "conv": (B, W - 1, C)}`` (C =
d_inner + 2 d_state; f32, as the JAX package's ``init_cache`` makes it).
It has no ``pos``.  :func:`ssm_apply` writes the new state and conv
window into the cache's tensors in place and returns the same dict.
:func:`ssm_specs` and :func:`ssm_cache_specs` are the JAX package's.
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

__all__ = ["ssm_init", "ssm_specs", "ssm_apply", "ssd_chunked", "ssd_scan",
           "init_ssm_cache", "ssm_cache_specs"]


def ssm_init(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.float32, *, device):
    """``in_proj`` (D, 2 d_inner + 2 N + H), the conv's ``conv_w`` (W, C)
    at scale 0.2 and zero ``conv_b``, the deterministic ``dt_bias``,
    ``A_log`` and ``D`` (the JAX package's numpy values), the gated
    norm and ``out_proj`` (d_inner, D) at 0.02 / sqrt(2 n_layers)."""
    s = cfg.ssm
    d, din, nh = cfg.d_model, cfg.d_inner_ssm, cfg.n_ssm_heads
    conv_dim = din + 2 * s.d_state

    def const(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return {
        "in_proj": common.truncnorm((d, 2 * din + 2 * s.d_state + nh), dtype,
                                    generator, device),
        "conv_w": common.truncnorm((s.conv_width, conv_dim), dtype,
                                   generator, device, scale=0.2),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_bias": const(np.log(np.expm1(np.linspace(1e-3, 0.1, nh)))),
        "A_log": const(np.log(np.linspace(1.0, 16.0, nh))),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "norm": common.rmsnorm_init(din, dtype, device=device),
        "out_proj": common.truncnorm((din, d), dtype, generator, device,
                                     scale=0.02 / math.sqrt(
                                         2 * cfg.n_layers)),
    }


def ssm_specs(rt: Runtime, cfg: ModelConfig):
    s = cfg.ssm
    d, din, nh = cfg.d_model, cfg.d_inner_ssm, cfg.n_ssm_heads
    conv_dim = din + 2 * s.d_state
    return {
        "in_proj": rt.spec_div(("fsdp", "tp"),
                               (d, 2 * din + 2 * s.d_state + nh)),
        "conv_w": rt.spec_div((None, "tp"), (s.conv_width, conv_dim)),
        "conv_b": rt.spec_div(("tp",), (conv_dim,)),
        "dt_bias": rt.spec_div(("tp",), (nh,)),
        "A_log": rt.spec_div(("tp",), (nh,)),
        "D": rt.spec_div(("tp",), (nh,)),
        "norm": common.rmsnorm_specs(rt),
        "out_proj": rt.spec_div(("tp", "fsdp"), (din, d)),
    }


def _split_proj(cfg: ModelConfig, proj):
    s = cfg.ssm
    din = cfg.d_inner_ssm
    z = proj[..., :din]
    x = proj[..., din:2 * din]
    b = proj[..., 2 * din:2 * din + s.d_state]
    c = proj[..., 2 * din + s.d_state:2 * din + 2 * s.d_state]
    dt = proj[..., 2 * din + 2 * s.d_state:]
    return z, x, b, c, dt


def _causal_conv(u, w, bias, conv_cache=None):
    """Depthwise causal conv, width W: (B, L, C) with (W, C) filters; the
    cached W - 1 inputs (cast to u's dtype) or zeros before the first.
    Returns ``(silu(conv + bias), the last W - 1 inputs)``."""
    wdt = u.dtype
    width = w.shape[0]
    if conv_cache is not None:
        u_ext = torch.cat([conv_cache.to(wdt), u], dim=1)
    else:
        u_ext = F.pad(u, (0, 0, width - 1, 0))
    out = torch.zeros_like(u)
    for i in range(width):
        out = out + u_ext[:, i:i + u.shape[1]] * w[i].to(wdt)
    new_cache = u_ext[:, -(width - 1):] if width > 1 else None
    return F.silu(out + bias.to(wdt)), new_cache


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int):
    """SSD forward in chunks of ``chunk``. x: (B, L, H, P); dt: (B, L, H)
    (softplus applied); b, c: (B, L, N).  Returns y (B, L, H, P) f32."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    q = chunk
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    f32 = torch.float32
    xq = x.reshape(bsz, nc, q, h, p).to(f32)
    dtq = dt.reshape(bsz, nc, q, h).to(f32)
    bq = b.reshape(bsz, nc, q, n).to(f32)
    cq = c.reshape(bsz, nc, q, n).to(f32)
    loga = -torch.exp(a_log.to(f32))[None, None, None, :] * dtq   # (B,nc,Q,H)
    la = torch.cumsum(loga, dim=2)                                # inclusive
    # intra-chunk: G[b,c,h,i,j] = (C_i.B_j) exp(la_i - la_j) dt_j, i >= j
    cb = torch.einsum("bcin,bcjn->bcij", cq, bq)
    la_h = la.transpose(2, 3)                                     # (B,nc,H,Q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ldiff = la_h[:, :, :, :, None] - la_h[:, :, :, None, :]       # (B,nc,H,i,j)
    decay = torch.exp(ldiff.masked_fill(~mask, -math.inf))
    g = cb[:, :, None] * decay
    g = g * dtq.transpose(2, 3)[:, :, :, None, :]                 # dt_j
    y_intra = torch.einsum("bchij,bcjhp->bcihp", g, xq)
    # chunk states: S_c = sum_j exp(la_end - la_j) dt_j x_j (outer) B_j
    la_end = la[:, :, -1:, :]                                     # (B,nc,1,H)
    w_end = torch.exp(la_end - la) * dtq                          # (B,nc,Q,H)
    s_c = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w_end, xq, bq)
    # inter-chunk scan: the state entering each chunk
    decay_chunk = torch.exp(la_end[:, :, 0, :])                   # (B,nc,H)
    s = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    s_ins = []
    for ci in range(nc):
        s_ins.append(s)
        s = s * decay_chunk[:, ci, :, None, None] + s_c[:, ci]
    s_ins = torch.stack(s_ins, dim=1)                             # (B,nc,H,P,N)
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(la), cq,
                           s_ins)
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)
    if pad:
        y = y[:, :l]
    return y + x[:, :l].to(f32) * d_skip.to(f32)[None, None, :, None]


def ssd_scan(x, dt, a_log, b, c, d_skip, state=None):
    """The exact sequential recurrence (also the decode step, L == 1):
    ``(y (B, L, H, P) f32, final state (B, H, P, N) f32)``, from
    ``state`` or zeros."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    a = torch.exp(-torch.exp(a_log.to(f32))[None, None, :] * dt.to(f32))
    xf, dtf, bf, cf = x.to(f32), dt.to(f32), b.to(f32), c.to(f32)
    # Every token's dt x B^T at once (the same products), then the
    # per-token operands unbound once (no launch a slice; one stacked
    # gradient each under autograd).
    upd = (dtf[..., None] * xf)[..., None] * bf[:, :, None, None, :]
    upds, as_, cs = (t.transpose(0, 1).unbind(0) for t in (upd, a, cf))
    if state is None:
        state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    s, ys = state, []
    for t in range(l):
        s = s * as_[t][:, :, None, None] + upds[t]
        ys.append(torch.einsum("bhpn,bn->bhp", s, cs[t]))
    y = torch.stack(ys, dim=1)
    return y + xf * d_skip.to(f32)[None, None, :, None], s


def ssm_apply(params, cfg: ModelConfig, rt: Runtime, x, *,
              cache: Optional[dict] = None) -> Tuple[torch.Tensor,
                                                     Optional[dict]]:
    """x: (B, S, D) -> (out, cache).  With a cache and S == 1, one decode
    step from the cached state; else ``ssd_scan`` up to ``2 * chunk``
    tokens and ``ssd_chunked`` beyond (plus an ``ssd_scan`` for the final
    state when a cache is primed).  A given cache is written in place."""
    s = cfg.ssm
    bsz, l, _ = x.shape
    din, nh = cfg.d_inner_ssm, cfg.n_ssm_heads
    dt_ = x.dtype
    proj = torch.einsum("bsd,de->bse", x, params["in_proj"].to(dt_))
    z, xi, b, c, dtr = _split_proj(cfg, proj)
    conv_in = torch.cat([xi, b, c], dim=-1)
    conv_cache = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"], conv_cache)
    xi = conv_out[..., :din].reshape(bsz, l, nh, s.head_dim)
    b = conv_out[..., din:din + s.d_state]
    c = conv_out[..., din + s.d_state:]
    dtv = F.softplus(dtr.float() + params["dt_bias"].float())
    args = (xi, dtv, params["A_log"], b, c, params["D"])

    state = None
    if cache is not None and l == 1:
        y, state = ssd_scan(*args, state=cache["state"])
    elif l <= 2 * s.chunk:
        y, state = ssd_scan(*args)
    else:
        y = ssd_chunked(*args, s.chunk)
        if cache is not None:
            _, state = ssd_scan(*args)
    if cache is not None:
        cache["state"].copy_(state)
        cache["conv"].copy_(new_conv)
    y = y.reshape(bsz, l, din).to(dt_)
    y = common.rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(dt_))
    return out, cache


def init_ssm_cache(rt: Runtime, cfg: ModelConfig, batch: int,
                   dtype=torch.float32, *, device):
    """Cache leaves on ``device``: the f32 state (B, H, P, N) and the
    conv window (B, W - 1, d_inner + 2 N) in ``dtype``."""
    s = cfg.ssm
    return {
        "state": torch.zeros((batch, cfg.n_ssm_heads, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1,
                             cfg.d_inner_ssm + 2 * s.d_state), dtype=dtype,
                            device=device),
    }


def ssm_cache_specs(rt: Runtime, cfg: ModelConfig, batch: int):
    s = cfg.ssm
    return {
        "state": rt.spec_div(("fsdp", "tp", None, None),
                             (batch, cfg.n_ssm_heads, s.head_dim,
                              s.d_state)),
        "conv": rt.spec_div(("fsdp", None, "tp"),
                            (batch, s.conv_width - 1,
                             cfg.d_inner_ssm + 2 * s.d_state)),
    }
