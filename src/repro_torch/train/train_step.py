"""The train step: loss, gradients, the wire-dtype cast, AdamW.

The port of the JAX package's ``train/train_step.py`` on one device.
Gradients come from ``torch.autograd.grad`` of :func:`repro_torch.models.
model.loss_fn` with respect to the parameter leaves (detached views of
them, so the caller's tensors never require grad), in the parameters'
dtype; then, as there:

* ``grad_accum == 1``: the gradients are cast to ``rt.collective_dtype``
  (bf16 by default; the JAX package casts on one device too);
* ``grad_accum > 1``: the batch is split into that many microbatches,
  each one's gradients (quantised to int8 and back under
  ``compress="int8_ef"``) are summed in f32, averaged, and cast to the
  wire dtype once; the metrics' ``aux`` is the microbatches' mean (the
  JAX package reports 0 there, a load-balance loss it never computed);
* :func:`repro_torch.train.optimizer.adamw_update` updates the
  parameters and the optimizer state in place.

``make_train_step`` returns ``(params, opt_state, batch, step_rng) ->
(params, opt_state, metrics)``; ``step_rng`` is kept for the signature
and ignored, as in the JAX package.  Parameter and optimizer specs
belong to the mesh (ROADMAP A13.5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..dist.sharding import Runtime
from ..models import model as model_mod
from ..models.config import ModelConfig
from .optimizer import (AdamWConfig, adamw_init, adamw_update, ef_init,
                        tree_leaves, tree_map)

__all__ = ["TrainConfig", "make_train_state", "make_train_step",
           "loss_and_grads"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_accum: int = 1


def make_train_state(cfg: ModelConfig, rt: Runtime,
                     generator: torch.Generator,
                     tc: Optional[TrainConfig] = None, *, device):
    """(params, opt_state): parameters drawn from ``generator`` on
    ``device`` (``cuda`` without a card raises), AdamW's zero state, and
    the error-feedback residual under ``compress="int8_ef"``."""
    tc = tc or TrainConfig()
    params = model_mod.init_params(cfg, rt, generator, device)
    opt = adamw_init(params)
    if tc.opt.compress == "int8_ef":
        opt["ef"] = ef_init(params)
    return params, opt


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def loss_and_grads(params, cfg: ModelConfig, rt: Runtime,
                   batch: Dict[str, Any]):
    """``(loss, {"ce", "aux"}, grads)``: the loss of ``batch`` and its
    gradient tree (the parameters' dtype) by ``torch.autograd.grad``.  A
    leaf the loss does not read (qwen2-vl's token table, which its
    forward never takes) gets zeros, as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model_mod.loss_fn(_unflatten(params, leaves), cfg,
                                          rt, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, rt: Runtime,
                    tc: Optional[TrainConfig] = None):
    tc = tc or TrainConfig()

    def train_step(params, opt_state, batch, step_rng=None):
        del step_rng  # deterministic substrate; kept for API stability
        if tc.grad_accum == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, rt, batch)
            grads = tree_map(rt.astype, grads)
        else:
            def split(x):
                mb = x.shape[0] // tc.grad_accum
                return x.reshape((tc.grad_accum, mb) + tuple(x.shape[1:]))

            micro = {k: split(v) for k, v in batch.items()}
            # Accumulate in f32 (bf16 accumulation loses ~1e-2 relative);
            # the wire cast happens once, after the loop.
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
            aux_sum = loss_sum.clone()
            for i in range(tc.grad_accum):
                loss, micro_metrics, g = loss_and_grads(
                    params, cfg, rt, {k: v[i] for k, v in micro.items()})
                if tc.opt.compress == "int8_ef":
                    def q(gi):
                        qi, s = _quantize_int8(gi.to(torch.float32))
                        return qi.to(torch.float32) * s
                    g = tree_map(q, g)
                acc = tree_map(lambda a, gi: a + gi.to(torch.float32), acc, g)
                del g
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + micro_metrics["aux"]
            grads = tree_map(lambda g: rt.astype(g / tc.grad_accum), acc)
            del acc
            loss = loss_sum / tc.grad_accum
            metrics = {"ce": loss, "aux": aux_sum / tc.grad_accum}
        params, opt_state, opt_metrics = adamw_update(tc.opt, params, grads,
                                                      opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
