"""The train step: loss, gradients, the reduction, the wire-dtype cast,
AdamW.

The port of the JAX package's ``train/train_step.py``.  Gradients come
from ``torch.autograd.grad`` of :func:`repro_torch.models.model.loss_fn`
with respect to the parameter leaves (detached views of them, so the
caller's tensors never require grad), in the parameters' dtype; then, as
there:

* ``grad_accum == 1``: the gradients are cast to ``rt.collective_dtype``
  (bf16 by default; the JAX package casts on one device too);
* ``grad_accum > 1``: the batch is split by leading rows into that many
  microbatches, each one's gradients (quantised to int8 and back under
  ``compress="int8_ef"``, one scale a leaf, its ``max|g| / 127``) are
  summed in f32, averaged, and cast to the wire dtype once; the metrics'
  ``aux`` is the microbatches' mean (the JAX package reports 0 there, a
  load-balance loss it never computed);
* :func:`repro_torch.train.optimizer.adamw_update` updates the
  parameters and the optimizer state in place.

Under a mesh (data parallel: ``rt.tp_size == 1``; a model axis above 1
raises, tensor parallelism being ROADMAP A13.5.3b) the state lives
sharded as ``param_specs`` / ``opt_specs`` say and the batch is the
rank's rows (the data pipeline's batch under the mesh).  Each step
gathers the parameters whole and runs the model on rows of this rank
with ``Runtime(batch_group=...)``: no mesh, save that the experts'
load-balance loss sums its statistics over the data axes, so that it is
the global batch's as under the JAX package's pjit step.  Then:

* ``grad_accum == 1``: the gradients of the rank's rows are all-reduced
  over the data axes, averaged, and the local slice kept (gloo has no
  reduce-scatter, so every backend takes all-reduce then the slice)
  before the wire cast, where the JAX package pins the gradients to the
  parameter layout and casts (``_constrain``, then ``astype``);
* ``grad_accum > 1``: the ranks' rows are all-gathered into the global
  batch (token rows are small), microbatch ``i`` is its rows ``[i mb,
  (i + 1) mb)`` as in the JAX package, and each rank computes the
  gradient of its ``mb / n`` rows of it (``mb`` must divide over the
  ``n`` data ranks: a ``ValueError`` otherwise).  Under ``int8_ef`` each
  microbatch's gradient is all-reduced before it is quantised, so that
  its scale is the global ``max|g|``; otherwise the sum is reduced once,
  after the loop.

AdamW updates the shards with the global norm summed across ranks; the
loss is the ranks' mean.

``make_train_step`` returns ``(params, opt_state, batch, step_rng) ->
(params, opt_state, metrics)``; ``step_rng`` is kept for the signature
and ignored, as in the JAX package.  The returned function's ``wire``
is the :class:`~repro_torch.dist.collectives.WireLog` of its
collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..dist.collectives import WireLog, all_reduce
from ..dist.sharding import P, Runtime, tree_map_specs
from ..models import model as model_mod
from ..models.config import ModelConfig
from .optimizer import (AdamWConfig, adamw_init, adamw_update, ef_init,
                        opt_specs, tree_leaves, tree_map)

__all__ = ["TrainConfig", "make_train_state", "make_train_step",
           "loss_and_grads", "reduce_grads"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_accum: int = 1


def _mesh_only(rt: Runtime) -> None:
    if rt.tp_size > 1:
        raise NotImplementedError(
            f"a model axis of {rt.tp_size}: tensor parallelism comes with "
            "the model-parallel bodies (ROADMAP A13.5.3b); fold the model "
            "axis into the data axes (tp_disabled=True) to train data "
            "parallel")


def param_spec_tree(cfg: ModelConfig, rt: Runtime, params):
    """``param_specs(cfg, rt)`` under a mesh; without one every leaf of
    ``params`` replicated (what the JAX package's builders give there,
    for every family)."""
    if rt.mesh is not None:
        return model_mod.param_specs(cfg, rt)
    return tree_map(lambda p: P(*(None,) * p.dim()), params)


def make_train_state(cfg: ModelConfig, rt: Runtime,
                     generator: torch.Generator,
                     tc: Optional[TrainConfig] = None, *, device):
    """``(params, opt_state, param_specs, opt_specs)``: parameters drawn
    from ``generator`` on ``device`` (``cuda`` without a card raises),
    AdamW's zero state, and the error-feedback residual under
    ``compress="int8_ef"``.  Under a mesh every rank draws the whole
    tree from the same generator state and keeps its shards."""
    tc = tc or TrainConfig()
    if rt.mesh is not None:
        _mesh_only(rt)
    params = model_mod.init_params(cfg, rt, generator, device)
    pspecs = param_spec_tree(cfg, rt, params)
    if rt.mesh is not None:
        params = tree_map_specs(lambda p, s: rt.local(p, s).clone(),
                                params, pspecs)
    opt = adamw_init(params)
    if tc.opt.compress == "int8_ef":
        opt["ef"] = ef_init(params)
    return params, opt, pspecs, opt_specs(
        pspecs, with_ef=tc.opt.compress == "int8_ef")


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


def reduce_grads(grads, rt: Runtime, pspecs, log: Optional[WireLog] = None):
    """The ranks' mean of each gradient leaf over the data axes, as this
    rank's slice under ``pspecs`` (all-reduce, then the slice)."""
    group, _ = rt.mesh.group(rt.fsdp_axes)
    n = rt.fsdp_size
    return tree_map_specs(
        lambda g, s: rt.local(all_reduce(g, group, log) / n, s).clone(),
        grads, pspecs)


def _global_norm(grads, rt: Runtime, pspecs, log: Optional[WireLog]):
    """The norm of the global gradient from the ranks' slices: sharded
    leaves' squares summed across the data axes, replicated ones once."""
    sharded, replicated = [], []
    tree_map_specs(lambda g, s: (sharded if any(s) else replicated).append(
        torch.sum(torch.square(g.to(torch.float32)))), grads, pspecs)
    dev = tree_leaves(grads)[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    if sharded:
        group, _ = rt.mesh.group(rt.fsdp_axes)
        total = all_reduce(torch.sum(torch.stack(sharded)), group, log)
    if replicated:
        total = total + torch.sum(torch.stack(replicated))
    return torch.sqrt(total)


def _microbatches(batch: Dict[str, Any], rt: Runtime, grad_accum: int,
                  log: Optional[WireLog]) -> List[Dict[str, Any]]:
    """This rank's rows of each of the ``grad_accum`` microbatches, the
    JAX package's split of the global batch by leading rows: microbatch
    ``i`` is global rows ``[i mb, (i + 1) mb)``, of which the rank at
    position ``j`` over the data axes takes the ``j``-th ``mb / n``.
    Under a mesh the ranks' rows are all-gathered first."""
    n = rt.fsdp_size
    b = next(iter(batch.values())).shape[0] * n
    if b % grad_accum:
        raise ValueError(f"grad_accum {grad_accum} does not divide the "
                         f"global batch of {b} rows")
    mb = b // grad_accum
    if mb % n:
        raise ValueError(
            f"grad_accum {grad_accum} splits the global batch of {b} rows "
            f"into microbatches of {mb}, which do not divide over {n} data "
            "ranks")
    per = mb // n
    whole, j = batch, 0
    if rt.mesh is not None:
        import torch.distributed as dist
        whole = {k: rt.gather(v, P(rt.fsdp, *(None,) * (v.dim() - 1)), log)
                 for k, v in batch.items()}
        j = rt.mesh.axis_index(rt.fsdp_axes, dist.get_rank())
    return [{k: v[i * mb + j * per:i * mb + (j + 1) * per]
             for k, v in whole.items()} for i in range(grad_accum)]


def make_train_step(cfg: ModelConfig, rt: Runtime,
                    tc: Optional[TrainConfig] = None):
    tc = tc or TrainConfig()
    mesh = rt.mesh is not None
    int8 = tc.opt.compress == "int8_ef"
    body_rt = rt
    if mesh:
        _mesh_only(rt)
        pspecs = model_mod.param_specs(cfg, rt)
        group, _ = rt.mesh.group(rt.fsdp_axes)
        # Inside a rank's step the model sees its rows only, with no
        # mesh, save for the experts' statistics over the batch.
        body_rt = Runtime(batch_group=group)
    n = rt.fsdp_size
    # Under int8_ef on a mesh each microbatch's gradient is reduced before
    # it is quantised, and the loop's sum is then global already.
    reduce_micro = mesh and int8 and tc.grad_accum > 1
    wire = WireLog()

    def train_step(params, opt_state, batch, step_rng=None):
        del step_rng  # deterministic substrate; kept for API stability
        full = params
        if mesh:
            full = tree_map_specs(lambda p, s: rt.gather(p, s, wire),
                                  params, pspecs)
        if tc.grad_accum == 1:
            loss, metrics, grads = loss_and_grads(full, cfg, body_rt, batch)
        else:
            # Accumulate in f32 (bf16 accumulation loses ~1e-2 relative);
            # the wire cast happens once, after the loop.
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), full)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(full)[0].device)
            aux_sum = loss_sum.clone()
            for micro in _microbatches(batch, rt, tc.grad_accum, wire):
                loss, micro_metrics, g = loss_and_grads(full, cfg, body_rt,
                                                        micro)
                if reduce_micro:   # the microbatch's global gradient
                    g = tree_map(lambda gi: all_reduce(
                        gi.to(torch.float32), group, wire) / n, g)
                if int8:
                    def q(gi):
                        qi, s = _quantize_int8(gi.to(torch.float32))
                        return qi.to(torch.float32) * s
                    g = tree_map(q, g)
                acc = tree_map(lambda a, gi: a + gi.to(torch.float32), acc, g)
                del g
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + micro_metrics["aux"]
            grads = tree_map(lambda g: g / tc.grad_accum, acc)
            del acc
            loss = loss_sum / tc.grad_accum
            metrics = {"ce": loss, "aux": aux_sum / tc.grad_accum}
        del full
        gnorm = None
        if mesh:
            if reduce_micro:
                grads = tree_map_specs(lambda g, s: rt.local(g, s).clone(),
                                       grads, pspecs)
            else:
                grads = reduce_grads(grads, rt, pspecs, wire)
            grads = tree_map(rt.astype, grads)
            gnorm = _global_norm(grads, rt, pspecs, wire)
            loss = all_reduce(loss, group, wire) / n
            metrics = {k: all_reduce(v, group, wire) / n
                       for k, v in metrics.items()}
        else:
            grads = tree_map(rt.astype, grads)
        params, opt_state, opt_metrics = adamw_update(
            tc.opt, params, grads, opt_state, gnorm=gnorm)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    train_step.wire = wire
    return train_step
