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

Under a mesh the state lives sharded as ``param_specs`` / ``opt_specs``
say and the batch is the rank's rows (the data pipeline's batch under
the mesh: the ranks of one data shard draw the same rows).  Each step
gathers the parameters over the data axes, so that the rank holds its
model-axis slices whole, and runs the model on its rows with
:meth:`Runtime.step_body`'s Runtime:

* data parallel (``rt.tp_size == 1``): no mesh, save that the experts'
  load-balance loss sums its statistics over the data axes, so that it
  is the global batch's as under the JAX package's pjit step;
* tensor parallel (a model axis above 1, ROADMAP A13.5.3b; the families
  with MLA, Mamba2 or RWKV6 blocks raise, A13.5.3e): the model-parallel
  bodies of ``repro_torch.models`` on the rank's slices, crossing the
  model axis inside the forward and backward (counted on the step's
  ``model_wire``).  A leaf replicated over the model axis but read
  inside a model region (the router, KV projections that stay whole,
  the norms' scales under sequence parallelism) enters the region
  through ``model_enter``, whose backward sums its gradient over the
  axis; every other replicated leaf's gradient is the same on each rank
  and is left alone.  The experts' load-balance loss is each data
  shard's own, averaged over the data ranks, as in the JAX package.

Then:

* ``grad_accum == 1``: the gradients of the rank's rows are all-reduced
  over the data axes, averaged, and the slice over the data axes kept
  (gloo has no reduce-scatter, so every backend takes all-reduce then
  the slice) before the wire cast, where the JAX package pins the
  gradients to the parameter layout and casts (``_constrain``, then
  ``astype``);
* ``grad_accum > 1``: the ranks' rows are all-gathered into the global
  batch (token rows are small), microbatch ``i`` is its rows ``[i mb,
  (i + 1) mb)`` as in the JAX package, and each rank computes the
  gradient of its ``mb / n`` rows of it (``mb`` must divide over the
  ``n`` data ranks: a ``ValueError`` otherwise).  Under ``int8_ef`` each
  microbatch's gradient is all-reduced before it is quantised, so that
  its scale is the global ``max|g|`` (over the model axis too, for a
  leaf split on it); otherwise the sum is reduced once, after the loop.

AdamW updates the shards with the global norm: each leaf's squares
summed across the ranks that hold distinct slices of it, on the data
axes or the model axis, and counted once along an axis that replicates
it.  The loss and the metrics are the data ranks' mean.

``make_train_step`` returns ``(params, opt_state, batch, step_rng) ->
(params, opt_state, metrics)``; ``step_rng`` is kept for the signature
and ignored, as in the JAX package.  The returned function's ``wire``
is the :class:`~repro_torch.dist.collectives.WireLog` of its
collectives over the data axes, and ``model_wire`` that of its body's
over the model axis.
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
    model_mod.check_model_axis(cfg, rt.tp_size)
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


def _quantize_int8(x: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` and their scale, ``max|x| / 127``: over the
    ranks of ``group`` where ``x`` is their slice of one leaf."""
    top = torch.max(torch.abs(x))
    if group is not None:
        top = all_reduce(top, group, op="max")
    scale = top / 127.0 + 1e-12
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
    """The ranks' mean of each gradient leaf (the rank's model-axis
    slice) over the data axes, as this rank's slice under ``pspecs``
    (all-reduce, then the slice over the data axes)."""
    group, _ = rt.mesh.group(rt.fsdp_axes)
    n = rt.fsdp_size

    def reduce(g, s):
        if n > 1:   # one data shard: nothing to cross
            g = all_reduce(g, group, log) / n
        return rt.local(g, rt.data_spec(s)).clone()
    return tree_map_specs(reduce, grads, pspecs)


def _split_on(rt: Runtime, s: P) -> Tuple[bool, bool]:
    """(whether spec ``s`` splits a dim over the data axes, over the
    model axis)."""
    model = rt.tp_size > 1 and rt.model_axis in s
    return (any(e is not None and not (model and e == rt.model_axis)
                for e in s), model)


def _global_norm(grads, rt: Runtime, pspecs, log: Optional[WireLog]):
    """The norm of the global gradient from the ranks' slices: each
    leaf's squares summed across the axes that split it (the data axes,
    the model axis or both), and counted once along an axis that
    replicates it."""
    buckets: Dict[Tuple[bool, bool], List[torch.Tensor]] = {}
    tree_map_specs(lambda g, s: buckets.setdefault(
        _split_on(rt, s), []).append(
        torch.sum(torch.square(g.to(torch.float32)))), grads, pspecs)
    dev = tree_leaves(grads)[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for on_data, on_model in ((True, False), (True, True), (False, True)):
        part = buckets.get((on_data, on_model))
        if part:
            axes = ((rt.fsdp_axes if on_data else ())
                    + ((rt.model_axis,) if on_model else ()))
            group, _ = rt.mesh.group(axes)
            total = total + all_reduce(torch.sum(torch.stack(part)), group,
                                       log)
    if buckets.get((False, False)):
        total = total + torch.sum(torch.stack(buckets[(False, False)]))
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
    model_mod.check_model_axis(cfg, rt.tp_size)
    mesh = rt.mesh is not None
    int8 = tc.opt.compress == "int8_ef"
    body_rt = rt
    wire, model_wire = WireLog(), WireLog()
    if mesh:
        pspecs = model_mod.param_specs(cfg, rt)
        dspecs = tree_map(rt.data_spec, pspecs)
        group, _ = rt.mesh.group(rt.fsdp_axes)
        # Inside a rank's step the model sees its rows and its model-axis
        # slices, with no mesh.
        body_rt = rt.step_body(model_wire)
        # The scale of an int8 microbatch gradient spans a leaf split on
        # the model axis.
        qgroups = tree_map(lambda s: (body_rt.model_group
                                      if _split_on(rt, s)[1] else None),
                           pspecs)
    n = rt.fsdp_size
    # Under int8_ef on a mesh each microbatch's gradient is reduced before
    # it is quantised, and the loop's sum is then global already.
    reduce_micro = mesh and int8 and tc.grad_accum > 1

    def train_step(params, opt_state, batch, step_rng=None):
        del step_rng  # deterministic substrate; kept for API stability
        full = params
        if mesh:
            full = tree_map_specs(lambda p, s: rt.gather(p, s, wire),
                                  params, dspecs)
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
                    def q(gi, qg=None):
                        qi, s = _quantize_int8(gi.to(torch.float32), qg)
                        return qi.to(torch.float32) * s
                    g = (tree_map(q, g, qgroups) if mesh
                         else tree_map(q, g))
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
                grads = tree_map_specs(
                    lambda g, s: rt.local(g, s).clone(), grads, dspecs)
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
    train_step.model_wire = model_wire
    return train_step
