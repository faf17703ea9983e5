"""Manual data-parallel training with FatPaths-layered gradient sync.

The port of the JAX package's ``train/manual_dp.py``.  The whole step
runs per rank over the data axes (:meth:`Runtime.shard_map`): parameters
replicated, the batch sharded by rows, and the gradient all-reduce is
the port's own:

* :func:`repro_torch.dist.collectives.multiring_all_reduce` over
  ``layer_strides(n, n_rings)``: ``n_rings`` stride rings, the paper's
  layers (near-disjoint fabric paths);
* the wire dtype is the config's: ``float32``, ``bfloat16`` (the rings
  add in bf16; the JAX package's XLA:CPU hoists the casts out of its
  rings and adds in f32) or ``int8_ef``.

``int8_ef`` keeps the JAX package's arithmetic: each rank adds its
residual, scales its payload by its *own* ``max|g| / 127``, sends int8
values summed in int32 by the rings, and multiplies the sum by its own
scale.  So the ranks' parameters and residuals drift apart (each rank
keeps its own, as each of the JAX package's devices keeps its buffers,
which its out_specs call replicated); the float wires keep the ranks
bitwise equal.  The loss is the ranks' mean.

Intended for replicated-parameter (data-parallel-only) regimes, where
gradient wire compression matters most.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..dist.collectives import (WireLog, all_reduce, layer_strides,
                                multiring_all_reduce)
from ..dist.sharding import P, Runtime
from ..models.common import dtype_of
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, adamw_update, tree_map
from .train_step import loss_and_grads

__all__ = ["ManualDPConfig", "make_manual_dp_step"]

_WIRES = ("float32", "bfloat16", "int8_ef")


@dataclasses.dataclass(frozen=True)
class ManualDPConfig:
    opt: AdamWConfig = AdamWConfig()
    n_rings: int = 4                 # FatPaths layers for the gradient AR
    wire: str = "bfloat16"           # float32 | bfloat16 | int8_ef

    def __post_init__(self):
        if self.wire not in _WIRES:
            raise ValueError(f"wire must be one of {_WIRES}, got "
                             f"{self.wire!r}")


def make_manual_dp_step(cfg: ModelConfig, rt: Runtime,
                        mc: Optional[ManualDPConfig] = None):
    """``(params, opt_state, ef, batch) -> (params, opt_state, ef,
    metrics)`` on every rank of ``rt``'s mesh.

    ``params``, ``opt_state`` and ``ef`` (the error-feedback residual
    tree, f32 zeros like the parameters; pass it for every wire, it is
    returned unchanged but under ``int8_ef``) are the rank's replicated
    copies, updated in place; ``batch`` is the global batch, of which the
    rank takes its rows.  ``rt.data_axes`` must span the mesh.  The
    returned function's ``wire`` is the
    :class:`~repro_torch.dist.collectives.WireLog` of its rings.
    """
    mc = mc or ManualDPConfig()
    if rt.mesh is None:
        raise ValueError("manual DP needs a mesh")
    axis = rt.data_axes if len(rt.data_axes) > 1 else rt.data_axes[0]
    mesh = rt.mesh
    # inside the manual region every tensor is rank-local: the model runs
    # with no mesh
    rt_local = Runtime()
    wire = WireLog()
    group, ranks = mesh.group(rt.data_axes)
    n = len(ranks)
    strides = layer_strides(n, mc.n_rings)

    def sync(g, r):
        gf = g.to(torch.float32)
        if mc.wire == "int8_ef":
            gf = gf + r                      # carry-in residual
            scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
            q = torch.clamp(torch.round(gf / scale), -127, 127)
            new_r = gf - q * scale           # local quantisation error
            # rings sum int8 payloads in int32 to avoid overflow
            summed = multiring_all_reduce(
                q.to(torch.int8).to(torch.int32), axis, strides, mesh=mesh,
                log=wire)
            return summed.to(torch.float32) * scale / n, new_r
        wire_dt = (torch.float32 if mc.wire == "float32"
                   else dtype_of(mc.wire))
        summed = multiring_all_reduce(gf.to(wire_dt), axis, strides,
                                      mesh=mesh, log=wire)
        return summed.to(torch.float32) / n, r

    def step(params, opt_state, ef, batch):
        loss, _, grads = loss_and_grads(params, cfg, rt_local, batch)
        pairs = tree_map(sync, grads, ef)
        del grads
        grads_g = tree_map(lambda t: t[0], pairs)
        new_ef = tree_map(lambda t: t[1], pairs)
        del pairs
        params, opt_state, om = adamw_update(mc.opt, params, grads_g,
                                             opt_state)
        loss_g = all_reduce(loss, group, wire) / n
        return params, opt_state, new_ef, {"loss": loss_g, **om}

    def specs_like(tree):
        return tree_map(lambda x: P(*(None,) * x.dim()), tree)

    def wrapped(params, opt_state, ef, batch):
        in_specs = (specs_like(params), specs_like(opt_state),
                    specs_like(ef),
                    tree_map(lambda x: P(rt.fsdp, *(None,) * (x.dim() - 1)),
                             batch))
        out_specs = (specs_like(params), specs_like(opt_state),
                     specs_like(ef), {"loss": P(), "lr": P(),
                                      "grad_norm": P()})
        return rt.shard_map(step, in_specs=in_specs, out_specs=out_specs)(
            params, opt_state, ef, batch)

    wrapped.wire = wire
    return wrapped
