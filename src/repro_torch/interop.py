"""Carry state into the port from plain values.

Each function builds one of the port's objects from a dict of numpy
arrays and plain Python values — the fields of the corresponding
dataclass.  A caller that holds the JAX package's objects (a parity
test, say) flattens them into such dicts itself; this module never sees
them, so the port can run its scan on exactly the tables, workload and
configuration another implementation built, and its models on exactly
the parameters and KV caches another implementation made (nested dicts
of numpy arrays, as the JAX package's trees are).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from . import resolve_device
from .core.layers import LayeredRouting
from .core.paths import CompressedTables
from .core.topology import Topology
from .core.traffic import FlowWorkload
from .core.transport import SimConfig

__all__ = ["topology_from_arrays", "routing_from_arrays",
           "workload_from_arrays", "config_from_dict",
           "model_params_from_arrays", "kv_cache_from_arrays",
           "opt_state_from_arrays"]


def _fields(cls, d: Mapping[str, Any]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def topology_from_arrays(d: Mapping[str, Any]) -> Topology:
    """A :class:`Topology` from its fields (``adj``, ``concentration``
    as numpy arrays)."""
    kw = _fields(Topology, d)
    kw["adj"] = np.asarray(kw["adj"], dtype=np.bool_)
    kw["concentration"] = np.asarray(kw["concentration"], dtype=np.int64)
    kw["params"] = dict(kw.get("params") or {})
    return Topology(**kw)


def _compressed_from_arrays(d: Mapping[str, Any],
                           device="cuda") -> CompressedTables:
    """:class:`CompressedTables` from its fields: ``nh_sets`` (int32) and
    ``sel`` (uint8) as numpy arrays, placed on ``device``, and the ints
    ``block`` and ``n``."""
    dev = resolve_device(device)
    return CompressedTables(
        nh_sets=torch.tensor(np.asarray(d["nh_sets"], np.int32), device=dev),
        sel=torch.tensor(np.asarray(d["sel"], np.uint8), device=dev),
        block=int(d["block"]), n=int(d["n"]))


def routing_from_arrays(topo: Topology, d: Mapping[str, Any],
                        device="cuda") -> LayeredRouting:
    """A :class:`LayeredRouting` from ``scheme``, ``rho`` and the numpy
    tables ``nh``, ``reach``, ``pathlen``, ``layer_adj``, placed on
    ``device``.  The fault lanes are carried as given; ``compressed``,
    when present, is a dict of :class:`CompressedTables`' fields
    (``nh_sets`` and ``sel`` as numpy arrays, ``block`` and ``n``)."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(d[name]), device=dev).to(dtype)

    ct = d.get("compressed")

    return LayeredRouting(
        topo=topo, scheme=str(d["scheme"]), rho=float(d["rho"]),
        nh=t("nh", torch.int32), reach=t("reach", torch.bool),
        pathlen=t("pathlen", torch.int16),
        layer_adj=t("layer_adj", torch.bool),
        build_stats=d.get("build_stats"),
        link_down_step=d.get("link_down_step"),
        link_churn=d.get("link_churn"),
        churn_conv=int(d.get("churn_conv") or 0),
        compressed=None if ct is None else _compressed_from_arrays(ct, dev))


def workload_from_arrays(d: Mapping[str, Any]) -> FlowWorkload:
    """A :class:`FlowWorkload` from its numpy fields."""
    kw = {k: (None if v is None else np.asarray(v))
          for k, v in _fields(FlowWorkload, d).items()}
    return FlowWorkload(**kw)


def config_from_dict(d: Mapping[str, Any]) -> SimConfig:
    """A :class:`SimConfig` from its fields; a backend name meant for the
    JAX package's dispatch is dropped (the port dispatches by device)."""
    kw = _fields(SimConfig, d)
    kw["kernel_backend"] = ""
    return SimConfig(**kw)


def _tensor(a, device) -> torch.Tensor:
    """A tensor from a numpy array; bfloat16 arrays (``ml_dtypes``' type,
    which ``torch.from_numpy`` does not take) go across as their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def model_params_from_arrays(cfg, tree: Mapping[str, Any],
                             device="cuda") -> dict:
    """The port's parameter tree for ``cfg`` (a
    :class:`~repro_torch.models.config.ModelConfig`) from the same nested
    dict of numpy arrays, placed on ``device`` in ``cfg.param_dtype``:
    the JAX package's ``init_params`` tree, once converted leaf by leaf,
    is already in the port's layout."""
    from .models.common import dtype_of

    dev = resolve_device(device)
    blocks = tree["blocks"]
    if sorted(blocks) != [str(i) for i in range(len(cfg.layer_pattern))]:
        raise ValueError(f"blocks {sorted(blocks)} do not match the layer "
                         f"pattern {cfg.layer_pattern!r}")
    for i, block in blocks.items():
        _tree(lambda a, i=i: _check_repeats(a, cfg.pattern_repeats, i),
              block)
    dt = dtype_of(cfg.param_dtype)
    return _tree(lambda a: _tensor(a, dev).to(dt), tree)


def _check_repeats(a, r, i):
    if np.shape(a)[:1] != (r,):
        raise ValueError(f"block {i}: a leaf of shape {np.shape(a)} is not "
                         f"stacked over the {r} pattern repeats")


def kv_cache_from_arrays(tree: Mapping[str, Any], device="cuda") -> dict:
    """The port's KV cache from the JAX package's ``init_cache`` tree as
    numpy arrays: k/v on ``device`` in their dtype, ``pos`` as int32 on
    the host (where the port keeps it)."""
    dev = resolve_device(device)
    return {i: {"k": _tensor(c["k"], dev), "v": _tensor(c["v"], dev),
                "pos": torch.from_numpy(np.asarray(c["pos"], np.int32)
                                        .copy())}
            for i, c in tree.items()}


def opt_state_from_arrays(tree: Mapping[str, Any], device="cuda") -> dict:
    """The port's AdamW state from the JAX package's ``adamw_init`` /
    ``adamw_update`` state as numpy arrays: the moments ``m`` and ``v``
    (and the error-feedback ``ef`` residual, when present) as f32 trees
    on ``device``, ``step`` as an int32 scalar there."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dev)

    out = {"m": _tree(f32, tree["m"]), "v": _tree(f32, tree["v"]),
           "step": torch.tensor(int(np.asarray(tree["step"])),
                                dtype=torch.int32, device=dev)}
    if "ef" in tree:
        out["ef"] = _tree(f32, tree["ef"])
    return out
