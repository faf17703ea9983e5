"""One max-min water-filling step of the flow simulator (paper §7.1.3).

Per simulated step the scan scatters flow weights into per-link claim
counts, gathers each link's fair share back, takes the min over each
flow's hop slots, and refines the provisional demands ``fair_iters``
times so that no link is oversubscribed.  A CUDA tensor runs the
hand-written kernel in ``csrc/waterfill.cu``, one launch a step; a CPU
tensor runs the plain version in :mod:`repro_torch.kernels.ref`.  The two
give the same bits: the kernel sums each link's loads in f32 in the
plain version's flat row-major ``(flow, slot)`` order, read from a
:func:`link_plan`.

The kernel maps inactive rows and ``-1`` slots to the trash link whether
or not ``active`` is given (``active=None`` means every row is active),
as the TPU kernel it replaces does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import LAUNCHES, build, ref

__all__ = ["waterfill_step", "link_plan", "LinkPlan"]

MAX_LAYERS = 32      # one bit of an entry's layer mask per layer


class LinkPlan(NamedTuple):
    """Each link's path entries of an (L, F, S) edge stack (see
    :func:`link_plan`); ``n_flows`` is F, which the flows' ids in
    ``entries`` stay below."""
    offsets: torch.Tensor
    entries: torch.Tensor
    n_flows: int


def link_plan(path_edges: torch.Tensor, e_tot: int) -> LinkPlan:
    """Each link's path entries in flat ``(flow, slot)`` order, as a CSR.

    ``path_edges`` (L, F, S) or (F, S) link ids per layer.  Slots whose id
    is negative, the trash link ``e_tot - 1`` or out of range are dropped.
    Returns ``(offsets, entries, F)``: link ``e``'s entries are
    ``entries[offsets[e]:offsets[e + 1]]`` (int32 offsets, ``e_tot + 1``
    of them; the trash link's segment is empty), sorted by ``(flow,
    slot)``.  An int64 entry holds the flow in its low 32 bits and, in its
    high 32, the mask of the layers in which the flow's slot holds this
    link: a slot that holds the same link in several layers is one entry.
    With the flows' current layers, the entries of a link whose flow is
    sending and whose mask has the flow's layer are exactly the positions
    of that link in the flattened gathered (F, S) edges, in order.  Built
    with one sort, on the tensor's device."""
    if path_edges.dim() == 2:
        path_edges = path_edges[None]
    n_layers, f, s = path_edges.shape
    if n_layers > MAX_LAYERS:
        raise ValueError(f"link_plan takes at most {MAX_LAYERS} layers, "
                         f"got {n_layers}")
    dev = path_edges.device
    e = path_edges.to(torch.int64)
    keep = (e >= 0) & (e < e_tot - 1)
    ar = lambda n: torch.arange(n, device=dev, dtype=torch.int64)  # noqa
    key = (e * f + ar(f)[None, :, None]) * s + ar(s)[None, None, :]
    bit = torch.bitwise_left_shift(torch.ones_like(e), ar(n_layers)[:, None,
                                                                    None])
    key, inv = torch.unique(key[keep], sorted=True, return_inverse=True)
    mask = torch.zeros_like(key).index_add_(0, inv, bit[keep])
    if key.numel() >= 2 ** 31:
        raise ValueError(f"{key.numel()} plan entries overflow int32 offsets")
    counts = torch.bincount(key // (f * s), minlength=e_tot)
    offsets = torch.zeros(e_tot + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    # The mask's 32 bits as a signed int32 value, then shifted up.
    mask = torch.where(mask >= 2 ** 31, mask - 2 ** 32, mask)
    entries = mask * 2 ** 32 + (key // s) % f
    return LinkPlan(offsets, entries, f)


def _lib():
    lib = build.load("waterfill")
    fn = lib.waterfill_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i, i,
                       p, p, p, p, p, p, p, p, p]
        fn.restype = i
        lib.waterfill_grid_blocks.restype = i
        lib.waterfill_grid_blocks.argtypes = []
    return lib


def _need(name, x, shape, dtype, dev):
    if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _launch(edges, w, desired, cap, active, fair_iters, want_util, acc,
            plan, layer, phase_ns=None):
    dev = edges.device
    f, s = edges.shape
    e_tot = cap.shape[0]
    for name, x, n in (("w", w, f), ("desired", desired, f),
                       ("cap", cap, e_tot)):
        if x.device != dev or x.shape != (n,):
            raise ValueError(f"{name}: expected ({n},) on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
    if edges.dtype != torch.int32 or edges.stride(1) != 1:
        raise TypeError("edges must be int32 with unit column stride")
    if e_tot < 1 or fair_iters < 0:
        raise ValueError(f"need e_tot >= 1 and fair_iters >= 0 "
                         f"(got {e_tot}, {fair_iters})")
    if active is None:
        active = torch.ones(f, dtype=torch.bool, device=dev)
    if active.device != dev or active.shape != (f,):
        raise ValueError(f"active: expected ({f},) on {dev}")
    if plan is None:
        if layer is not None:
            raise ValueError("layer is given without a plan")
        plan = link_plan(edges, e_tot)
    offsets, entries, n_flows = plan
    if n_flows != f:
        raise ValueError(f"the plan is for {n_flows} flows, not {f}")
    _need("plan offsets", offsets, (e_tot + 1,), torch.int32, dev)
    if entries.device != dev or entries.dtype != torch.int64 \
            or entries.dim() != 1:
        raise ValueError("plan entries: expected a 1-D int64 tensor on "
                         f"{dev}")
    if layer is not None:
        _need("layer", layer, (f,), torch.int32, dev)
        layer = layer.contiguous()
    if acc is not None:
        _need("acc", acc, (f,), torch.float32, dev)
        acc = acc.contiguous()
    w = w.to(torch.float32).contiguous()
    desired = desired.to(torch.float32).contiguous()
    cap = cap.to(torch.float32).contiguous()
    active = active.to(torch.bool).contiguous()
    sent = torch.empty(f, dtype=torch.float32, device=dev)
    share = torch.empty(f, dtype=torch.float32, device=dev)
    util = torch.empty(f, dtype=torch.float32, device=dev) if want_util \
        else None
    acc_out = None if acc is None else torch.empty_like(acc)
    out = (sent, share) + ((util,) if want_util else ()) \
        + (() if acc is None else (acc_out,))
    if f == 0:
        return out
    # Scratch, rewritten every round: per link what the flows gather
    # (and load / cap for util), per flow its demand and live layer.
    # Freeing it on return is safe: the caching allocator hands the memory
    # only to work queued later on the same stream.
    link = torch.empty((2 if want_util else 1, e_tot), dtype=torch.float32,
                       device=dev)
    flow_rec = torch.empty((f, 2), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    code = lib.waterfill_launch(
        edges.data_ptr(), edges.stride(0), w.data_ptr(), desired.data_ptr(),
        active.data_ptr(), ptr(layer), cap.data_ptr(), ptr(acc),
        offsets.data_ptr(), entries.data_ptr(), f, s, e_tot, fair_iters,
        link[0].data_ptr(), link[1].data_ptr() if want_util else None,
        flow_rec.data_ptr(), sent.data_ptr(), share.data_ptr(), ptr(util),
        ptr(acc_out), ptr(phase_ns), stream)
    build.check(lib, code, "waterfill_step")
    LAUNCHES["waterfill"] += 1
    return out


def waterfill_step(edges: torch.Tensor, w: torch.Tensor,
                   desired: torch.Tensor, cap: torch.Tensor, *,
                   active: Optional[torch.Tensor] = None,
                   fair_iters: int = 2,
                   want_util: bool = False,
                   acc: Optional[torch.Tensor] = None,
                   plan: Optional[LinkPlan] = None,
                   layer: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """One water-filling step: ``(sent, share)`` per flow, then ``util``
    with ``want_util``, then ``acc + sent`` rounded once with ``acc``.

    ``edges`` (F, S) link ids (id ``cap.shape[0] - 1`` is the write-only
    trash link), ``w`` the flow weights, ``desired`` the requested rates
    and ``cap`` the link capacities, any f32 values; ``active`` the
    optional (F,) bool mask; ``acc`` an optional (F,) f32 accumulator,
    left unwritten.  ``plan`` is :func:`link_plan` of an (L, F, S) edge
    stack whose layer ``layer[i]`` (F,) int32 holds row ``i`` of
    ``edges``, as the scan builds it once per cell; without one, a CUDA
    call builds a one-layer plan of ``edges``.  The CPU path needs
    neither.  Semantics: :func:`repro_torch.kernels.ref.waterfill_ref`."""
    if edges.is_cuda:
        return _launch(edges, w, desired, cap, active, int(fair_iters),
                       bool(want_util), acc, plan, layer)
    return ref.waterfill_ref(edges, w, desired, cap, fair_iters=fair_iters,
                             active=active, want_util=want_util, acc=acc)
