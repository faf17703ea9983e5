"""One max-min water-filling step of the flow simulator (paper §7.1.3).

Per simulated step the scan scatters flow weights into per-link claim
counts, gathers each link's fair share back, takes the min over each
flow's hop slots, and refines the provisional demands ``fair_iters``
times so that no link is oversubscribed.  A CUDA tensor runs the
hand-written kernel sequence in ``csrc/waterfill.cu`` (bitwise
reproducible from launch to launch); a CPU tensor runs the plain version
in :mod:`repro_torch.kernels.ref`.

The kernel maps inactive rows and ``-1`` slots to the trash link whether
or not ``active`` is given (``active=None`` means every row is active),
as the TPU kernel it replaces does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import LAUNCHES, build, ref

__all__ = ["waterfill_step"]


def _lib():
    lib = build.load("waterfill")
    fn = lib.waterfill_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, p, p, p, p, p]
        fn.restype = i
    return lib


def _launch(edges, w, desired, cap, active, fair_iters, want_util):
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
    if f * s >= 2 ** 23:
        raise ValueError(f"F*S = {f * s} overflows the fixed-point link sums")
    if active is None:
        active = torch.ones(f, dtype=torch.bool, device=dev)
    if active.device != dev or active.shape != (f,):
        raise ValueError(f"active: expected ({f},) on {dev}")
    w = w.to(torch.float32).contiguous()
    desired = desired.to(torch.float32).contiguous()
    cap = cap.to(torch.float32).contiguous()
    active = active.to(torch.bool).contiguous()
    sent = torch.empty(f, dtype=torch.float32, device=dev)
    share = torch.empty(f, dtype=torch.float32, device=dev)
    util = torch.empty(f, dtype=torch.float32, device=dev) if want_util \
        else None
    if f == 0:
        return (sent, share, util) if want_util else (sent, share)
    # Scratch link sums, one row per round.  Freeing it on return is safe:
    # the caching allocator hands the memory only to work queued later on
    # the same stream.
    load = torch.empty((1 + fair_iters, e_tot), dtype=torch.int64,
                       device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.waterfill_launch(
        edges.data_ptr(), edges.stride(0), w.data_ptr(), desired.data_ptr(),
        active.data_ptr(), cap.data_ptr(), f, s, e_tot, fair_iters,
        load.data_ptr(), sent.data_ptr(), share.data_ptr(),
        util.data_ptr() if want_util else None, stream)
    build.check(lib, code, "waterfill_step")
    LAUNCHES["waterfill"] += 1
    return (sent, share, util) if want_util else (sent, share)


def waterfill_step(edges: torch.Tensor, w: torch.Tensor,
                   desired: torch.Tensor, cap: torch.Tensor, *,
                   active: Optional[torch.Tensor] = None,
                   fair_iters: int = 2,
                   want_util: bool = False) -> Tuple[torch.Tensor, ...]:
    """One water-filling step: ``(sent, share)`` per flow, or
    ``(sent, share, util)`` with ``want_util``.

    ``edges`` (F, S) link ids (id ``cap.shape[0] - 1`` is the write-only
    trash link), ``w`` the 0/1 flow weights, ``desired`` the requested
    rates and ``cap`` the link capacities, all in line-rate units;
    ``active`` the optional (F,) bool mask.  Semantics:
    :func:`repro_torch.kernels.ref.waterfill_ref`."""
    if edges.is_cuda:
        return _launch(edges, w, desired, cap, active, int(fair_iters),
                       bool(want_util))
    return ref.waterfill_ref(edges, w, desired, cap, fair_iters=fair_iters,
                             active=active, want_util=want_util)
