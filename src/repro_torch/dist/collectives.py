"""FatPaths-layered collective schedules over ``torch.distributed``.

The paper spreads one logical flow over several near-disjoint routing
layers; the collective analogue runs one ring all-reduce per *stride
ring*: ring ``r`` visits the ranks in order ``0, s_r, 2 s_r, ...``
(mod n), which on a fabric with FatPaths layers maps each ring onto a
different set of links (quantified by :mod:`repro_torch.dist.fabric`).
Each ring moves ``1/R`` of the payload through the classic
reduce-scatter + all-gather schedule, so the total wire bytes match a
single ring while the per-link load spreads R ways.

The port of the JAX package's ``dist/collectives.py``.  Its functions
run inside ``shard_map`` over a named axis; here every rank calls them
with its own tensor and the :class:`~repro_torch.dist.sharding.Mesh`
that names the axis (an axis name or a tuple of names, row-major).  Each
``ppermute`` step is one ``batch_isend_irecv`` on the default group
along ``i -> (i + stride) % n`` (the axis position's global rank); the
R rings of :func:`multiring_all_reduce` take their step ``k`` in one
batch.  The order of adds (``chunk(i - k s) + recv``), the zero padding,
the ring-interleaved payload (element e rides ring ``e mod R``) and the
``n == 1`` shortcut are the JAX package's, so f32 and int32 payloads
equal its output bit for bit.

gloo's point-to-point ops, and its all-gather, take host tensors only:
where the group's backend is gloo and the payload lies on a card, the
wire goes through page-locked host buffers (copied out before the send,
back after the receive); all-reduce is staged the same way.  The
backend decides, never a caught error.  A :class:`WireLog` passed in
counts the bytes each call sends and the seconds it and its host
staging take.

The model region's autograd functions (tensor parallelism, ROADMAP
A13.5.3b) cross the model axis of a mesh step's body, whose Runtime
names the axis' group (``model_group``, ``model_ranks``,
``model_index``) and counts on its ``model_wire``:

* :func:`model_enter`: identity forward, all-reduce backward: a
  replicated tensor (an activation or a replicated weight) read by a
  region in which each rank computes a part, so that each rank's
  cotangent is a partial sum;
* :func:`model_leave`: all-reduce forward, identity backward: the
  ranks' partial sums leave the region replicated;
* :func:`model_gather`: all-gather along a dimension forward, the
  rank's slice of the cotangent backward: the sequence at a block's
  entry under sequence parallelism (the region's :func:`model_enter`
  then sums the cotangent first: reduce, then slice), or the frontend's
  projection split on ``d``;
* :func:`model_split`: the rank's slice along a dimension forward, the
  all-gather of the cotangent backward: the rows of a block's output
  under sequence parallelism, after :func:`model_leave` (reduce, then
  slice: gloo has no reduce-scatter).

Under a checkpoint each runs again in the recomputed forward, in the
same order on every rank.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "layer_strides",
    "ring_reduce_scatter",
    "ring_all_gather",
    "multiring_all_reduce",
    "all_reduce",
    "replicated_sum",
    "all_gather",
    "model_enter",
    "model_leave",
    "model_gather",
    "model_split",
    "WireLog",
]


def layer_strides(n: int, k: int) -> Tuple[int, ...]:
    """The first ``k`` positive ring strides coprime with ``n``.

    ``layer_strides(16, 3) == (1, 3, 5)``.  Every returned stride
    generates a Hamiltonian ring on n ranks (gcd(s, n) == 1) — the
    software twin of the paper's routing layers.  The first ``phi(n)``
    rings traverse distinct neighbour patterns; only when ``k`` exceeds
    the number of coprime residues (pigeonhole) do rings repeat a pattern
    mod n, and the payload still splits k ways.
    """
    if n <= 1:
        return (1,) * k
    out = []
    s = 1
    while len(out) < k:
        if math.gcd(s, n) == 1:
            out.append(s)
        s += 1
    return tuple(out)


@dataclasses.dataclass
class WireLog:
    """What one rank's collectives moved: ``sent_bytes`` (point-to-point
    sends), ``reduced_bytes`` (payloads of all-reduce and all-gather
    calls, whatever the backend's own schedule sends), ``seconds`` (host
    wall inside the calls, staging included) and ``staging_seconds``
    (the host copies of card payloads)."""

    sent_bytes: int = 0
    reduced_bytes: int = 0
    seconds: float = 0.0
    staging_seconds: float = 0.0
    calls: int = 0


def _staged(t: torch.Tensor, group=None) -> bool:
    """Whether ``t`` crosses ``group``'s wire through a host buffer:
    gloo's point-to-point and gather ops take host tensors only."""
    import torch.distributed as dist
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _host_like(t: torch.Tensor) -> torch.Tensor:
    """An empty page-locked host buffer of ``t``'s shape and dtype (the
    caching host allocator reuses them from call to call)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _to_host(ts: List[torch.Tensor], log: Optional[WireLog]):
    t0 = time.perf_counter()
    out = [_host_like(t).copy_(t) for t in ts]   # waits for the copy
    if log is not None:
        log.staging_seconds += time.perf_counter() - t0
    return out


def _to_device(ts: List[torch.Tensor], device, log: Optional[WireLog]):
    t0 = time.perf_counter()
    out = [t.to(device, non_blocking=True) for t in ts]
    torch.cuda.synchronize(device)
    if log is not None:
        log.staging_seconds += time.perf_counter() - t0
    return out


def all_reduce(x: torch.Tensor, group=None,
               log: Optional[WireLog] = None, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (``op="max"``: the largest) of every rank's ``x`` over
    ``group`` (a new tensor)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    device = x.device
    stage = _staged(x, group)
    buf = (_to_host([x], log)[0] if stage
           else x.clone(memory_format=torch.contiguous_format))
    dist.all_reduce(buf, group=group, op={"sum": dist.ReduceOp.SUM,
                                          "max": dist.ReduceOp.MAX}[op])
    if stage:
        buf = _to_device([buf], device, log)[0]
    if log is not None:
        log.reduced_bytes += x.numel() * x.element_size()
        log.seconds += time.perf_counter() - t0
        log.calls += 1
    return buf


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


def replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, differentiable where
    every rank's loss reads that sum the same way, so that each rank's
    incoming gradient is the same ``g``.  The adjoint of the sum is then
    the sum of the ranks' gradients, ``n g``: the backward scales by the
    group's size ``n`` and needs no collective, so a recomputed forward
    (a checkpoint's) is the only collective the backward reaches."""
    import torch.distributed as dist
    return _ReplicatedSum.apply(x, group, dist.get_world_size(group))


def all_gather(x: torch.Tensor, group, members: Sequence[int],
               log: Optional[WireLog] = None) -> List[torch.Tensor]:
    """Every member's ``x`` (same shape on each), in the order of
    ``members`` (global ranks; the group's own order may differ)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    device = x.device
    stage = _staged(x, group)
    src = _to_host([x], log)[0] if stage else x.contiguous()
    parts = [_host_like(src) if stage else torch.empty_like(src)
             for _ in members]
    dist.all_gather(parts, src, group=group)
    if stage:
        parts = _to_device(parts, device, log)
    order = dist.get_process_group_ranks(group)
    out = [parts[order.index(r)] for r in members]
    if log is not None:
        log.reduced_bytes += x.numel() * x.element_size()
        log.seconds += time.perf_counter() - t0
        log.calls += 1
    return out


class _ModelEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rt = ctx.rt
        return all_reduce(g, rt.model_group, rt.model_wire), None


class _ModelLeave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt):
        return all_reduce(x, rt.model_group, rt.model_wire)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _model_slice(x: torch.Tensor, rt, dim: int) -> torch.Tensor:
    per = x.shape[dim] // rt.model_size
    return x.narrow(dim, rt.model_index * per, per).contiguous()


def _model_cat(x: torch.Tensor, rt, dim: int) -> torch.Tensor:
    return torch.cat(all_gather(x, rt.model_group, rt.model_ranks,
                                rt.model_wire), dim=dim)


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt, dim):
        ctx.rt, ctx.dim = rt, dim
        return _model_cat(x, rt, dim)

    @staticmethod
    def backward(ctx, g):
        return _model_slice(g, ctx.rt, ctx.dim), None, None


class _ModelSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt, dim):
        ctx.rt, ctx.dim = rt, dim
        return _model_slice(x, rt, dim)

    @staticmethod
    def backward(ctx, g):
        return _model_cat(g.contiguous(), ctx.rt, ctx.dim), None, None


def model_enter(x: torch.Tensor, rt) -> torch.Tensor:
    """``x`` entering a model region (identity); its cotangent is summed
    over ``rt``'s model axis."""
    return _ModelEnter.apply(x, rt)


def model_leave(x: torch.Tensor, rt) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``rt``'s model axis; the
    cotangent passes unchanged to each rank's part."""
    return _ModelLeave.apply(x, rt)


def model_gather(x: torch.Tensor, rt, dim: int) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim`` joined in axis order; the
    backward keeps the rank's slice of the cotangent."""
    return _ModelGather.apply(x, rt, dim)


def model_split(x: torch.Tensor, rt, dim: int) -> torch.Tensor:
    """The rank's slice of the replicated ``x`` along ``dim`` (which the
    model axis divides); the backward all-gathers the ranks'
    cotangents."""
    return _ModelSplit.apply(x, rt, dim)


def _axes(axis) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _ring_index(axis, mesh) -> int:
    """Linear rank index along ``axis`` (row-major over an axis tuple)."""
    import torch.distributed as dist
    return mesh.axis_index(_axes(axis), dist.get_rank())


def _ring(axis, mesh) -> Tuple[int, Tuple[int, ...]]:
    """(this rank's index along ``axis``, the axis' global ranks in
    index order)."""
    import torch.distributed as dist
    return (_ring_index(axis, mesh),
            mesh.axis_ranks(_axes(axis), dist.get_rank()))


def _check_stride(stride: int, n: int) -> None:
    """A non-coprime stride decomposes the ring into gcd(s, n) disjoint
    cycles and would silently drop contributions."""
    if math.gcd(stride, n) != 1:
        raise ValueError(f"ring stride {stride} is not coprime with axis "
                         f"size {n} (use layer_strides)")


def _permute(bufs: List[torch.Tensor], peers: Sequence[Tuple[int, int]],
             log: Optional[WireLog]) -> List[torch.Tensor]:
    """One ppermute step of several rings at once: ``bufs[j]`` goes to
    global rank ``peers[j][0]`` and the returned ``j``-th tensor comes
    from ``peers[j][1]``."""
    import torch.distributed as dist

    device = bufs[0].device
    stage = _staged(bufs[0])
    sends = (_to_host(bufs, log) if stage
             else [b.contiguous() for b in bufs])
    recvs = [_host_like(s) if stage else torch.empty_like(s) for s in sends]
    ops = []
    for s, r, (dst, src) in zip(sends, recvs, peers):
        ops.append(dist.P2POp(dist.isend, s, dst))
        ops.append(dist.P2POp(dist.irecv, r, src))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if log is not None:
        log.sent_bytes += sum(s.numel() * s.element_size() for s in sends)
    return _to_device(recvs, device, log) if stage else recvs


def _pad_chunks(flat: torch.Tensor, n: int) -> torch.Tensor:
    m0 = flat.shape[0]
    m = -(-m0 // n) * n
    if m != m0:
        flat = torch.cat([flat, flat.new_zeros((m - m0,))])
    return flat.reshape(n, m // n)


def _reduce_scatter_rings(xs, strides, i, ranks, log):
    """The reduce-scatter of ``xs[j]`` along stride ``strides[j]``, all
    rings stepping together."""
    n = len(ranks)
    chunks = [_pad_chunks(x.reshape(-1), n) for x in xs]
    peers = [(ranks[(i + s) % n], ranks[(i - s) % n]) for s in strides]
    # step k: send the running chunk (i - k*s) to the ring successor,
    # receive chunk (i - (k+1)*s) and fold in the local copy.
    cur = [c[i] for c in chunks]
    for k in range(1, n):
        recv = _permute(cur, peers, log)
        cur = [c[(i - k * s) % n] + r
               for c, s, r in zip(chunks, strides, recv)]
    return cur


def _all_gather_rings(xs, strides, offsets, i, ranks, log):
    n = len(ranks)
    peers = [(ranks[(i + s) % n], ranks[(i - s) % n]) for s in strides]
    cur = [x.reshape(-1) for x in xs]
    outs = [c.new_zeros((n, c.shape[0])) for c in cur]
    for o, c, off in zip(outs, cur, offsets):
        o[(i + off) % n] = c
    for k in range(1, n):
        cur = _permute(cur, peers, log)
        # the chunk arriving at step k originated k ring-hops upstream
        for o, c, s, off in zip(outs, cur, strides, offsets):
            o[(i - k * s + off) % n] = c
    return [o.reshape(-1) for o in outs]


def _timed(fn, log: Optional[WireLog]):
    t0 = time.perf_counter()
    out = fn()
    if log is not None:
        log.seconds += time.perf_counter() - t0
        log.calls += 1
    return out


def ring_reduce_scatter(x: torch.Tensor, axis, stride: int, *, mesh,
                        log: Optional[WireLog] = None) -> torch.Tensor:
    """Ring reduce-scatter over ``axis`` with the given stride.

    Flattens ``x`` (padding with zeros to a multiple of n) and runs the
    classic n-1-step ring schedule along ``i -> (i + stride) % n``.
    Returns the fully reduced chunk owned by this rank: chunk index
    ``(i + stride) % n`` of the flattened payload — pass
    ``chunk_offset=stride`` to :func:`ring_all_gather` to reassemble.
    """
    i, ranks = _ring(axis, mesh)
    n = len(ranks)
    flat = x.reshape(-1)
    if n == 1:
        return flat
    _check_stride(stride, n)
    return _timed(lambda: _reduce_scatter_rings(
        [flat], [stride], i, ranks, log)[0], log)


def ring_all_gather(x: torch.Tensor, axis, stride: int,
                    chunk_offset: int = 0, *, mesh,
                    log: Optional[WireLog] = None) -> torch.Tensor:
    """Ring all-gather over ``axis`` with the given stride.

    ``x`` is this rank's chunk; rank ``i`` holds chunk index
    ``(i + chunk_offset) % n``.  Returns the flat concatenation of all n
    chunks in chunk-index order (the same on every rank), via n-1
    point-to-point steps along the same ring as the reduce-scatter.
    """
    i, ranks = _ring(axis, mesh)
    n = len(ranks)
    chunk = x.reshape(-1)
    if n == 1:
        return chunk
    _check_stride(stride, n)
    return _timed(lambda: _all_gather_rings(
        [chunk], [stride], [chunk_offset], i, ranks, log)[0], log)


def multiring_all_reduce(x: torch.Tensor, axis, strides: Sequence[int], *,
                         mesh, log: Optional[WireLog] = None
                         ) -> torch.Tensor:
    """All-reduce (sum) via R stride rings: the payload is split R ways
    (element e rides ring e % R) and ring r reduce-scatters and
    all-gathers its slice along ``i -> (i + strides[r]) % n``.  Any dtype
    with addition: f32 and bf16 gradients, the int32 payloads of the
    int8 error-feedback wire."""
    strides = tuple(strides)
    if not strides:
        raise ValueError("need at least one stride")
    i, ranks = _ring(axis, mesh)
    n = len(ranks)
    if n == 1:
        return x
    for s in strides:
        _check_stride(s, n)
    r = len(strides)
    flat = x.reshape(-1)
    m0 = flat.shape[0]
    per = -(-m0 // (n * r)) * n          # per-ring slice, divisible by n
    if per * r != m0:
        flat = torch.cat([flat, flat.new_zeros((per * r - m0,))])
    # interleave the payload across rings (element e rides ring e % r), so
    # that every ring carries real data even when padding was needed.
    parts = flat.reshape(per, r)

    def run():
        reduced = _reduce_scatter_rings(
            [parts[:, ri] for ri in range(r)], strides, i, ranks, log)
        return _all_gather_rings(reduced, strides, strides, i, ranks, log)

    outs = _timed(run, log)
    return torch.stack(outs, dim=1).reshape(-1)[:m0].reshape(x.shape)
