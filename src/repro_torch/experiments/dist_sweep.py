"""Batched sweep engine: a grid's transport cells as a few union scans.

The sequential :meth:`Session.sweep` runs one scan per (cell, sim-seed),
and every step of each scan issues its ~40-70 device launches on its own.
This engine runs a bucket of compatible (cell, sim-seed) elements as one
scan over the union of their flows:

1. **bucket**: transport cells are grouped by :func:`padded_signature`:
   the same :class:`~repro_torch.core.transport.SimConfig` (seed aside),
   the same layer count L, the same power-of-two size class of flow and
   virtual-link counts (so padding at most doubles a cell), and the same
   fault lanes (mid-run death, churn with K event slots);
2. **pad**: each cell's scan operands are padded to the bucket's maxima
   (:func:`~repro_torch.core.transport.pad_prepared`): padded flows never
   start, padded hop slots go to the trash link, padded links are never
   indexed;
3. **union**: the bucket's elements become one flow set over disjoint
   link ranges (:func:`~repro_torch.core.transport.union_prepared`), so a
   step issues the same launches for all of them, one water-filling
   launch included.  Each element draws from its own key with its local
   flow index, its link sums run in its own order, its rollback rounds
   by its own flow count and its horizon ends where it would alone;
4. **devices**: ``devices=N`` splits a bucket's elements into N
   contiguous shards, one union scan each, or runs a bucket with fewer
   elements than devices whole on device ``bucket % N``.  On a ``cuda``
   session the devices are ``cuda:0..N-1`` (more than are visible
   raises); on a ``cpu`` session they are N logical shards of the CPU.
   Buckets and shards run one after another.

Each step of that is exact, so every cell's result equals the
sequential engine's whatever the bucketing and the device count.  The
chunks each cell's scan ran are reported as ``sweep_chunks`` in its meta
(the most over its sim seeds), beside ``sweep_bucket``: execution
bookkeeping, which :func:`~repro_torch.experiments.results
.compare_results` ignores.

Sweeps are resumable: with a checkpoint directory every finished cell is
committed (:class:`repro_torch.ckpt.SweepCheckpoint`) and a re-run loads
completed cells (``sweep_resumed``) instead of simulating them again.
Other evaluators than ``transport`` run through the sequential path in
the same sweep and share its checkpointing.

Cells whose state comes back non-finite are quarantined: empty metrics
and an ``error`` meta field, never checkpointed, so a resume tries them
again.  A bucket whose scan raises is not retried on the plain version:
a CUDA tensor launches the kernel or raises, so the error propagates.

The returned list is in canonical grid order, whatever order the buckets
ran in (:func:`~repro_torch.experiments.results.order_results`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import prng
from ..ckpt.sweep import SweepCheckpoint
from ..core import transport as transport_mod
from .catalog import EVALUATORS, fct_metrics, transport_meta, transport_plan
from .results import RunResult, order_results
from .session import ResolvedCell, Session
from .specs import ExperimentSpec

__all__ = ["dist_sweep", "bucket_signature", "padded_signature",
           "resumed_result"]


@dataclasses.dataclass
class _Work:
    """One transport cell planned for batched execution.  Only its shape
    signature is computed up front; its scan operands are built when its
    bucket runs, so peak memory follows one bucket, not the grid."""

    spec: ExperimentSpec
    cell: ResolvedCell
    cfg: Any                     # SimConfig (seed = the cell's seed)
    sim_seeds: List[int]
    n_flows: int
    e_tot: int
    n_layers: int
    ev_meta: Dict[str, Any]
    pre: Dict[str, float]
    post: Dict[str, float]
    resolve_s: float


def resumed_result(ckpt: Optional[SweepCheckpoint],
                   cell_id: str) -> Optional[RunResult]:
    """The checkpointed RunResult of ``cell_id`` marked ``sweep_resumed``,
    or None when there is no checkpoint or no finished record of it."""
    prev = ckpt.get(cell_id) if ckpt is not None else None
    if prev is None:
        return None
    rr = RunResult.from_dict(prev)
    return dataclasses.replace(rr, meta={**rr.meta, "sweep_resumed": True})


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def bucket_signature(cfg, static) -> tuple:
    """The batch-compatibility key of a prepared transport cell: the
    SimConfig with the seed normalized away (keys are operands) and the
    layer count L, which is never padded (it would change layer draws)."""
    return (dataclasses.replace(cfg, seed=0), static[1])


def padded_signature(cfg, n_layers: int, n_flows: int, e_tot: int,
                     link_down: bool = False, churn_k: int = 0) -> tuple:
    """The key cells are bucketed by: :func:`bucket_signature` plus the
    power-of-two size classes of the flow and virtual-link counts (cells
    of a bucket pay each other's padding, so the classes bound it at 2x),
    whether the cell has a mid-run death schedule (an extra lane), and
    the churn schedule's event-slot count K (0 = none), which is never
    padded."""
    return (dataclasses.replace(cfg, seed=0), n_layers,
            _ceil_pow2(n_flows), _ceil_pow2(e_tot), bool(link_down),
            int(churn_k))


def _devices(session: Session, devices: Optional[int]) -> List[torch.device]:
    n = 1 if devices is None else int(devices)
    if n < 1:
        raise ValueError(f"devices={n}: need at least one")
    if session.device.type != "cuda":
        return [session.device] * n          # logical shards of the CPU
    have = torch.cuda.device_count()
    if n > have:
        raise RuntimeError(f"devices={n} asked for, but {have} CUDA "
                           "device(s) are visible")
    if n == 1:
        return [session.device]
    return [torch.device("cuda", i) for i in range(n)]


def _placement(n_elem: int, devs: List[torch.device], bucket_index: int):
    """``(mode, [(device, element indices)])`` by the reference's policy:
    one device runs the bucket whole; at least as many elements as
    devices split into contiguous shards over all of them; fewer go whole
    to one device, round-robin by bucket."""
    n_dev = len(devs)
    if n_dev == 1:
        return "union", [(devs[0], list(range(n_elem)))]
    if n_elem >= n_dev:
        per = -(-n_elem // n_dev)
        return f"shard[{n_dev}]", [
            (devs[d], list(range(d * per, min(n_elem, (d + 1) * per))))
            for d in range(n_dev) if d * per < n_elem]
    d = bucket_index % n_dev
    return f"device[{d}]", [(devs[d], list(range(n_elem)))]


def _run_shard(padded, keys, n_real, cfg, static, dev):
    """One union scan of a shard's padded elements on ``dev``; one host
    dict per element."""
    elements = [{k: v.to(dev) for k, v in a.items()} for a in padded]
    arrs, ustatic = transport_mod.union_prepared(elements, static)
    del elements
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        final = transport_mod._run_scan(arrs, keys.to(dev), cfg, ustatic,
                                        n_real=n_real)
    return transport_mod.split_union(final, len(padded))


def _run_bucket(works: List[_Work], devs: List[torch.device],
                bucket_index: int, device: torch.device):
    """Prepare, pad and run one bucket.  Returns ``(sims, chunks, mode,
    pads, n_elem)``: per cell its SimResults (one per sim seed, padding
    stripped) and its most chunks over its seeds."""
    cfg0 = dataclasses.replace(works[0].cfg, seed=0)
    prepared = [transport_mod.prepare(w.cell.topo, w.cell.bundle.routing,
                                      w.cell.workload, w.cfg, device=device)
                for w in works]
    host = [(a["size"].cpu().numpy(), a["start"].cpu().numpy())
            for a, _ in prepared]
    n_flows = max(w.n_flows for w in works)
    n_edges = max(w.e_tot for w in works)
    hop_slots = max(a["path_edges"].shape[2] for a, _ in prepared)
    padded, static = [], None
    for arrs, st in prepared:
        p, static = transport_mod.pad_prepared(
            arrs, st, n_flows=n_flows, n_edges=n_edges, hop_slots=hop_slots)
        padded.append(p)
    del prepared
    elements = [(wi, s) for wi, w in enumerate(works) for s in w.sim_seeds]
    mode, shards = _placement(len(elements), devs, bucket_index)
    finals: List[Dict] = []
    for dev, idx in shards:
        keys = torch.stack([prng.PRNGKey(elements[i][1], "cpu")
                            for i in idx])
        finals += _run_shard([padded[elements[i][0]] for i in idx], keys,
                             [works[elements[i][0]].n_flows for i in idx],
                             cfg0, static, dev)
    sims: Dict[int, list] = {wi: [] for wi in range(len(works))}
    chunks: Dict[int, int] = {wi: 0 for wi in range(len(works))}
    for (wi, s), final in zip(elements, finals):
        w = works[wi]
        size, start = host[wi]
        sims[wi].append(transport_mod.batch_result(
            size, final, dataclasses.replace(w.cfg, seed=s),
            n_flows=w.n_flows, start=start))
        chunks[wi] = max(chunks[wi], int(final["horizon_chunks"]))
    return sims, chunks, mode, (n_flows, n_edges, hop_slots), len(elements)


def dist_sweep(session: Session, cells: List[ExperimentSpec], *,
               devices: Optional[int] = None,
               checkpoint_dir: Optional[str] = None,
               callback: Optional[Callable[[RunResult], None]] = None,
               log: Optional[Callable[[str], None]] = None
               ) -> List[RunResult]:
    """Run ``cells`` through the batched engine (module docstring).

    ``devices=None`` or ``1`` runs each bucket as one union scan on the
    session's device; results are identical for every device count.  The
    returned list is in the order of ``cells``."""
    devs = _devices(session, devices)
    ckpt = SweepCheckpoint(checkpoint_dir) if checkpoint_dir else None
    say = log if log is not None else (lambda _msg: None)

    def emit(rr: RunResult, done_via_ckpt: bool = False,
             persist: bool = True) -> RunResult:
        # Quarantined cells pass persist=False: a resume retries them.
        if ckpt is not None and not done_via_ckpt and persist:
            ckpt.put(rr.cell_id, rr.to_dict())
        if callback is not None:
            callback(rr)
        return rr

    results: List[RunResult] = []
    batched: List[_Work] = []
    n_resumed = 0
    for spec in cells:
        rr = resumed_result(ckpt, spec.cell_id)
        if rr is not None:
            results.append(emit(rr, done_via_ckpt=True))
            n_resumed += 1
            continue
        if spec.evaluator.name != "transport":
            # Other evaluators (outcast, recovery, ...): sequential path.
            results.append(emit(session.run(spec)))
            continue
        _, kw = EVALUATORS.resolve(spec.evaluator)
        t0 = time.perf_counter()
        pre = session.stats_snapshot()
        cell = session.resolve(spec)
        cfg, sim_seeds = transport_plan(cell, **kw)
        n_flows, e_tot, n_layers = transport_mod.shape_signature(
            cell.topo, cell.bundle.routing, cell.workload)
        batched.append(_Work(
            spec=spec, cell=cell, cfg=cfg, sim_seeds=sim_seeds,
            n_flows=n_flows, e_tot=e_tot, n_layers=n_layers,
            ev_meta=transport_meta(cell, cfg, sim_seeds),
            pre=pre, post=session.stats_snapshot(),
            resolve_s=time.perf_counter() - t0))
    if n_resumed:
        say(f"# resumed {n_resumed} completed cell(s) from checkpoint")

    buckets: Dict[tuple, List[_Work]] = {}
    for w in batched:
        lr = w.cell.bundle.routing
        lc = lr.link_churn
        buckets.setdefault(
            padded_signature(w.cfg, w.n_layers, w.n_flows, w.e_tot,
                             link_down=lr.link_down_step is not None,
                             churn_k=0 if lc is None else int(lc.shape[2])),
            []).append(w)

    t_sim = time.perf_counter()
    n_elems = 0
    for bi, works in enumerate(buckets.values()):
        t_run = time.perf_counter()
        sims, chunks, mode, (nf, ne, nh), n_elem = _run_bucket(
            works, devs, bi, session.device)
        bucket_wall = time.perf_counter() - t_run
        n_elems += n_elem
        say(f"# bucket {bi}: {len(works)} cells x seeds = {n_elem} "
            f"elements as {mode}, padded to F={nf} E={ne} H={nh}")
        for wi, w in enumerate(works):
            bad = [r for r in sims[wi]
                   if not (np.all(np.isfinite(r.delivered))
                           and np.isfinite(r.link_util_mean))]
            if bad:
                say(f"# bucket {bi}: non-finite simulation state for "
                    f"{w.spec.cell_id}; quarantining")
                results.append(emit(session.finish_result(
                    w.spec, w.cell, {}, w.ev_meta, w.pre, w.resolve_s,
                    extra_meta={"sweep_bucket": bi,
                                "error": {"type": "nonfinite",
                                          "seeds_bad": len(bad)}},
                    post=w.post), persist=False))
                continue
            wall = w.resolve_s + bucket_wall * len(w.sim_seeds) / n_elem
            results.append(emit(session.finish_result(
                w.spec, w.cell, fct_metrics(sims[wi]), w.ev_meta, w.pre,
                wall, extra_meta={"sweep_bucket": bi,
                                  "sweep_chunks": chunks[wi]},
                post=w.post)))
    if buckets:
        say(f"# {len(buckets)} bucket(s), {n_elems} elements, simulate "
            f"wall {time.perf_counter() - t_sim:.2f}s on {len(devs)} "
            "device(s)")
    return order_results(results, [c.cell_id for c in cells])
