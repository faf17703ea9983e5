"""Fault injection: seeded failure masks, degraded layer stacks, churn.

Four pieces, each the JAX package's semantics bit for bit:

1. **Failure masks** (:func:`failure_mask`) — seeded sets of dead links,
   one uniform per link drawn from ``fold_in(key, link_id)``
   (:func:`link_uniforms`, the draws of :func:`repro_torch.core.arrivals
   .flow_uniforms`), so a draw depends only on the scenario key and the
   link's canonical id.  Patterns: ``bernoulli`` (each undirected link
   independently), ``switch`` (each router, with every incident link)
   and ``blast`` (the ``ceil(rate * n_links)`` links nearest the router
   with the smallest uniform, by hop distance — boolean APSP on the key's
   device — ties by link id).  All three are nested in ``rate``.

2. **Static degradation** (:func:`apply_failures`) — ``mode="repair"``
   re-resolves every layer's tables on its masked adjacency (APSP and
   forwarding on the stack's device); ``mode="drop"`` keeps the pristine
   tables and invalidates each entry whose walk crosses a dead link
   (:func:`repro_torch.core.paths.table_validity_batched`).  An empty
   mask returns the input stack itself.

3. **Mid-run link death** (:func:`link_down_schedule`) — a per-link death
   step that the transport scan turns into a capacity mask.

4. **Link churn** (:func:`churn_schedule`, :func:`churn_summary`) —
   per-link sorted ``(down, up)`` outage intervals (``flap``, ``rolling``,
   ``repair``) drawn as seeded renewal processes; host float64 numpy over
   the same uniforms.

Masks, schedules and reports are host numpy; the degraded tables are
tensors on the stack's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import prng
from . import paths as paths_mod
from .layers import _UNREACH, LayeredRouting

__all__ = ["PATTERNS", "CHURN_PATTERNS", "scenario_key", "link_uniforms",
           "link_uniforms_m", "failure_mask", "apply_failures",
           "link_down_schedule", "churn_schedule", "churn_summary",
           "FailureReport"]

PATTERNS = ("bernoulli", "switch", "blast")
CHURN_PATTERNS = ("flap", "rolling", "repair")

_INT32_MAX = np.iinfo(np.int32).max


def scenario_key(seed: int, fseed: int = 0, device="cuda") -> torch.Tensor:
    """PRNG key for one failure scenario: ``fold_in(fold_in(PRNGKey(0xFA1),
    seed), fseed)``.  It does not depend on the routing scheme, so every
    scheme of a cell seed faces the same dead links."""
    base = prng.fold_in(prng.PRNGKey(0xFA1, device), int(seed))
    return prng.fold_in(base, int(fseed))


def _uniforms_by_id(key: torch.Tensor, ids, shape: Tuple[int, ...]
                    ) -> np.ndarray:
    """``(len(ids),) + shape`` U(0,1) draws: one batched ``fold_in`` of
    ``key`` over the ids, then ``uniform(·, shape)`` per key, on the key's
    device; returned as host float64."""
    ids = np.asarray(ids, dtype=np.uint32)
    if ids.size == 0:
        return np.zeros((0,) + shape, dtype=np.float64)
    keys = prng.fold_in(key, torch.as_tensor(ids.astype(np.int64),
                                             device=key.device))
    return prng.uniform(keys, shape).double().cpu().numpy()


def link_uniforms(key: torch.Tensor, ids) -> np.ndarray:
    """One U(0,1) per integer id, drawn from ``fold_in(key, id)``: the
    draw for an id is independent of every other id present."""
    return _uniforms_by_id(key, ids, ())


def link_uniforms_m(key: torch.Tensor, ids, m: int) -> np.ndarray:
    """``(len(ids), m)`` U(0,1) draws; row ``i`` depends only on
    ``(key, ids[i])`` and ``m`` (renewal sequences)."""
    return _uniforms_by_id(key, ids, (int(m),))


def _undirected_links(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.nonzero(np.triu(np.asarray(adj, dtype=bool), 1))


def failure_mask(key: torch.Tensor, adj: np.ndarray, rate: float,
                 pattern: str = "bernoulli") -> np.ndarray:
    """(N, N) bool symmetric mask of dead links for one scenario.

    Link ids are canonical (``u * N + v`` with u < v); router draws use
    the disjoint ids ``N*N + r``."""
    if pattern not in PATTERNS:
        raise ValueError(f"unknown failure pattern {pattern!r}; "
                         f"choose from {PATTERNS}")
    a = np.asarray(adj, dtype=bool)
    n = a.shape[0]
    iu, ju = _undirected_links(a)
    dead = np.zeros((n, n), dtype=bool)
    rate = float(rate)
    if len(iu) == 0 or rate <= 0.0:
        return dead
    if pattern == "bernoulli":
        kill = link_uniforms(key, iu.astype(np.int64) * n + ju) < rate
    elif pattern == "switch":
        down = link_uniforms(key, n * n + np.arange(n)) < rate
        kill = down[iu] | down[ju]
    else:
        epi = int(np.argmin(link_uniforms(key, n * n + np.arange(n))))
        hops = paths_mod.shortest_path_lengths(
            a, max_l=64, device=key.device)[epi].cpu().numpy().astype(np.int64)
        k = int(np.ceil(rate * len(iu)))
        order = np.lexsort((iu.astype(np.int64) * n + ju,
                            np.minimum(hops[iu], hops[ju])))
        kill = np.zeros(len(iu), dtype=bool)
        kill[order[:k]] = True
    dead[iu[kill], ju[kill]] = True
    dead[ju[kill], iu[kill]] = True
    return dead


@dataclasses.dataclass(frozen=True)
class FailureReport:
    """Host-side summary of one applied failure scenario."""

    failed_links: int          # undirected links killed
    total_links: int
    rate: float
    pattern: str
    mode: str
    dead_layers: int           # layers left with no usable off-diag pair
    disconnected_pairs: int    # router pairs reachable before, by no layer now
    down_step: int = -1        # mid-run death step (-1 = static/pre-run)

    def as_meta(self) -> Dict[str, object]:
        """JSON-safe dict merged into cell meta."""
        return {
            "failed_links": int(self.failed_links),
            "total_links": int(self.total_links),
            "failure_rate": float(self.rate),
            "failure_pattern": str(self.pattern),
            "failure_mode": str(self.mode),
            "dead_layers": int(self.dead_layers),
            "disconnected_pairs": int(self.disconnected_pairs),
            "link_down_step": int(self.down_step),
        }


def _count_report(lr: LayeredRouting, reach_before: np.ndarray,
                  reach_after: np.ndarray, dead: np.ndarray, rate: float,
                  pattern: str, mode: str, down_step: int = -1
                  ) -> FailureReport:
    n = reach_before.shape[1]
    off = ~np.eye(n, dtype=bool)
    before_l = (reach_before & off[None]).any(axis=(1, 2))
    after_l = (reach_after & off[None]).any(axis=(1, 2))
    pair_before = reach_before.any(axis=0) & off
    pair_after = reach_after.any(axis=0) & off
    iu, _ = _undirected_links(lr.topo.adj)
    return FailureReport(
        failed_links=int(np.triu(dead, 1).sum()),
        total_links=int(len(iu)),
        rate=float(rate),
        pattern=pattern,
        mode=mode,
        dead_layers=int((before_l & ~after_l).sum()),
        disconnected_pairs=int((pair_before & ~pair_after).sum()),
        down_step=int(down_step),
    )


def apply_failures(lr: LayeredRouting, dead: np.ndarray,
                   mode: str = "repair", seed: int = 0,
                   rate: float = 0.0, pattern: str = "bernoulli",
                   max_len: Optional[int] = None
                   ) -> Tuple[LayeredRouting, FailureReport]:
    """Degraded copy of ``lr`` under the dead-link mask (pre-run damage),
    built on the stack's device.

    ``mode="repair"``: every layer's tables are rebuilt on its masked
    adjacency (APSP + forwarding through the engine resolved at this
    size, key ``fold_in(PRNGKey(seed), 0xF1)``,
    ``max_len = max(6, diameter_nominal + 6)`` by default).
    ``mode="drop"``: the pristine tables are kept and every entry whose
    walk crosses a dead link is invalidated; layers left with no usable
    off-diagonal pair are cleared.  An empty mask returns ``lr`` itself."""
    dead = np.asarray(dead, dtype=bool)
    reach_before = lr.reach.cpu().numpy()
    if not dead.any():
        return lr, _count_report(lr, reach_before, reach_before, dead, rate,
                                 pattern, mode)
    if mode not in ("repair", "drop"):
        raise ValueError(f"unknown failure mode {mode!r}")
    dev = lr.nh.device
    n = dead.shape[0]
    idx = torch.arange(n, device=dev)
    masked_la = lr.layer_adj & ~torch.as_tensor(dead, device=dev)[None]

    if mode == "repair":
        if max_len is None:
            # Re-converged paths detour around failures: build slack + 2.
            max_len = max(6, lr.topo.diameter_nominal + 6)
        union = masked_la.any(dim=0).cpu().numpy()
        nbr = torch.as_tensor(paths_mod.neighbor_table(union), device=dev)
        key = prng.fold_in(prng.PRNGKey(int(seed), dev), 0xF1)
        eng = paths_mod.path_engine(n)
        # The masked union is asymmetric where one direction of a link
        # died: the frontier APSP relaxes over its in-neighbors.
        nbr_in = (torch.as_tensor(paths_mod.neighbor_table(union.T),
                                  device=dev) if eng == "blocked" else None)
        nh, reach, dist = paths_mod._layer_tables_core(masked_la, nbr, key,
                                                       max_len, eng, nbr_in)
        pathlen = torch.where(reach, dist, _UNREACH).to(torch.int16)
    else:
        # Walks take exactly pathlen hops (shortest-path forwarding), so
        # the stack's longest reachable path bounds the fixpoint depth.
        reached = lr.pathlen[lr.reach]
        max_hops = max(1, int(reached.max()) if reached.numel() else 1) + 1
        valid = paths_mod.table_validity_batched(
            lr.nh, torch.as_tensor(~dead, device=dev), max_hops)
        reach = lr.reach & valid
        off = ~torch.eye(n, dtype=torch.bool, device=dev)
        layer_dead = ~(reach & off[None]).flatten(1).any(dim=1)
        reach = reach & ~layer_dead[:, None, None]
        nh = torch.where(reach, lr.nh, -1).to(torch.int32)
        nh[:, idx, idx] = idx.to(torch.int32)
        pathlen = torch.where(reach, lr.pathlen, _UNREACH).to(torch.int16)

    report = _count_report(lr, reach_before, reach.cpu().numpy(), dead, rate,
                           pattern, mode)
    # The tables changed, so a compressed form of the pristine stack is
    # stale; one is attached again iff the input carried one, with the
    # auto block (repair redistributes next hops, so the input's block
    # may no longer fit the uint8 selector).
    compressed = None
    if lr.compressed is not None:
        compressed = paths_mod.CompressedTables.from_dense(nh)
    degraded = dataclasses.replace(
        lr, nh=nh, reach=reach, pathlen=pathlen, layer_adj=masked_la,
        build_stats=None, link_down_step=None, link_churn=None,
        compressed=compressed)
    return degraded, report


def link_down_schedule(dead: np.ndarray, step: int) -> np.ndarray:
    """(N, N) int32 per-directed-link death step for mid-run failures:
    masked links die at scan step ``step``, the others carry INT32_MAX."""
    dead = np.asarray(dead, dtype=bool)
    sym = dead | dead.T
    return np.where(sym, np.int32(step),
                    np.int32(_INT32_MAX)).astype(np.int32)


def _duration_steps(u: np.ndarray, mean: float, proc: str,
                    shape: float) -> np.ndarray:
    """Uniforms -> integer durations (>= 1 step) with the given mean:
    ``proc="exp"`` inverse-CDF exponential, ``proc="pareto"`` a
    Pareto-II/Lomax with tail index ``shape`` (> 1 so the mean exists)."""
    mean = max(float(mean), 1.0)
    if proc == "exp":
        d = -mean * np.log1p(-u)
    elif proc == "pareto":
        if shape <= 1.0:
            raise ValueError(f"pareto churn needs shape > 1, got {shape}")
        d = mean * (shape - 1.0) * ((1.0 - u) ** (-1.0 / shape) - 1.0)
    else:
        raise ValueError(f"unknown churn process {proc!r}; "
                         f"choose from ('exp', 'pareto')")
    return np.maximum(1, np.rint(d)).astype(np.int64)


def churn_schedule(key: torch.Tensor, adj: np.ndarray, rate: float,
                   pattern: str = "flap", mtbf: float = 120.0,
                   mttr: float = 40.0, events: int = 4,
                   proc: str = "exp", shape: float = 1.5) -> np.ndarray:
    """(N, N, K, 2) int32 symmetric per-link ``(down, up)`` churn
    intervals for one scenario.

    Per link the intervals are sorted and disjoint, ``1 <= down_0 < up_0
    < down_1 < ...``, padded with ``(INT32_MAX, INT32_MAX)``.  ``flap``
    and ``repair`` churn the ``bernoulli`` dead set of the same key and
    rate, so they are nested in ``rate``; every event draw is keyed by
    ``fold_in(key, 2*N*N + link_id)``.  ``rolling`` takes switch groups
    of ``round(rate * N)`` routers down one after another for ``mttr``
    steps, ``mtbf`` steps apart."""
    if pattern not in CHURN_PATTERNS:
        raise ValueError(f"unknown churn pattern {pattern!r}; "
                         f"choose from {CHURN_PATTERNS}")
    a = np.asarray(adj, dtype=bool)
    n = a.shape[0]
    iu, ju = _undirected_links(a)
    rate = float(rate)
    k_ev = 2 if pattern == "rolling" else (1 if pattern == "repair"
                                           else max(1, int(events)))
    sched = np.full((n, n, k_ev, 2), _INT32_MAX, dtype=np.int32)
    if len(iu) == 0 or rate <= 0.0:
        return sched
    lid = iu.astype(np.int64) * n + ju
    ev_ids = 2 * n * n + lid               # disjoint from mask id spaces

    if pattern == "flap":
        churning = link_uniforms(key, lid) < rate      # == bernoulli set
        if not churning.any():
            return sched
        cid = ev_ids[churning]
        u = link_uniforms_m(key, cid, 2 * k_ev)
        alive = _duration_steps(u[:, 0::2], mtbf, proc, shape)
        rep = _duration_steps(u[:, 1::2], mttr, proc, shape)
        # Alternate alive/repair and cumsum: down_k = end of the k-th
        # alive stretch, up_k = down_k + repair_k; events pushed past
        # INT32_MAX become sentinels.
        inter = np.empty((len(cid), 2 * k_ev), dtype=np.int64)
        inter[:, 0::2] = alive
        inter[:, 1::2] = rep
        c = np.minimum(np.cumsum(inter, axis=1), _INT32_MAX)
        ev = np.stack([c[:, 0::2], c[:, 1::2]], axis=2).astype(np.int32)
        ev[ev[..., 0] >= _INT32_MAX] = _INT32_MAX
        sched[iu[churning], ju[churning]] = ev
    elif pattern == "repair":
        churning = link_uniforms(key, lid) < rate      # == bernoulli set
        if not churning.any():
            return sched
        u = link_uniforms_m(key, ev_ids[churning], 1)[:, 0]
        rep = _duration_steps(u, mttr, proc, shape)
        ev = np.stack([np.ones_like(rep), 1 + rep], axis=1)
        sched[iu[churning], ju[churning], 0] = \
            np.minimum(ev, _INT32_MAX).astype(np.int32)
    else:  # rolling maintenance windows over switch groups
        gsize = max(1, int(round(rate * n)))
        group = np.arange(n) // gsize
        w = max(1, int(round(mttr)))       # window length
        gap = max(1, int(round(mtbf)))     # quiet time before/between
        n_groups = int(group.max()) + 1
        down_g = gap + np.arange(n_groups, dtype=np.int64) * (w + gap)
        up_g = down_g + w
        ga, gb = group[iu], group[ju]
        first, second = np.minimum(ga, gb), np.maximum(ga, gb)
        ev = np.full((len(iu), k_ev, 2), _INT32_MAX, dtype=np.int64)
        ev[:, 0, 0] = down_g[first]
        ev[:, 0, 1] = up_g[first]
        both = second != first             # endpoint groups differ: 2 events
        ev[both, 1, 0] = down_g[second][both]
        ev[both, 1, 1] = up_g[second][both]
        sched[iu, ju] = np.minimum(ev, _INT32_MAX).astype(np.int32)
    return np.minimum(sched, np.swapaxes(sched, 0, 1))


def churn_summary(sched: np.ndarray) -> Dict[str, int]:
    """Churned undirected links, real events, and the first down step
    (-1 for an empty schedule) — JSON-safe, merged into cell meta."""
    downs = np.asarray(sched)[..., 0]
    tri = np.triu(np.ones(downs.shape[:2], dtype=bool), 1)
    ev = (downs < _INT32_MAX) & tri[..., None]
    n_events = int(ev.sum())
    first = int(downs[ev].min()) if n_events else -1
    return {"churn_links": int(ev.any(axis=-1).sum()),
            "churn_events": n_events, "churn_first_down": first}
