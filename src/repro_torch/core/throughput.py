"""Maximum achievable throughput (MAT) via multicommodity flow (paper §6.4).

Path-based LP, TopoBench-style, extended with FatPaths layers: the candidate
paths of a demand are the realised routes of each usable layer, so the LP
measures exactly what the layered routing can deliver.

  maximise    T
  subject to  sum_p x[d, p]          = demand_d * T      (all demands d)
              sum_{(d,p) using e} x  <= capacity_e       (all edges e)
              x >= 0

The paper adds an integer constraint (a flow may not split across layers);
we solve the LP relaxation and additionally report a greedy single-layer
rounding (`mat_single_layer`), which lower-bounds the integral optimum.
Solved with scipy's HiGHS on the host.

The candidate paths come from the stack's own tables: every usable
(demand, layer) is walked in one batched walk on the tables' device
(:func:`repro_torch.core.layers.usable_walks`); the LP, the greedy and
the path assembly run on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import scipy.optimize
import scipy.sparse as sp

from .layers import LayeredRouting, usable_walks, walk_edges
from .traffic import FlowWorkload

__all__ = ["MATResult", "router_demands", "mat_lp", "mat_single_layer"]


@dataclasses.dataclass
class MATResult:
    throughput: float          # T (flow units per unit capacity)
    n_demands: int
    n_paths: int
    status: str


def router_demands(wl: FlowWorkload, n_routers: int) -> Dict[Tuple[int, int], float]:
    """Aggregate endpoint flows into router-pair demands T(s, t)."""
    d: Dict[Tuple[int, int], float] = {}
    for s, t in zip(wl.src_router, wl.dst_router):
        if s == t:
            continue
        d[(int(s), int(t))] = d.get((int(s), int(t)), 0.0) + 1.0
    return d


def _candidate_paths(routing: LayeredRouting,
                     demands: Dict[Tuple[int, int], float],
                     max_hops: int) -> List[List[List[int]]]:
    """Per demand: deduplicated list of edge-id paths, one per usable layer.

    A walk is read hop by hop until it stands on ``t`` or meets a hole; it
    is kept if every hop read is an edge, at least one was, and ``t``
    appears anywhere in the walk; the first of equal paths is kept."""
    keys = list(demands)
    out: List[List[List[int]]] = [[] for _ in keys]
    if not keys:
        return out
    s = np.array([k[0] for k in keys], dtype=np.int64)
    t = np.array([k[1] for k in keys], dtype=np.int64)
    pair, _, seqs = usable_walks(routing, s, t, max_hops)
    tw = t[pair]
    edges, stop = walk_edges(seqs, tw, routing.topo.edge_index_matrix())
    read = np.arange(edges.shape[1])[None, :] < stop[:, None]
    ok = ~((edges < 0) & read).any(axis=1)
    reached = (seqs == tw[:, None]).any(axis=1)
    seen = [set() for _ in keys]
    for w in np.nonzero(ok & (stop > 0) & reached)[0]:
        path = edges[w, :stop[w]].tolist()
        key = tuple(path)
        di = pair[w]
        if key not in seen[di]:
            seen[di].add(key)
            out[di].append(path)
    return out


def mat_lp(routing: LayeredRouting, wl: FlowWorkload,
           max_hops: int = 16, capacity: float = 1.0) -> MATResult:
    """LP-relaxed MAT for a layered routing and a workload."""
    topo = routing.topo
    demands = router_demands(wl, topo.n_routers)
    if not demands:
        return MATResult(float("inf"), 0, 0, "empty")
    dkeys = list(demands)
    paths = _candidate_paths(routing, demands, max_hops)
    n_edges = int(topo.adj.sum())  # directed edges

    # Variables: one per (demand, path), then T last.
    var_of: List[Tuple[int, List[int]]] = []
    for di, plist in enumerate(paths):
        for p in plist:
            var_of.append((di, p))
    nv = len(var_of) + 1
    if not var_of:
        return MATResult(0.0, len(dkeys), 0, "no-paths")

    # Equality: per demand, sum of its path vars - demand*T = 0.
    eq_r, eq_c, eq_v = [], [], []
    for vi, (di, _) in enumerate(var_of):
        eq_r.append(di)
        eq_c.append(vi)
        eq_v.append(1.0)
    for di, k in enumerate(dkeys):
        eq_r.append(di)
        eq_c.append(nv - 1)
        eq_v.append(-demands[k])
    A_eq = sp.coo_matrix((eq_v, (eq_r, eq_c)), shape=(len(dkeys), nv)).tocsr()
    b_eq = np.zeros(len(dkeys))

    # Capacity: per directed edge.
    ub_r, ub_c, ub_v = [], [], []
    for vi, (_, p) in enumerate(var_of):
        for e in p:
            ub_r.append(e)
            ub_c.append(vi)
            ub_v.append(1.0)
    A_ub = sp.coo_matrix((ub_v, (ub_r, ub_c)), shape=(n_edges, nv)).tocsr()
    b_ub = np.full(n_edges, capacity)

    c = np.zeros(nv)
    c[-1] = -1.0
    res = scipy.optimize.linprog(
        c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
        bounds=[(0, None)] * nv, method="highs")
    t = float(res.x[-1]) if res.status == 0 else 0.0
    return MATResult(t, len(dkeys), len(var_of), res.message if res.status else "optimal")


def mat_single_layer(routing: LayeredRouting, wl: FlowWorkload,
                     max_hops: int = 16, capacity: float = 1.0) -> MATResult:
    """Greedy integral variant: each demand picks ONE path (its shortest,
    then least-loaded); T = min over edges of capacity / load (max-min)."""
    topo = routing.topo
    demands = router_demands(wl, topo.n_routers)
    if not demands:
        return MATResult(float("inf"), 0, 0, "empty")
    paths = _candidate_paths(routing, demands, max_hops)
    n_edges = int(topo.adj.sum())
    load = np.zeros(n_edges)
    n_paths = 0
    for (key, plist) in zip(demands, paths):
        if not plist:
            continue
        n_paths += len(plist)
        best, best_cost = None, None
        for p in plist:
            cost = (len(p), float(load[p].max()) if p else 0.0)
            if best is None or cost < best_cost:
                best, best_cost = p, cost
        load[best] += demands[key]
    mx = load.max()
    t = float(capacity / mx) if mx > 0 else float("inf")
    return MATResult(t, len(demands), n_paths, "greedy")
