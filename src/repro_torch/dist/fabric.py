"""Cluster-fabric model: collective traffic -> link loads under ECMP vs
FatPaths routing (paper §8 applied to collective traffic).

``ClusterFabric`` routes the flow set of a collective over a
:class:`repro_torch.core.topology.Topology`:

* ``scheme="ecmp"``    — congestion-oblivious hashing: every flow splits
  equally over ``n_tables`` independently tie-broken *minimal-path*
  forwarding tables (:func:`repro_torch.core.transport.ecmp_routing`).
  Where minimal-path diversity is 1 (most pairs of a diameter-2 Slim Fly)
  the tables coincide and the split degenerates — the paper's collision
  pathology.
* ``scheme="fatpaths"``— congestion-aware flowlets over the FatPaths
  layer stack (:func:`repro_torch.core.layers.build_layers`): candidate
  paths are the realised routes of every usable layer (minimal +
  non-minimal), and per-flow weights iterate toward the min-max link load
  — the steady state of flowlet re-routing away from hot links.

Endpoint NICs are modelled as injection/ejection links (scheme
independent), so incast patterns (all-to-one) bottleneck on the NIC for
both schemes exactly as on a real cluster.

The stacks live on the device they were built on.  The candidate paths
of all router pairs an :meth:`ClusterFabric.evaluate_flows` call needs
and has not seen yet come out of one batched table walk there
(:func:`repro_torch.core.layers.usable_walks`); the load assignment, a
sequential greedy over float64 loads, runs on the host.

The result, :class:`CollectiveReport`, carries ``bottleneck_bytes`` (max
bytes over any link), ``time_s`` (bottleneck / line rate), ``util_gini``
(spread of fabric-link loads) and ``n_links_used``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import resolve_device
from ..core.layers import (LayeredRouting, build_layers, usable_walks,
                           walk_edges)
from ..core.topology import Topology
from ..core.traffic import endpoint_router_map
from ..core.transport import ecmp_routing

__all__ = ["ClusterFabric", "CollectiveReport", "collective_flows"]

Flow = Tuple[int, int, float]            # (src endpoint, dst endpoint, bytes)


# -----------------------------------------------------------------------------
# Collective -> endpoint flow sets.
# -----------------------------------------------------------------------------
def collective_flows(kind: str, n: int, nbytes: float,
                     strides: Sequence[int] = (1,)) -> List[Flow]:
    """Endpoint-level flows of one collective over ranks 0..n-1.

    ``nbytes`` is the per-rank payload.  Ring collectives follow the
    standard schedule volumes — all-reduce moves ``2 b (n-1)/n`` per ring
    link, all-gather/reduce-scatter half that — split over the given
    stride rings (``strides``), mirroring
    the multi-ring all-reduce over
    :func:`repro_torch.dist.collectives.layer_strides` rings.
    """
    kind = kind.replace("-start", "")
    r = max(1, len(strides))
    flows: List[Flow] = []
    if kind in ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute"):
        if kind == "all-reduce":
            per_link = 2.0 * nbytes * (n - 1) / max(n, 1) / r
        elif kind == "collective-permute":
            per_link = float(nbytes) / r
        else:
            per_link = nbytes * (n - 1) / max(n, 1) / r
        for s in strides:
            for i in range(n):
                j = (i + s) % n
                if i != j:
                    flows.append((i, j, per_link))
        return flows
    if kind == "all-to-all":
        b = nbytes / max(n, 1)
        return [(i, j, b) for i in range(n) for j in range(n) if i != j]
    if kind == "all-to-one":
        return [(i, 0, float(nbytes)) for i in range(1, n)]
    raise ValueError(f"unknown collective kind {kind!r}")


# -----------------------------------------------------------------------------
# Report.
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CollectiveReport:
    """Link-load summary of one collective on one fabric."""

    kind: str
    scheme: str
    n_ranks: int
    payload_bytes: float
    bottleneck_bytes: float    # max bytes over any (fabric or NIC) link
    time_s: float              # bottleneck / line rate
    util_gini: float           # Gini coefficient of fabric-link loads
    n_links_used: int          # directed fabric links carrying traffic
    fabric_bytes: float        # total bytes over fabric links

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _gini(loads: np.ndarray) -> float:
    total = float(loads.sum())
    if total <= 0 or len(loads) == 0:
        return 0.0
    x = np.sort(loads.astype(np.float64))
    n = len(x)
    cum = np.arange(1, n + 1) @ x
    return float(2.0 * cum / (n * total) - (n + 1) / n)


# -----------------------------------------------------------------------------
# Fabric.
# -----------------------------------------------------------------------------
class ClusterFabric:
    """A modelled cluster: topology + FatPaths layers + ECMP tables."""

    def __init__(self, topo: Topology, n_layers: int = 9, rho: float = 0.6,
                 seed: int = 0, layer_scheme: str = "rand",
                 n_tables: int = 8, line_rate: float = 12.5e9,
                 flowlet_quanta: int = 32,
                 layers: Optional["LayeredRouting"] = None,
                 ecmp: Optional["LayeredRouting"] = None,
                 device="cuda"):
        """``layers``/``ecmp`` accept prebuilt stacks (matching the other
        parameters) so a :class:`repro_torch.experiments.Session` can share
        one stack between transport cells and the fabric model instead of
        rebuilding it here; stacks built here go on ``device``."""
        self.topo = topo
        self.n_layers = n_layers
        self.rho = rho
        self.seed = seed
        self.line_rate = line_rate
        self.flowlet_quanta = flowlet_quanta
        if layers is None or ecmp is None:
            device = resolve_device(device)
        self.layers = layers if layers is not None else build_layers(
            topo, n_layers, rho, scheme=layer_scheme, seed=seed,
            device=device)
        self.ecmp = ecmp if ecmp is not None else ecmp_routing(
            topo, n_tables=n_tables, seed=seed, device=device)
        self.ep2r = endpoint_router_map(topo)
        self._eix = topo.edge_index_matrix()
        self._n_edges = int(topo.adj.sum())
        pl = self.layers.pathlen
        longest = int(torch.where(pl < 9000, pl, -1).max()) if pl.numel() \
            else -1
        self._max_hops = (longest if longest >= 0 else 8) + 2
        self._path_cache: Dict[Tuple[str, int, int], List[np.ndarray]] = {}

    # ---- path candidates -----------------------------------------------------
    def _routing(self, scheme: str):
        if scheme == "fatpaths":
            return self.layers
        if scheme == "ecmp":
            return self.ecmp
        raise ValueError(f"unknown scheme {scheme!r} "
                         "(expected 'ecmp' or 'fatpaths')")

    def _pair_paths(self, scheme: str, s: int, t: int) -> List[np.ndarray]:
        """Per-layer/table edge-id paths for router pair (s, t)."""
        key = (scheme, s, t)
        if key not in self._path_cache:
            self._walk_pairs(scheme, [(s, t)])
        return self._path_cache[key]

    def _walk_pairs(self, scheme: str, pairs: List[Tuple[int, int]]) -> None:
        """Fill the path cache for the given router pairs of one scheme
        not in it yet: all their usable layers in one batched walk.

        ECMP keeps duplicates (identical tables => the hash split
        concentrates); FatPaths deduplicates (the flowlet balancer sees a
        path, not a table id).  A walk counts only if every hop read before
        it stands on t is an edge and it ends on t; a pair with none gets
        one empty path.
        """
        new = list(dict.fromkeys(st for st in pairs
                                 if (scheme,) + st not in self._path_cache))
        if not new:
            return
        routing = self._routing(scheme)
        s = np.array([st[0] for st in new], dtype=np.int64)
        t = np.array([st[1] for st in new], dtype=np.int64)
        pair, _, seqs = usable_walks(routing, s, t, self._max_hops)
        tw = t[pair]
        edges, stop = walk_edges(seqs, tw, self._eix)
        n_hops = edges.shape[1]
        read = np.arange(n_hops)[None, :] < stop[:, None]
        # stopped by a hole before standing on t
        hole = stop < n_hops
        hole[hole] = seqs[hole, stop[hole]] != tw[hole]
        ok = ~((edges < 0) & read).any(axis=1) & ~hole
        # walk_paths repeats t once reached, so a successful walk ends
        # on t; anything else ran out of hops or hit a table hole
        keep = ok & (seqs[:, -1] == tw)
        out: List[List[np.ndarray]] = [[] for _ in new]
        seen = [set() for _ in new]
        for w in np.nonzero(keep)[0]:
            path = edges[w, :stop[w]].astype(np.int64)
            pi = pair[w]
            if scheme == "fatpaths":
                k = tuple(path.tolist())
                if k in seen[pi]:
                    continue
                seen[pi].add(k)
            out[pi].append(path)
        for st, plist in zip(new, out):
            self._path_cache[(scheme,) + st] = plist or [
                np.zeros((0,), dtype=np.int64)]

    # ---- load assignment -----------------------------------------------------
    def _fabric_loads(self, scheme: str,
                      demands: Dict[Tuple[int, int], float]) -> np.ndarray:
        """Bytes per directed fabric edge for aggregated router demands."""
        load = np.zeros(self._n_edges, dtype=np.float64)
        self._walk_pairs(scheme, list(demands))
        pairs = [(st, b, self._pair_paths(scheme, *st))
                 for st, b in demands.items()]
        if scheme == "ecmp":
            for _, b, plist in pairs:
                w = b / len(plist)
                for p in plist:
                    np.add.at(load, p, w)
            return load
        # fatpaths: congestion-aware flowlets.  Each demand is chopped into
        # flowlet quanta; every quantum takes the candidate path (any
        # usable layer's route) with the smallest current bottleneck, ties
        # broken toward shorter paths.  Round-robin over demands so flows
        # adapt to each other — a deterministic fixed point of the
        # re-route-away-from-hot-links dynamics of §3.2.
        quanta = max(1, self.flowlet_quanta)
        for q in range(quanta):
            for _, b, plist in pairs:
                quantum = b / quanta
                best, best_cost = None, None
                for p in plist:
                    cost = (float(load[p].max()) if len(p) else 0.0, len(p))
                    if best is None or cost < best_cost:
                        best, best_cost = p, cost
                np.add.at(load, best, quantum)
        return load

    # ---- public API ----------------------------------------------------------
    def evaluate_flows(self, flows: Sequence[Flow], scheme: str = "fatpaths",
                       kind: str = "custom", n_ranks: int = 0,
                       payload_bytes: float = 0.0) -> CollectiveReport:
        """Route an explicit endpoint flow set and report link loads."""
        n_ep = self.topo.n_endpoints
        inj = np.zeros(n_ep, dtype=np.float64)
        ej = np.zeros(n_ep, dtype=np.float64)
        demands: Dict[Tuple[int, int], float] = {}
        for src, dst, b in flows:
            se, de = src % n_ep, dst % n_ep
            inj[se] += b
            ej[de] += b
            sr, tr = int(self.ep2r[se]), int(self.ep2r[de])
            if sr != tr:
                demands[(sr, tr)] = demands.get((sr, tr), 0.0) + b
        load = self._fabric_loads(scheme, demands) if demands else \
            np.zeros(self._n_edges)
        bottleneck = float(max(load.max() if len(load) else 0.0,
                               inj.max() if len(inj) else 0.0,
                               ej.max() if len(ej) else 0.0))
        return CollectiveReport(
            kind=kind, scheme=scheme, n_ranks=n_ranks,
            payload_bytes=payload_bytes,
            bottleneck_bytes=bottleneck,
            time_s=bottleneck / self.line_rate,
            util_gini=_gini(load),
            n_links_used=int((load > 1e-9).sum()),
            fabric_bytes=float(load.sum()),
        )

    def collective_time(self, kind: str, n: int, nbytes: float,
                        scheme: str = "fatpaths",
                        strides: Optional[Sequence[int]] = None
                        ) -> CollectiveReport:
        """Model one collective of ``n`` ranks x ``nbytes`` payload under
        the given routing scheme; ranks map to endpoints 0..n-1."""
        n = min(int(n), self.topo.n_endpoints)
        flows = collective_flows(kind, n, nbytes,
                                 strides if strides is not None else (1,))
        return self.evaluate_flows(flows, scheme=scheme,
                                   kind=kind.replace("-start", ""),
                                   n_ranks=n, payload_bytes=float(nbytes))
