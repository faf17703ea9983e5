"""Forwarding-function layer (paper §5.1, §5.4, §5.5).

Wraps a :class:`~repro_torch.core.layers.LayeredRouting` into the paper's
routing model: a per-layer destination-based forwarding function
``sigma_i(s, t) -> (port j, next hop s')`` plus deployment accounting —
exact-match vs prefix-compressed table sizes (§5.5.2: endpoint tables are
O(N); compressing "all endpoints on one router share routes" gives O(N_r)).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .layers import LayeredRouting

__all__ = ["ForwardingFunction", "table_entries_exact", "table_entries_prefix",
           "vlan_layers_required"]


@dataclasses.dataclass
class ForwardingFunction:
    """sigma_i as a callable over (s, t) with port resolution.  The
    layer's table is copied to the host once, since routes are walked one
    hop at a time."""

    routing: LayeredRouting
    layer: int
    _ports: np.ndarray = dataclasses.field(init=False, repr=False)
    _nh: np.ndarray = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        adj = np.asarray(self.routing.topo.adj)
        n = adj.shape[0]
        # port[s, u] = index of u among s's neighbours (k'-bounded), -1 else.
        ports = np.full((n, n), -1, dtype=np.int32)
        for s in range(n):
            nbrs = np.nonzero(adj[s])[0]
            ports[s, nbrs] = np.arange(len(nbrs), dtype=np.int32)
        self._ports = ports
        self._nh = self.routing.nh[self.layer].cpu().numpy()

    def __call__(self, s: int, t: int) -> Tuple[int, int]:
        nxt = int(self._nh[s, t])
        if nxt < 0 or nxt == s:
            return -1, nxt
        return int(self._ports[s, nxt]), nxt

    def route(self, s: int, t: int, max_hops: int = 64):
        """Full router path s..t; raises on loops (loop-freedom check)."""
        path = [s]
        cur = s
        while cur != t:
            _, nxt = self(cur, t)
            if nxt < 0:
                raise LookupError(f"layer {self.layer} cannot route {s}->{t}")
            cur = nxt
            path.append(cur)
            if len(path) > max_hops:
                raise RuntimeError(f"loop detected on layer {self.layer} "
                                   f"({s}->{t}): {path[:8]}...")
        return path


def table_entries_exact(routing: LayeredRouting) -> int:
    """Exact-match entries: one per (router, layer, destination endpoint)."""
    n_ep = routing.topo.n_endpoints
    return routing.topo.n_routers * routing.n_layers * n_ep


def table_entries_prefix(routing: LayeredRouting) -> int:
    """Prefix-compressed entries (§5.5.2): one per (router, layer,
    destination *router*) — the O(N) -> O(N_r) saving."""
    n_r = routing.topo.n_routers
    return n_r * routing.n_layers * n_r


def vlan_layers_required(routing: LayeredRouting) -> int:
    """Number of VLAN tags needed to deploy the layers (§5.5.1): one per
    layer; FatPaths keeps this O(1) vs SPAIN's O(k') / PAST's O(N) (§6.3)."""
    return routing.n_layers
