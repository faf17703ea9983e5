"""Forwarding-table deployment accounting (paper §5.5).

Exact-match vs prefix-compressed table sizes (§5.5.2: endpoint tables
are O(N); compressing "all endpoints on one router share routes" gives
O(N_r)).  The forwarding-function view and VLAN accounting of the JAX
package's module are not ported yet (ROADMAP A4).
"""

from __future__ import annotations

from .layers import LayeredRouting

__all__ = ["table_entries_exact", "table_entries_prefix"]


def table_entries_exact(routing: LayeredRouting) -> int:
    """Exact-match entries: one per (router, layer, destination endpoint)."""
    n_ep = routing.topo.n_endpoints
    return routing.topo.n_routers * routing.n_layers * n_ep


def table_entries_prefix(routing: LayeredRouting) -> int:
    """Prefix-compressed entries (§5.5.2): one per (router, layer,
    destination *router*) — the O(N) -> O(N_r) saving."""
    n_r = routing.topo.n_routers
    return n_r * routing.n_layers * n_r
