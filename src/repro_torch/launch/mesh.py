"""Mesh construction over the ranks of a ``torch.distributed`` world.

The port of the JAX package's ``launch/mesh.py``.  A mesh here is a
:class:`~repro_torch.dist.sharding.Mesh` of global ranks (processes),
not of devices; making one touches no process group, so the spec
builders can be run on a mesh that no world backs.

FatPaths integration: :func:`fatpaths_device_order` reorders ranks so
that mesh neighbours (ring-collective peers) land on fabric-adjacent
endpoints of the modelled cluster topology — the paper's routing-aware
placement applied to collective scheduling (see
:mod:`repro_torch.dist.fabric`).  The dry run's production mesh comes
with the HLO tools (ROADMAP A13.6).
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np

from ..dist.sharding import Mesh

__all__ = ["make_mesh", "fatpaths_device_order"]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_order: Optional[np.ndarray] = None) -> Mesh:
    """A mesh over ranks ``0 .. prod(shape) - 1``; an optional explicit
    permutation puts rank ``device_order[j]`` at flat position ``j``
    (fabric-aware placement)."""
    n = int(np.prod(shape))
    ranks = np.arange(n)
    if device_order is not None:
        ranks = ranks[np.asarray(device_order)[:n]]
    return Mesh(ranks.reshape(tuple(shape)), tuple(axes))


def fatpaths_device_order(n_devices: int, topo=None) -> np.ndarray:
    """Order devices so consecutive mesh coordinates sit on fabric-adjacent
    endpoints: BFS order over the cluster topology's routers (endpoints of a
    router stay contiguous).  Deterministic; identity when no topology is
    given."""
    if topo is None:
        return np.arange(n_devices)
    adj = topo.adj
    n_r = adj.shape[0]
    # BFS from router 0 for a locality-preserving linearisation.
    order = []
    seen = np.zeros(n_r, dtype=bool)
    queue = deque([0])
    seen[0] = True
    while queue:
        v = queue.popleft()
        order.append(v)
        for u in np.nonzero(adj[v])[0]:
            if not seen[u]:
                seen[u] = True
                queue.append(u)
    order += [i for i in range(n_r) if not seen[i]]
    ep_order = []
    conc = topo.concentration
    base = np.concatenate([[0], np.cumsum(conc)[:-1]])
    for r in order:
        ep_order.extend(range(int(base[r]), int(base[r] + conc[r])))
    ep_order = np.array(ep_order)
    # Restrict to a permutation of range(n_devices): keep the BFS order of
    # the endpoints that map to devices, then append any device ids beyond
    # the modelled endpoint count in natural order.
    ep_order = ep_order[ep_order < n_devices]
    if len(ep_order) < n_devices:
        present = np.zeros(n_devices, dtype=bool)
        present[ep_order] = True
        ep_order = np.concatenate([ep_order, np.nonzero(~present)[0]])
    return ep_order
