"""FatPaths layered routing (paper §5.2–§5.4).

A *layer* is a subset of links with its own shortest-path forwarding
function sigma_i.  Layer 0 always contains every link (minimal paths);
layers 1..n-1 are rho-sparsified and oriented into DAGs by random vertex
permutations (Listing 1), so their "shortest paths" are non-minimal paths
of the full network — the "fat" path diversity.

Construction schemes (§5.3) ported here:
  * ``rand``    — Listing 1 verbatim: keep directed edge (u, v) with
                  pi(u) < pi(v) and probability rho.
  * ``undir``   — ablation: sparsify without DAG orientation.
  * ``spain``   — SPAIN adaptation: each layer is a BFS spanning tree from a
                  random root.
  * ``past``    — PAST adaptation: per-layer re-randomised shortest-path
                  tie-breaks on the full graph.
  * ``ksp``     — k-shortest-paths style: every layer keeps all links and
                  routes on randomly perturbed link weights, by (min, +)
                  all-pairs distances.

The first four sample the layer adjacencies on the host with numpy (the
JAX package's exact draws); every layer's APSP and forwarding tables then
come out of one batched device pass (:mod:`repro_torch.core.paths`).
``ksp`` draws its weights on the device from the threefry stream.
``pi_min`` samples on the device from earlier layers' tables and is not
ported yet (ROADMAP A4).

Forwarding is destination-based: ``nh[i, s, t]`` = next hop at router s for
a packet tagged layer i, destination t; unreachable entries are -1.  The
tables are tensors on the device they were built on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import prng, resolve_device
from . import paths as paths_mod
from .topology import Topology

__all__ = ["LayeredRouting", "build_layers"]

_UNREACH = 10_000
_NOT_PORTED = {"pi_min": "A4"}


@dataclasses.dataclass
class LayeredRouting:
    """Stacked forwarding state for n layers over one topology (tensors
    on one device)."""

    topo: Topology
    scheme: str
    rho: float
    nh: torch.Tensor          # (L, N, N) int32 next hop, -1 unreachable
    reach: torch.Tensor       # (L, N, N) bool
    pathlen: torch.Tensor     # (L, N, N) int16 intra-layer shortest-path length
    layer_adj: torch.Tensor   # (L, N, N) bool directed layer adjacency
    build_stats: Optional[Dict[str, float]] = None  # wall-time split
    # Fault lanes of the JAX package; the scan refuses them until they
    # are ported (ROADMAP A8).
    link_down_step: Optional[np.ndarray] = None
    link_churn: Optional[np.ndarray] = None
    churn_conv: int = 0
    # Compressed tables come with the blocked engine (ROADMAP A9).
    compressed: Optional[object] = None

    @property
    def n_layers(self) -> int:
        return int(self.nh.shape[0])

    def usable_layers(self, s: int, t: int) -> np.ndarray:
        return np.nonzero(self.reach[:, s, t].cpu().numpy())[0]


def _rand_layer(adj: np.ndarray, rho: float, rng: np.random.Generator,
                oriented: bool = True) -> np.ndarray:
    """One Listing-1 layer: directed DAG (or undirected if not oriented)."""
    n = adj.shape[0]
    pi = rng.permutation(n)
    iu, ju = np.nonzero(np.triu(adj, 1))
    keep = rng.random(len(iu)) < rho
    out = np.zeros((n, n), dtype=bool)
    u, v = iu[keep], ju[keep]
    if oriented:
        fwd = pi[u] < pi[v]
        uu = np.where(fwd, u, v)
        vv = np.where(fwd, v, u)
        out[uu, vv] = True
    else:
        out[u, v] = True
        out[v, u] = True
    return out


def _bfs_tree(adj: np.ndarray, root: int, rng: np.random.Generator) -> np.ndarray:
    """Random-order BFS spanning tree (undirected layer)."""
    n = adj.shape[0]
    tree = np.zeros((n, n), dtype=bool)
    seen = np.zeros(n, dtype=bool)
    seen[root] = True
    frontier = [root]
    while frontier:
        nxt: List[int] = []
        order = rng.permutation(len(frontier))
        for fi in order:
            v = frontier[fi]
            nbrs = np.nonzero(adj[v] & ~seen)[0]
            rng.shuffle(nbrs)
            for u in nbrs:
                if not seen[u]:
                    seen[u] = True
                    tree[v, u] = tree[u, v] = True
                    nxt.append(int(u))
        frontier = nxt
    return tree


def _ksp_stack(adj: torch.Tensor, nbr: torch.Tensor, key: torch.Tensor,
               n_layers: int, max_l: int):
    """k-shortest-paths-style layers: per-layer perturbed edge weights,
    (min, +) all-pairs distances, and next hops minimising
    ``w[s, u] + D[u, t]`` over neighbors u (first minimum on ties).
    Every layer keeps all links; reach and dist are layer 0's."""
    n = adj.shape[0]
    dev = adj.device
    idx = torch.arange(n, device=dev)
    k0, kw = prng.split(key)
    nh0, _, dist0 = paths_mod._layer_tables_core(adj[None], nbr, k0, max_l)
    hop = dist0[0]
    u01 = prng.uniform(kw, (n_layers - 1, n, n))
    inf = torch.tensor(float("inf"), device=dev)
    w = torch.where(adj[None], 1.0 + 0.25 * u01, inf)
    w = torch.minimum(w, w.transpose(1, 2))
    w[:, idx, idx] = 0.0
    d = paths_mod._minplus_apsp_core(w, max_l)

    nbr = nbr.long()
    has_edge = torch.gather(adj, 1, nbr)                      # (N, D)
    nh = [nh0]
    for w_l, d_l in zip(w, d):
        w_nbr = torch.gather(w_l, 1, nbr)                     # (N, D)
        cost = torch.where(has_edge[:, :, None],
                           w_nbr[:, :, None] + d_l[nbr], inf)  # (N, D, N)
        j = cost.argmin(dim=1)                                # first minimum
        best = torch.gather(nbr, 1, j).to(torch.int32)
        nh_l = torch.where(torch.isfinite(cost.amin(dim=1)), best, -1)
        nh_l[idx, idx] = idx.to(torch.int32)
        nh.append(nh_l[None])
    shape = (n_layers, n, n)
    return (adj[None].expand(shape).clone(), torch.cat(nh),
            (hop <= max_l)[None].expand(shape).clone(),
            hop[None].expand(shape).clone())


def build_layers(topo: Topology, n_layers: int, rho: float,
                 scheme: str = "rand", seed: int = 0,
                 max_len: Optional[int] = None,
                 device="cuda") -> LayeredRouting:
    """Construct the FatPaths layer stack (layer 0 = all links, minimal).

    Layer adjacencies are sampled on the host (``ksp``: every layer is the
    whole graph, with weights drawn on the device); all L layers' tables
    come out of one batched pass on ``device``.  ``build_stats`` records
    the host (sampling) vs device (table construction) wall-time split."""
    if scheme in _NOT_PORTED:
        raise NotImplementedError(
            f"layer scheme {scheme!r} is not ported yet "
            f"(ROADMAP {_NOT_PORTED[scheme]})")
    dev = resolve_device(device)
    adj = np.asarray(topo.adj, dtype=bool)
    n = adj.shape[0]
    paths_mod.path_engine()
    if max_len is None:
        # Allow "almost minimal" detours: nominal diameter + slack.
        max_len = max(6, topo.diameter_nominal + 4)
    rng = np.random.default_rng(seed)
    key = prng.PRNGKey(seed, dev)
    nbr = torch.as_tensor(paths_mod.neighbor_table(adj), device=dev)

    t0 = time.perf_counter()
    if scheme == "ksp":
        t_dev = time.perf_counter()
        la, nh, reach, dist = _ksp_stack(torch.as_tensor(adj, device=dev),
                                         nbr, key, n_layers, max_len)
    else:
        layer_adjs: List[np.ndarray] = [adj.copy()]
        if scheme in ("rand", "undir"):
            for _ in range(n_layers - 1):
                layer_adjs.append(
                    _rand_layer(adj, rho, rng, oriented=(scheme == "rand")))
        elif scheme == "spain":
            for _ in range(n_layers - 1):
                root = int(rng.integers(n))
                layer_adjs.append(_bfs_tree(adj, root, rng))
        elif scheme == "past":
            for _ in range(n_layers - 1):
                layer_adjs.append(adj.copy())  # re-randomised tie-breaks
        else:
            raise ValueError(f"unknown scheme {scheme!r}")
        la = torch.as_tensor(np.stack(layer_adjs), device=dev)
        t_dev = time.perf_counter()
        nh, reach, dist = paths_mod._layer_tables_core(la, nbr, key, max_len)
    paths_mod._sync(dev)
    t1 = time.perf_counter()

    pathlen = torch.where(reach, dist, _UNREACH).to(torch.int16)
    t2 = time.perf_counter()
    return LayeredRouting(
        topo=topo, scheme=scheme, rho=rho,
        nh=nh, reach=reach, pathlen=pathlen, layer_adj=la,
        build_stats={"total_s": t2 - t0, "device_s": t1 - t_dev,
                     "host_s": t_dev - t0, "compress_s": t2 - t1},
    )
