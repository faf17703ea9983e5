"""Path-diversity metrics (paper §4.2, Appendix B).

Three measures:

* **CDP** — count of disjoint paths at length ``l`` between router *sets*
  A, B: the smallest number of edge removals after which no path of length
  <= l connects A to B (§4.2.1).  Exact length-bounded min-cut is NP-hard in
  general; like the paper we compute it with a Ford–Fulkerson-style greedy:
  repeatedly find a shortest path (BFS) of length <= l and remove its edges.
  The count of peeled paths lower-bounds the cut; for the unbounded case it
  is cross-checked against true edge connectivity in tests.

* **Cheung et al. finite-field rank method** (Appendix B.3) — all-pairs
  length-limited edge connectivity via linear propagation over GF(p):
  ``c_st = rank(P_s (sum_{i<l} K^i) Q_t)``.  The E x E modular matmul is the
  computational hot spot.  It runs as a float64 ``torch.matmul`` on the
  caller's device with p^2 * E < 2^53, so every partial sum is an exact
  integer and the result does not depend on the order of the sums.  (The
  GF(p) kernel, :func:`repro_torch.kernels.gf_matmul`, takes p <= 2^16 and
  so not this prime.)

* **PI** — path interference ``I^l_{ac,bd} = c_l(a,b) + c_l(c,d)
  - c_l({a,c},{b,d})`` (§4.2.2), and **TNL** ``k' N_r / l_avg`` (§4.2.3).

The peeling, the sampling and the GF(p) ranks are host code (numpy);
the path statistics of :func:`diversity_report` run through
:mod:`repro_torch.core.paths` on the caller's device.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import paths as paths_mod
from .topology import Topology

__all__ = [
    "cdp_peel",
    "cdp_pairs_sampled",
    "path_interference",
    "pi_samples",
    "total_network_load",
    "GFConnectivity",
    "DiversityReport",
    "diversity_report",
]

# Prime with E * p^2 < 2^53 for E <= 4096 (float64-exact modular matmul).
GF_PRIME = 1_048_573


# -----------------------------------------------------------------------------
# Greedy length-limited edge-disjoint path peeling (Ford–Fulkerson variant).
# -----------------------------------------------------------------------------
def _bfs_path(nbr: List[np.ndarray], alive: np.ndarray, src: Sequence[int],
              dst_mask: np.ndarray, max_len: int) -> Optional[List[int]]:
    """Shortest path (<= max_len edges) from any vertex in ``src`` to the dst
    set using only edges with ``alive[eid]``; returns vertex list or None.

    nbr[v] is an (deg, 2) array of (neighbor, edge_id) rows.
    """
    n = len(nbr)
    parent = np.full(n, -2, dtype=np.int64)  # -2 unvisited, -1 root
    parent_edge = np.full(n, -1, dtype=np.int64)
    depth = np.zeros(n, dtype=np.int64)
    dq = deque()
    for s in src:
        if parent[s] == -2:
            parent[s] = -1
            dq.append(s)
            if dst_mask[s]:
                return [int(s)]
    while dq:
        v = dq.popleft()
        if depth[v] >= max_len:
            continue
        for u, eid in nbr[v]:
            if parent[u] != -2 or not alive[eid]:
                continue
            parent[u] = v
            parent_edge[u] = eid
            depth[u] = depth[v] + 1
            if dst_mask[u]:
                out = [int(u)]
                w = u
                while parent[w] != -1:
                    w = parent[w]
                    out.append(int(w))
                return out[::-1]
            dq.append(u)
    return None


def _neighbor_lists(adj: np.ndarray) -> Tuple[List[np.ndarray], int]:
    """Undirected edge ids; each undirected edge has one id used by both dirs."""
    iu, ju = np.nonzero(np.triu(adj, 1))
    n_edges = len(iu)
    n = adj.shape[0]
    lists: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for eid, (u, v) in enumerate(zip(iu, ju)):
        lists[u].append((v, eid))
        lists[v].append((u, eid))
    nbr = [np.array(l, dtype=np.int64).reshape(-1, 2) for l in lists]
    return nbr, n_edges


def cdp_peel(adj: np.ndarray, A: Iterable[int], B: Iterable[int], l: int,
             return_paths: bool = False):
    """Greedy count of edge-disjoint paths of length <= l from set A to set B.

    Peels shortest paths first (the paper's pruning heuristic); each peeled
    path removes its (undirected) edges.  Edges internal to A or B still
    count as capacity, matching the h^l(A) ∩ B = ∅ condition.
    """
    A = list(dict.fromkeys(int(a) for a in A))
    B = set(int(b) for b in B)
    if set(A) & B:
        raise ValueError("A and B must be disjoint")
    nbr, n_edges = _neighbor_lists(adj)
    alive = np.ones(n_edges, dtype=bool)
    dst_mask = np.zeros(adj.shape[0], dtype=bool)
    for b in B:
        dst_mask[b] = True
    found: List[List[int]] = []
    while True:
        p = _bfs_path(nbr, alive, A, dst_mask, l)
        if p is None:
            break
        # remove path edges
        for u, v in zip(p[:-1], p[1:]):
            for w, eid in nbr[u]:
                if w == v:
                    alive[eid] = False
                    break
        found.append(p)
    if return_paths:
        return len(found), found
    return len(found)


def cdp_pairs_sampled(topo: Topology, l: int, n_samples: int = 200,
                      seed: int = 0) -> np.ndarray:
    """CDP for uniformly sampled router pairs; radix-invariant use is
    ``result / k'`` (paper Table 4 reports CDP as a fraction of k')."""
    rng = np.random.default_rng(seed)
    n = topo.n_routers
    out = np.zeros(n_samples, dtype=np.int64)
    for i in range(n_samples):
        s, t = rng.choice(n, size=2, replace=False)
        out[i] = cdp_peel(topo.adj, [s], [t], l)
    return out


# -----------------------------------------------------------------------------
# Path interference (§4.2.2).
# -----------------------------------------------------------------------------
def path_interference(adj: np.ndarray, a: int, b: int, c: int, d: int,
                      l: int) -> int:
    """I^l_{ac,bd} = c_l(a,b) + c_l(c,d) - c_l({a,c},{b,d})."""
    cab = cdp_peel(adj, [a], [b], l)
    ccd = cdp_peel(adj, [c], [d], l)
    cboth = cdp_peel(adj, [a, c], [b, d], l)
    return int(cab + ccd - cboth)


def pi_samples(topo: Topology, l: int, n_samples: int = 100,
               seed: int = 0) -> np.ndarray:
    """Sample PI for random disjoint 4-tuples (a,b),(c,d)."""
    rng = np.random.default_rng(seed)
    n = topo.n_routers
    out = np.zeros(n_samples, dtype=np.int64)
    for i in range(n_samples):
        a, b, c, d = rng.choice(n, size=4, replace=False)
        out[i] = path_interference(topo.adj, a, b, c, d, l)
    return out


def total_network_load(topo: Topology, l_avg: Optional[float] = None,
                       device="cuda") -> float:
    """TNL = k' N_r / l — max flows sustainable without congestion (§4.2.3).
    Without ``l_avg`` the average path length is computed on ``device``."""
    if l_avg is None:
        l_avg = paths_mod.average_path_length(topo.adj, device=device)
    kprime = topo.adj.sum() / topo.n_routers
    return float(kprime * topo.n_routers / max(l_avg, 1e-9))


# -----------------------------------------------------------------------------
# Cheung-style GF(p) rank method (Appendix B.3).
# -----------------------------------------------------------------------------
@dataclasses.dataclass
class GFConnectivity:
    """Precomputed length-limited edge-connectivity oracle.

    Builds M_l = sum_{i=0}^{l-1} K^i over GF(p) where K is the E_dir x E_dir
    edge-incidence propagation matrix with random coefficients; then
    ``query(s, t)`` returns rank(P_s M_l Q_t) over GF(p), which sandwiches
    the count of edge-disjoint length-<=l paths (see module docstring).
    ``M`` is built on the caller's device and kept on the host, where the
    queries run.
    """

    edges: np.ndarray          # (E_dir, 2) directed edges
    M: np.ndarray              # (E_dir, E_dir) float64 (values in [0, p))
    out_edges: List[np.ndarray]
    in_edges: List[np.ndarray]
    p: int
    max_len: int

    @staticmethod
    def build(adj: np.ndarray, max_len: int, p: int = GF_PRIME,
              seed: int = 0, device="cuda") -> "GFConnectivity":
        adj = np.asarray(adj, dtype=bool)
        n = adj.shape[0]
        u, v = np.nonzero(adj)
        edges = np.stack([u, v], axis=1).astype(np.int64)
        e = len(edges)
        if e > 4096:
            raise ValueError(
                f"E_dir={e} too large for float64-exact GF({p}) matmul; "
                "use sampled cdp_peel instead")
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        # K[(i,k),(k,j)] = random coefficient (edge-chain propagation).
        head = edges[:, 1]
        tail = edges[:, 0]
        K = np.zeros((e, e), dtype=np.float64)
        # connect edge a -> edge b when head(a) == tail(b); forbid immediate
        # u->v->u backtracking to keep walks closer to paths (heuristic that
        # does not change the rank bound: removing walks can only lower rank,
        # and disjoint simple paths never backtrack).
        match = head[:, None] == tail[None, :]
        back = (edges[:, 0][:, None] == edges[:, 1][None, :]) & match
        match &= ~back
        K[match] = rng.integers(1, p, size=int(match.sum())).astype(np.float64)
        # M = sum_{i=0}^{l-1} K^i computed as Horner: M_1 = I;
        # M_{j+1} = M_j K + I  ->  after l-1 steps M = sum_{i<l} K^i.
        # Entries stay integers below p, so every partial sum of M @ K is
        # an integer below p^2 * E < 2^53: exact in float64 in any order.
        Kt = torch.as_tensor(K, device=dev)
        Mt = torch.eye(e, dtype=torch.float64, device=dev)
        diag = torch.arange(e, device=dev)
        for _ in range(max_len - 1):
            Mt = torch.remainder(Mt @ Kt, p)
            Mt[diag, diag] = torch.remainder(Mt[diag, diag] + 1, p)
        M = Mt.cpu().numpy()
        out_edges = [np.nonzero(tail == s)[0] for s in range(n)]
        in_edges = [np.nonzero(head == t)[0] for t in range(n)]
        return GFConnectivity(edges, M, out_edges, in_edges, p, max_len)

    def query(self, s: int, t: int) -> int:
        sub = self.M[np.ix_(self.out_edges[s], self.in_edges[t])]
        return _rank_gf(sub % self.p, self.p)

    def query_pairs(self, pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
        return np.array([self.query(s, t) for s, t in pairs], dtype=np.int64)


def _rank_gf(m: np.ndarray, p: int) -> int:
    """Rank of a small matrix over GF(p) by Gaussian elimination (float64
    storage, exact because all values < p and p^2 * ncols < 2^53)."""
    m = m.astype(np.int64) % p
    rows, cols = m.shape
    rank = 0
    r = 0
    for c in range(cols):
        piv = None
        for rr in range(r, rows):
            if m[rr, c] % p != 0:
                piv = rr
                break
        if piv is None:
            continue
        m[[r, piv]] = m[[piv, r]]
        inv = pow(int(m[r, c]), p - 2, p)
        m[r] = (m[r] * inv) % p
        for rr in range(rows):
            if rr != r and m[rr, c] != 0:
                m[rr] = (m[rr] - m[rr, c] * m[r]) % p
        r += 1
        rank += 1
        if r == rows:
            break
    return rank


# -----------------------------------------------------------------------------
# Aggregate report (Table 4 analogue).
# -----------------------------------------------------------------------------
@dataclasses.dataclass
class DiversityReport:
    name: str
    diameter: int
    avg_path_len: float
    kprime: int
    n_routers: int
    n_endpoints: int
    frac_single_minimal: float   # fraction of pairs with exactly 1 shortest path
    cdp_mean_frac: float         # mean CDP / k' at d'
    cdp_tail_frac: float         # 1% tail CDP / k'
    pi_mean_frac: float          # mean PI / k'
    pi_tail_frac: float          # 99.9% (here 99%) tail PI / k'
    d_prime: int
    tnl: float


def diversity_report(topo: Topology, n_cdp: int = 150, n_pi: int = 80,
                     seed: int = 0, d_prime: Optional[int] = None,
                     device="cuda") -> DiversityReport:
    """Compute the Table-4 row for a topology.

    d' is chosen (as in the paper) as the smallest length for which the
    sampled CDP tail reaches >= 3 disjoint paths.  The shortest-path
    statistics run on ``device``; the sampled CDP and PI on the host.
    """
    dist, counts = paths_mod.min_path_stats(topo.adj, device=device)
    n = topo.n_routers
    off = ~np.eye(n, dtype=bool)
    reachable = dist[off] < 10_000
    single = (counts[off] == 1) & reachable
    frac_single = float(single.sum()) / max(1, reachable.sum())
    diam = int(dist[off][reachable].max())
    apl = float(dist[off][reachable].mean())
    kprime = topo.network_radix

    if d_prime is None:
        d_prime = diam
        for cand in range(diam, diam + 4):
            vals = cdp_pairs_sampled(topo, cand, n_samples=min(60, n_cdp), seed=seed)
            if np.quantile(vals, 0.001) >= 3 or vals.min() >= 3:
                d_prime = cand
                break
            d_prime = cand

    cdp = cdp_pairs_sampled(topo, d_prime, n_samples=n_cdp, seed=seed)
    pi = pi_samples(topo, d_prime, n_samples=n_pi, seed=seed + 1)
    return DiversityReport(
        name=topo.name,
        diameter=diam,
        avg_path_len=apl,
        kprime=kprime,
        n_routers=n,
        n_endpoints=topo.n_endpoints,
        frac_single_minimal=frac_single,
        cdp_mean_frac=float(cdp.mean()) / kprime,
        cdp_tail_frac=float(np.quantile(cdp, 0.01)) / kprime,
        pi_mean_frac=float(pi.mean()) / kprime,
        pi_tail_frac=float(np.quantile(pi, 0.99)) / kprime,
        d_prime=d_prime,
        tnl=total_network_load(topo, apl),
    )
