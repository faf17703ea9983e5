"""Path analysis via adjacency-matrix algebra (paper Appendix B.1), dense
engine.

APSP is a sequence of boolean-semiring frontier products through
:func:`repro_torch.kernels.semiring.semiring_matmul` (the CUDA kernel on
the card, the plain product on the CPU); weighted distances are (min, +)
squarings and walk counts saturating ``count`` products through the same
kernel.  Forwarding tables pick, per (layer, s, t), a uniformly random
equal-cost next hop with one threefry uniform per table entry
(:mod:`repro_torch.prng`), so the tables are the JAX package's bit for
bit.

The batched entry points (``apsp_batched``, ``forwarding_batched``,
``layer_tables_batched``, ``minplus_apsp_batched``, ``edge_usage_batched``)
work on an (L, N, N) stack of layer adjacencies on one device.  Each takes
numpy arrays or tensors and a
``device`` (``"cuda"`` unless the caller asks for the CPU); tensors
already on a device stay there when ``device=None``.

Only the ``dense`` engine exists here.  The JAX package's ``auto`` picks
its ``blocked`` frontier engine from 512 routers up; that engine is
asserted bit-identical to ``dense`` by the JAX package's own tests, so a
dense table here equals the table the JAX package builds at any size.
``REPRO_PATH_ENGINE=blocked`` raises until the blocked engine is ported.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import prng, resolve_device
from ..kernels.semiring import semiring_matmul

__all__ = [
    "shortest_path_lengths",
    "apsp_batched",
    "forwarding_batched",
    "layer_tables_batched",
    "minplus_apsp_batched",
    "edge_usage_batched",
    "diameter",
    "average_path_length",
    "path_counts_exact_length",
    "min_path_stats",
    "next_hop_options",
    "build_forwarding",
    "table_validity_batched",
    "walk_paths",
    "walk_paths_layers",
    "neighbor_table",
    "path_engine",
    "to_device",
]

PATH_ENGINES = ("dense", "blocked", "auto")


def path_engine(override: Optional[str] = None) -> str:
    """Resolve the engine: an explicit ``override`` wins, then
    ``REPRO_PATH_ENGINE`` (``dense|blocked|auto``, default ``auto``);
    every choice but ``blocked`` is ``dense``."""
    eng = override or os.environ.get("REPRO_PATH_ENGINE", "") or "auto"
    if eng not in PATH_ENGINES:
        raise ValueError(f"unknown path engine {eng!r}; "
                         f"choose from {PATH_ENGINES}")
    if eng == "blocked":
        raise NotImplementedError(
            "the blocked path engine is not ported yet (ROADMAP A9); "
            "the dense engine builds bit-identical tables")
    return "dense"


def to_device(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a ``dtype`` tensor: on ``device`` when
    one is given, else where a tensor already lies (numpy goes to cuda)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    dev = resolve_device(device)
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), device=dev).to(dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -----------------------------------------------------------------------------
# Batched cores.
# -----------------------------------------------------------------------------
def _apsp_core(adj: torch.Tensor, max_l: int) -> torch.Tensor:
    """(L, N, N) bool adjacency stack -> (L, N, N) int32 distances via
    boolean-semiring frontier products; unreachable pairs get max_l + 1.
    One host sync per product decides whether another is needed."""
    _, n, _ = adj.shape
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    dist = torch.where(eye[None], 0,
                       torch.where(adj, 1, max_l + 1)).to(torch.int32)
    reach = adj | eye[None]
    l, go = 1, True
    while go and l < max_l:
        nreach = semiring_matmul(reach, adj, "bool")
        newly = nreach & ~reach
        dist = torch.where(newly & (dist > l + 1), l + 1, dist).to(torch.int32)
        reach = reach | nreach
        l += 1
        go = bool(newly.any())
    return dist


def _minplus_apsp_core(w: torch.Tensor, max_l: int) -> torch.Tensor:
    """All-pairs weighted distances for a (K, N, N) weight stack (+inf
    non-edges, 0 diagonal) by repeated (min, +) squaring: after i
    squarings paths of up to 2**i hops are covered, and with unit-ish
    weights (>= 1) no shortest path uses more than ~1.25 * max_l hops."""
    iters = max(1, int(np.ceil(np.log2(1.25 * max_l + 1))))
    d = w
    for _ in range(iters):
        d = semiring_matmul(d, d, "minplus")
    return d


def _edge_usage_core(nh: torch.Tensor, reach: torch.Tensor,
                     max_hops: int) -> torch.Tensor:
    """Per-edge count of (s, t) pairs routed over each directed edge of
    one (N, N) table: for a destination t the forwarding column is a
    tree, and the sources crossing edge (u, nh[u, t]) number the subtree
    size ``c[u, t] = r[u, t] + sum_{v : nh[v, t] = u} c[v, t]`` with
    ``r = reach & off-diagonal``, reached after ``max_hops`` rounds.
    Every sum is of integers below 2^24 in f32, so the scatter-adds are
    exact in any order, on either device."""
    n = nh.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=nh.device)
    valid = (nh >= 0) & reach & ~eye
    r = (reach & ~eye).to(torch.float32)
    tgt = torch.clamp_min(nh, 0).long()
    idx = torch.arange(n, device=nh.device)
    tcols = idx[None, :].expand(n, n)
    c = torch.zeros((n, n), dtype=torch.float32, device=nh.device)
    for _ in range(max_hops):
        contrib = torch.where(valid, c, 0.0)
        c = r + torch.zeros_like(c).index_put_((tgt, tcols), contrib,
                                               accumulate=True)
    return torch.zeros_like(c).index_put_(
        (idx[:, None].expand(n, n), tgt), torch.where(valid, c, 0.0),
        accumulate=True)


def neighbor_table(adj_union: np.ndarray) -> np.ndarray:
    """(N, Dmax) int32 padded neighbor-index table for a (union)
    adjacency.  Entry ``nbr[s, j]`` is the j-th neighbor of s; pad slots
    hold non-neighbor ids and are masked out by the per-layer adjacency
    gather, which keeps forwarding construction at O(N * Dmax * N)."""
    a = np.asarray(adj_union, dtype=bool)
    dmax = max(1, int(a.sum(axis=1).max()))
    # stable argsort puts neighbors (True) first in ascending-id order
    return np.argsort(~a, axis=1, kind="stable")[:, :dmax].astype(np.int32)


def _forwarding_core(adj: torch.Tensor, dist: torch.Tensor, nbr: torch.Tensor,
                     key: torch.Tensor) -> torch.Tensor:
    """Single-next-hop tables for an (L, N, N) stack.

    For each (layer, s, t) the next hop is the r-th valid candidate of
    ``{u in nbr[s] : adj[s, u], dist[u, t] == dist[s, t] - 1}``, with r
    drawn from one uniform per table entry of a single ``(L, N, N)``
    draw; -1 where there is no candidate, ``nh[l, s, s] = s``."""
    L, n, _ = adj.shape
    u01 = prng.uniform(key, (L, n, n))
    nbr = nbr.long()
    out = torch.empty((L, n, n), dtype=torch.int32, device=adj.device)
    for li in range(L):
        adj_l, dist_l, u_l = adj[li], dist[li], u01[li]
        has_edge = torch.gather(adj_l, 1, nbr)                  # (N, D)
        dist_nbr = dist_l[nbr]                                  # (N, D, N)
        # ok[s, j, t]: edge s->nbr[s,j] in this layer, one hop closer to t.
        ok = has_edge[:, :, None] & (dist_nbr + 1 == dist_l[:, None, :])
        cnt = ok.sum(dim=1, dtype=torch.int32)                  # (N, N)
        r = torch.minimum(torch.clamp_min((u_l * cnt).to(torch.int32), 0),
                          torch.clamp_min(cnt - 1, 0))
        csum = torch.cumsum(ok.to(torch.int32), dim=1, dtype=torch.int32)
        pick = ok & (csum == (r + 1)[:, None, :])
        j = pick.to(torch.int32).argmax(dim=1)                  # first True
        nh = torch.gather(nbr, 1, j).to(torch.int32)
        out[li] = torch.where(cnt > 0, nh, -1)
    idx = torch.arange(n, device=adj.device)
    out[:, idx, idx] = idx.to(torch.int32)
    return out


def _layer_tables_core(adj: torch.Tensor, nbr: torch.Tensor, key: torch.Tensor,
                       max_l: int) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """APSP + forwarding: ``(nh, reach, dist)``, each (L, N, N)."""
    dist = _apsp_core(adj, max_l)
    nh = _forwarding_core(adj, dist, nbr, key)
    return nh, dist <= max_l, dist


# -----------------------------------------------------------------------------
# Batched entry points.
# -----------------------------------------------------------------------------
def apsp_batched(adj, max_l: int = 64, device=None) -> torch.Tensor:
    """All-pairs shortest path lengths for an (L, N, N) adjacency stack;
    unreachable pairs get ``max_l + 1``."""
    path_engine()
    return _apsp_core(to_device(adj, torch.bool, device), max_l)


def forwarding_batched(adj, dist, key: torch.Tensor,
                       device=None) -> torch.Tensor:
    """Random-tie-break forwarding tables for an (L, N, N) stack; ``key``
    seeds the per-entry uniform choice (one stream for the stack)."""
    path_engine()
    adj_t = to_device(adj, torch.bool, device)
    nbr = neighbor_table(adj_t.any(dim=0).cpu().numpy())
    return _forwarding_core(adj_t, to_device(dist, torch.int32, adj_t.device),
                            torch.as_tensor(nbr, device=adj_t.device),
                            key.to(adj_t.device))


def layer_tables_batched(adj, key: torch.Tensor, max_l: int, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """APSP + forwarding for a whole layer stack on one device.

    Returns ``(nh, reach, dist)`` each (L, N, N).  The host's only job is
    the (N, Dmax) union neighbor table."""
    path_engine()
    adj_t = to_device(adj, torch.bool, device)
    nbr = neighbor_table(adj_t.any(dim=0).cpu().numpy())
    return _layer_tables_core(adj_t, torch.as_tensor(nbr, device=adj_t.device),
                              key.to(adj_t.device), max_l)


def minplus_apsp_batched(w, max_l: int, device=None) -> torch.Tensor:
    """(min, +) all-pairs distances for a (K, N, N) weight stack.

    Precondition: edge weights are >= 1 (+inf for non-edges, 0 diagonal)
    and every hop-distance is <= ``max_l``: the squaring count is sized
    for shortest weighted paths of at most ~1.25 * max_l hops, which is
    what the ``ksp`` scheme's 1 + 0.25*U(0,1) perturbed unit weights
    guarantee.  Sub-unit weights would admit longer optimal paths than
    the iteration covers and silently overestimate distances."""
    path_engine()
    return _minplus_apsp_core(to_device(w, torch.float32, device), max_l)


def edge_usage_batched(nh, reach, max_hops: int, device=None) -> torch.Tensor:
    """Directed-edge usage counts for an (L, N, N) table stack (f32,
    exact below 2**24)."""
    nh_t = to_device(nh, torch.int32, device)
    reach_t = to_device(reach, torch.bool, nh_t.device)
    return torch.stack([_edge_usage_core(a, b, max_hops)
                        for a, b in zip(nh_t, reach_t)])


def table_validity_batched(nh, alive, max_hops: int,
                           device=None) -> torch.Tensor:
    """``valid[l, s, t]``: the (layer, s, t) forwarding entry still
    delivers — every hop of the walk from s to t crosses an alive directed
    edge (``alive[u, nh[u, t]]``) and the walk ends at t within
    ``max_hops``.  A boolean fixpoint grown from the diagonal
    (``valid = eye | (edge alive & valid at the next hop)``), so loops and
    walks over dead edges never validate; gathers on the tables' device."""
    nh_t = to_device(nh, torch.int32, device)
    alive_t = to_device(alive, torch.bool, nh_t.device)
    n_layers, n, _ = nh_t.shape
    eye = torch.eye(n, dtype=torch.bool, device=nh_t.device)
    nxt = torch.clamp_min(nh_t, 0).long()                       # (L, N, N)
    rows = torch.arange(n, device=nh_t.device)[None, :, None]
    edge_ok = (nh_t >= 0) & alive_t[rows, nxt]
    valid = eye[None].expand(n_layers, n, n)
    for _ in range(max_hops):
        valid = eye[None] | (edge_ok & torch.gather(valid, 1, nxt))
    return valid.contiguous()


def shortest_path_lengths(adj, max_l: int = 64, device=None) -> torch.Tensor:
    """(N, N) int32 shortest path lengths via boolean adjacency powers;
    unreachable pairs get ``max_l + 1``, the diagonal is 0."""
    return _apsp_core(to_device(adj, torch.bool, device)[None], max_l)[0]


def diameter(adj, max_l: int = 64, device=None) -> int:
    """Longest finite shortest-path length."""
    d = shortest_path_lengths(adj, max_l, device)
    return int(d[d <= max_l].max())


def average_path_length(adj, max_l: int = 64, device=None) -> float:
    """Mean shortest-path length over ordered pairs s != t (unreachable
    pairs count as ``max_l + 1``), summed in float64 on the host."""
    d = shortest_path_lengths(adj, max_l, device).cpu().numpy()
    off = ~np.eye(d.shape[0], dtype=bool)
    return float(d.astype(np.float64)[off].mean())


def path_counts_exact_length(adj, l: int, device=None) -> torch.Tensor:
    """Number of length-``l`` walks between every pair (Theorem 1), by
    saturating ``count`` products."""
    path_engine()
    a = to_device(adj, torch.float32, device)
    out = a
    for _ in range(l - 1):
        out = semiring_matmul(out, a, "count")
    return out


def _min_path_stats(adj: torch.Tensor, max_l: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, counts of shortest walks) for an (N, N) f32 adjacency, the
    masked select done on the device."""
    dist = _apsp_core((adj != 0)[None], max_l)[0]
    counts = torch.where(dist == 1, adj, 0.0)
    cur = adj
    for l in range(2, max_l + 1):
        cur = semiring_matmul(cur, adj, "count")
        counts = torch.where(dist == l, cur, counts)
    return dist, counts


def min_path_stats(adj, max_l: int = 8, engine: Optional[str] = None,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair (l_min, c_min): shortest-path length and multiplicity
    (§4.2.1), as numpy arrays (int32 and float64).

    c_min counts *shortest walks*, which for the minimal length equal
    shortest paths (no repeated vertex fits in a minimal walk)."""
    path_engine(engine)
    dist, counts = _min_path_stats(to_device(adj, torch.float32, device),
                                   max_l)
    return dist.cpu().numpy(), counts.cpu().numpy().astype(np.float64)


def next_hop_options(adj, dist=None, max_l: int = 64,
                     device=None) -> np.ndarray:
    """(N, N, N) bool: ``opt[s, t, u]`` — u is a valid shortest-path next
    hop from s towards t (Appendix B.1.1's set-semiring tables as a
    distance test: ``adj[s, u]`` and ``dist[u, t] == dist[s, t] - 1``).
    O(N^3) memory; :func:`build_forwarding` keeps one choice per (s, t)."""
    a = to_device(adj, torch.bool, device)
    if dist is None:
        d = shortest_path_lengths(a, max_l)
    else:
        d = to_device(dist, torch.int32, a.device)
    out = a[:, None, :] & (d.T[None, :, :] == (d - 1)[:, :, None])
    return out.cpu().numpy()


def build_forwarding(adj, dist=None, seed: int = 0, max_l: int = 64,
                     device=None) -> np.ndarray:
    """Single-next-hop shortest-path table (§5.4): (N, N) int32
    ``nh[s, t]``, a random choice among equal-cost next hops
    (``nh[t, t] = t``, -1 where t is unreachable).  The L=1 case of
    :func:`forwarding_batched`."""
    a = to_device(adj, torch.bool, device)
    if dist is None:
        d = shortest_path_lengths(a, max_l)
    else:
        d = to_device(dist, torch.int32, a.device)
    nh = forwarding_batched(a[None], d[None],
                            prng.PRNGKey(seed, a.device))[0].cpu().numpy()
    nh[~(d <= max_l).cpu().numpy()] = -1
    np.fill_diagonal(nh, np.arange(a.shape[0]))
    return nh


def walk_paths(nh, s, t, max_hops: int, device=None) -> np.ndarray:
    """Router sequences by iterating one (N, N) forwarding table from
    ``s`` towards ``t`` (F,): (F, max_hops + 1) int32, repeating t once
    reached, -1 from the first hole on."""
    s = np.atleast_1d(np.asarray(s))
    return walk_paths_layers(to_device(nh, torch.int32, device)[None],
                             np.zeros(len(s), dtype=np.int32), s, t,
                             max_hops)


def walk_paths_layers(nh_stack, layer, s, t, max_hops: int,
                      device=None) -> np.ndarray:
    """Walk per-sample forwarding tables: sample i follows layer
    ``layer[i]`` of the (L, N, N) stack, all samples in one batched walk
    on the stack's device.  Returns (F, max_hops + 1) int32 router
    sequences (semantics of :func:`walk_paths`)."""
    nh = to_device(nh_stack, torch.int32, device)
    dev = nh.device
    layer = torch.as_tensor(np.asarray(layer, dtype=np.int64), device=dev)
    t = torch.as_tensor(np.asarray(t, dtype=np.int64), device=dev)
    cur = torch.as_tensor(np.asarray(s, dtype=np.int64), device=dev)
    out = [cur]
    for _ in range(max_hops):
        nxt = nh[layer, torch.clamp_min(cur, 0), t].long()
        dead = (nxt < 0) | (cur < 0)
        cur = torch.where(dead, -1, torch.where(cur == t, t, nxt))
        out.append(cur)
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
