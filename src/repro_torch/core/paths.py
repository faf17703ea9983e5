"""Path analysis via adjacency-matrix algebra (paper Appendix B.1).

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

Two *engines* build the tables, as in the JAX package:

* ``dense``   — (L, N, N) boolean-semiring products for APSP and an
                (N, Dmax, N) candidate cube a layer for forwarding;
* ``blocked`` — the frontier APSP, which relaxes through the (N, Dmax)
                in-neighbor table instead of multiplying, and forwarding
                built ``_CHUNK`` destinations at a time, so no
                intermediate exceeds O(N * Dmax * _CHUNK).  Both compute
                exact BFS levels and consume the same per-entry uniforms,
                so their tables are bitwise equal.

``REPRO_PATH_ENGINE=dense|blocked|auto`` selects, read at each call
(default ``auto``: ``blocked`` from 512 routers up); an ``engine=``
argument overrides it.  :class:`CompressedTables` is the blocked engine's
table representation: per (layer, router, destination block) the set of
next hops and a uint8 index into it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

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
    "representation_for",
    "CompressedTables",
    "to_device",
]

PATH_ENGINES = ("dense", "blocked", "auto")

# auto threshold, the JAX package's: from this router count up ``auto``
# resolves to the blocked engine.
_BLOCKED_MIN_N = 512

# Destination chunk of the blocked engine's gathers (and row block of its
# walk counts): every intermediate stays O(N * Dmax * _CHUNK).
_CHUNK = 256


def path_engine(n: Optional[int] = None,
                override: Optional[str] = None) -> str:
    """Resolve the engine: an explicit ``override`` wins, then
    ``REPRO_PATH_ENGINE`` (``dense|blocked|auto``, default ``auto``),
    read at each call; ``auto`` is ``blocked`` from ``_BLOCKED_MIN_N``
    routers up (``n=None``, no size in hand, resolves to ``dense``)."""
    eng = override or os.environ.get("REPRO_PATH_ENGINE", "") or "auto"
    if eng not in PATH_ENGINES:
        raise ValueError(f"unknown path engine {eng!r}; "
                         f"choose from {PATH_ENGINES}")
    if eng == "auto":
        return "blocked" if (n is not None and n >= _BLOCKED_MIN_N) \
            else "dense"
    return eng


def representation_for(n: Optional[int] = None,
                       override: Optional[str] = None) -> str:
    """Resolve the table representation (``dense`` | ``compressed``): an
    explicit override wins, else it follows the engine — the blocked
    engine carries :class:`CompressedTables`, the dense one plain
    (L, N, N) tables only."""
    if override in ("dense", "compressed"):
        return override
    if override not in (None, "", "auto"):
        raise ValueError(f"unknown table representation {override!r}; "
                         "choose 'dense', 'compressed' or 'auto'")
    return "compressed" if path_engine(n) == "blocked" else "dense"


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


def _apsp_blocked_core(adj: torch.Tensor, nbr_in: torch.Tensor,
                       max_l: int) -> torch.Tensor:
    """Frontier APSP, the blocked engine's :func:`_apsp_core`.

    The relaxation ``nreach[s, t] = OR_u reach[s, u] & adj[u, t]`` has
    candidates u only among the in-neighbors of t, so it is gathered
    through the (N, Dmax) in-neighbor table ``nbr_in`` instead of
    multiplied, ``_CHUNK`` destinations at a time: an (N, C, Dmax)
    intermediate.  ``edge_ok[t, j]`` masks the slots whose edge
    ``nbr_in[t, j] -> t`` the layer lacks (pad slots included).  Each
    sweep is one exact BFS level, as in the dense engine, so the
    distances are bitwise equal; one host sync per sweep decides whether
    another is needed.  Columns are independent, so the last chunk is
    just shorter (the JAX package pads it with masked rows)."""
    n_layers, n, _ = adj.shape
    nbr_in = nbr_in.long()
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    out = torch.empty((n_layers, n, n), dtype=torch.int32, device=adj.device)
    for li in range(n_layers):
        adj_l = adj[li]
        edge_ok = torch.gather(adj_l.T, 1, nbr_in)              # (N, D)
        dist = torch.where(eye, 0,
                           torch.where(adj_l, 1, max_l + 1)).to(torch.int32)
        reach = adj_l | eye
        l, go = 1, True
        while go and l < max_l:
            nreach = torch.cat(
                [(reach[:, nbr_in[c:c + _CHUNK]]                # (N, C, D)
                  & edge_ok[None, c:c + _CHUNK]).any(dim=2)
                 for c in range(0, n, _CHUNK)], dim=1)
            newly = nreach & ~reach
            dist = torch.where(newly & (dist > l + 1), l + 1,
                               dist).to(torch.int32)
            reach = reach | nreach
            l += 1
            go = bool(newly.any())
        out[li] = dist
    return out


def _next_hops(has_edge: torch.Tensor, dist_nbr: torch.Tensor,
               dist: torch.Tensor, u: torch.Tensor,
               nbr: torch.Tensor) -> torch.Tensor:
    """One layer's next hops for a set of destination columns: with
    ``dist`` (N, C), ``dist_nbr = dist[nbr]`` (N, D, C) and uniforms
    ``u`` (N, C), entry (s, t) is the r-th of the valid candidates
    ``{nbr[s, j] : has_edge[s, j], dist[nbr[s, j], t] == dist[s, t] - 1}``
    with ``r = floor(u * count)``; -1 where there is none.  Every column
    is computed on its own."""
    # ok[s, j, t]: edge s->nbr[s,j] in this layer, one hop closer to t.
    ok = has_edge[:, :, None] & (dist_nbr + 1 == dist[:, None, :])
    cnt = ok.sum(dim=1, dtype=torch.int32)                      # (N, C)
    r = torch.minimum(torch.clamp_min((u * cnt).to(torch.int32), 0),
                      torch.clamp_min(cnt - 1, 0))
    csum = torch.cumsum(ok.to(torch.int32), dim=1, dtype=torch.int32)
    pick = ok & (csum == (r + 1)[:, None, :])
    j = pick.to(torch.int32).argmax(dim=1)                      # first True
    nh = torch.gather(nbr, 1, j).to(torch.int32)
    return torch.where(cnt > 0, nh, -1)


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
        has_edge = torch.gather(adj[li], 1, nbr)                # (N, D)
        out[li] = _next_hops(has_edge, dist[li][nbr], dist[li], u01[li], nbr)
    idx = torch.arange(n, device=adj.device)
    out[:, idx, idx] = idx.to(torch.int32)
    return out


def _forwarding_blocked_core(adj: torch.Tensor, dist: torch.Tensor,
                             nbr: torch.Tensor,
                             key: torch.Tensor) -> torch.Tensor:
    """Destination-chunked :func:`_forwarding_core`: each chunk gathers an
    (N, Dmax, _CHUNK) candidate-distance slab instead of the whole
    (N, Dmax, N) cube.  The uniforms are the same single (L, N, N) draw,
    sliced per chunk, and every column is computed on its own, so the
    tables are bitwise the dense engine's."""
    L, n, _ = adj.shape
    u01 = prng.uniform(key, (L, n, n))
    nbr = nbr.long()
    out = torch.empty((L, n, n), dtype=torch.int32, device=adj.device)
    for li in range(L):
        has_edge = torch.gather(adj[li], 1, nbr)                # (N, D)
        for c in range(0, n, _CHUNK):
            dist_c = dist[li, :, c:c + _CHUNK]                  # (N, C)
            out[li, :, c:c + _CHUNK] = _next_hops(
                has_edge, dist_c[nbr], dist_c, u01[li, :, c:c + _CHUNK], nbr)
    idx = torch.arange(n, device=adj.device)
    out[:, idx, idx] = idx.to(torch.int32)
    return out


def _layer_tables_core(adj: torch.Tensor, nbr: torch.Tensor, key: torch.Tensor,
                       max_l: int, engine: str = "dense",
                       nbr_in: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """APSP + forwarding through either engine: ``(nh, reach, dist)``,
    each (L, N, N).  ``nbr_in`` is the in-neighbor table the frontier APSP
    relaxes through; ``None`` reuses ``nbr``, which is right whenever
    ``nbr`` comes from a symmetric superset of every layer (the topology's
    graph, as in every builder of :mod:`repro_torch.core.layers`)."""
    if engine == "blocked":
        dist = _apsp_blocked_core(adj, nbr if nbr_in is None else nbr_in,
                                  max_l)
        nh = _forwarding_blocked_core(adj, dist, nbr, key)
    else:
        dist = _apsp_core(adj, max_l)
        nh = _forwarding_core(adj, dist, nbr, key)
    return nh, dist <= max_l, dist


def _nbr_tensor(adj_union: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(neighbor_table(adj_union), device=device)


# -----------------------------------------------------------------------------
# Batched entry points.
# -----------------------------------------------------------------------------
def apsp_batched(adj, max_l: int = 64, device=None,
                 engine: Optional[str] = None) -> torch.Tensor:
    """All-pairs shortest path lengths for an (L, N, N) adjacency stack;
    unreachable pairs get ``max_l + 1``.  ``engine`` overrides the
    ``REPRO_PATH_ENGINE`` resolution; both engines give the same bits
    (the blocked one relaxes over the stack union's in-neighbors, so an
    asymmetric stack is right too)."""
    adj_t = to_device(adj, torch.bool, device)
    if path_engine(adj_t.shape[-1], engine) == "blocked":
        union = adj_t.any(dim=0).cpu().numpy()
        return _apsp_blocked_core(adj_t, _nbr_tensor(union.T, adj_t.device),
                                  max_l)
    return _apsp_core(adj_t, max_l)


def forwarding_batched(adj, dist, key: torch.Tensor, device=None,
                       engine: Optional[str] = None) -> torch.Tensor:
    """Random-tie-break forwarding tables for an (L, N, N) stack; ``key``
    seeds the per-entry uniform choice (one stream for the stack)."""
    adj_t = to_device(adj, torch.bool, device)
    core = (_forwarding_blocked_core
            if path_engine(adj_t.shape[-1], engine) == "blocked"
            else _forwarding_core)
    return core(adj_t, to_device(dist, torch.int32, adj_t.device),
                _nbr_tensor(adj_t.any(dim=0).cpu().numpy(), adj_t.device),
                key.to(adj_t.device))


def layer_tables_batched(adj, key: torch.Tensor, max_l: int, device=None,
                         engine: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """APSP + forwarding for a whole layer stack on one device.

    Returns ``(nh, reach, dist)`` each (L, N, N).  The host's only job is
    the (N, Dmax) union neighbor table (and, for the blocked engine, the
    union's in-neighbor table: a failure-masked stack is asymmetric)."""
    adj_t = to_device(adj, torch.bool, device)
    union = adj_t.any(dim=0).cpu().numpy()
    eng = path_engine(adj_t.shape[-1], engine)
    nbr_in = (_nbr_tensor(union.T, adj_t.device) if eng == "blocked"
              else None)
    return _layer_tables_core(adj_t, _nbr_tensor(union, adj_t.device),
                              key.to(adj_t.device), max_l, eng, nbr_in)


def minplus_apsp_batched(w, max_l: int, device=None) -> torch.Tensor:
    """(min, +) all-pairs distances for a (K, N, N) weight stack.

    Precondition: edge weights are >= 1 (+inf for non-edges, 0 diagonal)
    and every hop-distance is <= ``max_l``: the squaring count is sized
    for shortest weighted paths of at most ~1.25 * max_l hops, which is
    what the ``ksp`` scheme's 1 + 0.25*U(0,1) perturbed unit weights
    guarantee.  Sub-unit weights would admit longer optimal paths than
    the iteration covers and silently overestimate distances."""
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


# -----------------------------------------------------------------------------
# Compressed forwarding tables: per-router (dst-block, next-hop set).
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompressedTables:
    """Forwarding tables as per-router next-hop *sets* per destination
    block, instead of a dense (L, N, N) int32 stack.

    A shortest-path table row has at most ``Dmax`` distinct next hops and
    neighboring destinations mostly share them, so each (layer, router,
    destination block) keeps the sorted set of next hops seen in that
    block (``nh_sets[l, s, b, :]``, -1 padded) and the dense entry becomes
    a uint8 index into it (``sel``).  Exact:
    ``nh[l, s, t] == nh_sets[l, s, t // block, sel[l, s, t]]``.

    ``block=None`` starts at 512 destinations and halves until the
    largest set ``K`` fits the uint8 selector (``K <= 255``; a high-radix
    FT2 spine needs a smaller block).  The tensors lie on the device of
    the tables they were built from, and equal the JAX package's numpy
    arrays bitwise (a stable sort stands in for numpy's stable
    argsort)."""

    nh_sets: torch.Tensor   # (L, N, nb, K) int32, -1 padded
    sel: torch.Tensor       # (L, N, N) uint8 index into nh_sets' last axis
    block: int
    n: int

    _AUTO_BLOCK = 512

    @classmethod
    def from_dense(cls, nh, block: Optional[int] = None) -> "CompressedTables":
        nh = to_device(nh, torch.int32)
        L, n, _ = nh.shape
        auto = block is None
        block = cls._AUTO_BLOCK if auto else int(block)
        while True:
            nb = -(-n // block)
            v = torch.full((L, n, nb * block), -1, dtype=torch.int32,
                           device=nh.device)
            v[:, :, :n] = nh
            v = v.reshape(L, n, nb, block)
            sv, order = torch.sort(v, dim=-1, stable=True)
            new = torch.ones(sv.shape, dtype=torch.bool, device=nh.device)
            new[..., 1:] = sv[..., 1:] != sv[..., :-1]
            rank_sorted = torch.cumsum(new, dim=-1, dtype=torch.int32) - 1
            k = int(rank_sorted[..., -1].max()) + 1
            if k <= 255:
                break
            if not auto or block <= 2:
                raise ValueError(f"next-hop set size {k} exceeds uint8 "
                                 f"selector at block={block}")
            block //= 2
        rank_sorted = rank_sorted.long()
        # Entries of one rank hold equal values, so the scatter is exact.
        nh_sets = torch.full((L, n, nb, k), -1, dtype=torch.int32,
                             device=nh.device).scatter_(-1, rank_sorted, sv)
        sel = torch.empty(v.shape, dtype=torch.uint8, device=nh.device) \
            .scatter_(-1, order, rank_sorted.to(torch.uint8))
        return cls(nh_sets=nh_sets,
                   sel=sel.reshape(L, n, nb * block)[:, :, :n].contiguous(),
                   block=block, n=n)

    def to(self, device) -> "CompressedTables":
        """The same tables on ``device``."""
        return dataclasses.replace(self, nh_sets=self.nh_sets.to(device),
                                   sel=self.sel.to(device))

    def dense(self) -> torch.Tensor:
        """The exact dense (L, N, N) int32 stack this was built from."""
        L, n, nb, k = self.nh_sets.shape
        t = torch.arange(n, device=self.sel.device)
        flat = (t // self.block * k)[None, None, :] + self.sel.long()
        return torch.gather(self.nh_sets.reshape(L, n, nb * k), 2, flat)

    def lookup(self, layer: torch.Tensor, cur: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
        """Next hops ``nh[layer, cur, t]`` off the compressed form (index
        tensors on the tables' device, broadcast together)."""
        k = self.sel[layer, cur, t].long()
        return self.nh_sets[layer, cur, t // self.block, k]

    @property
    def nbytes(self) -> int:
        return (self.nh_sets.numel() * self.nh_sets.element_size()
                + self.sel.numel() * self.sel.element_size())


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


def _min_path_counts_rows(adj: torch.Tensor, dist: torch.Tensor,
                          max_l: int) -> torch.Tensor:
    """Shortest-walk counts with the power sequence advanced one
    ``(_CHUNK, N)`` row block at a time, so that the only (N, N) f32
    tensors alive are the adjacency and the result.  Rows are padded with
    zeros to whole blocks, as the JAX package pads them (their distances
    0 select nothing), so every product is (_CHUNK, N) x (N, N)."""
    n = adj.shape[0]
    npad = -(-n // _CHUNK) * _CHUNK
    a_rows = torch.zeros((npad, n), dtype=torch.float32, device=adj.device)
    a_rows[:n] = adj
    d_rows = torch.zeros((npad, n), dtype=torch.int32, device=adj.device)
    d_rows[:n] = dist
    out = torch.empty((npad, n), dtype=torch.float32, device=adj.device)
    for r in range(0, npad, _CHUNK):
        cur, d_r = a_rows[r:r + _CHUNK], d_rows[r:r + _CHUNK]
        counts = torch.where(d_r == 1, cur, 0.0)
        for l in range(2, max_l + 1):
            cur = semiring_matmul(cur, adj, "count")
            counts = torch.where(d_r == l, cur, counts)
        out[r:r + _CHUNK] = counts
    return out[:n]


def min_path_stats(adj, max_l: int = 8, engine: Optional[str] = None,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair (l_min, c_min): shortest-path length and multiplicity
    (§4.2.1), as numpy arrays (int32 and float64).

    c_min counts *shortest walks*, which for the minimal length equal
    shortest paths (no repeated vertex fits in a minimal walk).  Under
    the blocked engine the distances come from the frontier APSP and the
    counts from row-blocked powers of the 0/1 adjacency."""
    a = to_device(adj, torch.float32, device)
    if path_engine(a.shape[-1], engine) == "blocked":
        a_bool = a != 0
        dist = _apsp_blocked_core(
            a_bool[None], _nbr_tensor(a_bool.cpu().numpy().T, a.device),
            max_l)[0]
        counts = _min_path_counts_rows(a_bool.to(torch.float32), dist, max_l)
    else:
        dist, counts = _min_path_stats(a, max_l)
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


def walk_paths_layers(nh_stack: Union[torch.Tensor, np.ndarray,
                                       CompressedTables],
                      layer, s, t, max_hops: int,
                      device=None) -> np.ndarray:
    """Walk per-sample forwarding tables: sample i follows layer
    ``layer[i]`` of the (L, N, N) stack, all samples in one batched walk
    on the stack's device.  ``nh_stack`` may be a
    :class:`CompressedTables`: the walk then never touches a dense table,
    and its lookups are exact, so the sequences are the same.  Returns
    (F, max_hops + 1) int32 router sequences (semantics of
    :func:`walk_paths`)."""
    if isinstance(nh_stack, CompressedTables):
        ct = nh_stack if device is None else nh_stack.to(resolve_device(device))
        dev, lookup = ct.sel.device, ct.lookup
    else:
        nh = to_device(nh_stack, torch.int32, device)
        dev = nh.device

        def lookup(li, cur, tt):
            return nh[li, cur, tt]
    layer = torch.as_tensor(np.asarray(layer, dtype=np.int64), device=dev)
    t = torch.as_tensor(np.asarray(t, dtype=np.int64), device=dev)
    cur = torch.as_tensor(np.asarray(s, dtype=np.int64), device=dev)
    out = [cur]
    for _ in range(max_hops):
        nxt = lookup(layer, torch.clamp_min(cur, 0), t).long()
        dead = (nxt < 0) | (cur < 0)
        cur = torch.where(dead, -1, torch.where(cur == t, t, nxt))
        out.append(cur)
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
