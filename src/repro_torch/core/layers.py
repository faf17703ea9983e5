"""FatPaths layered routing (paper §5.2–§5.4).

A *layer* is a subset of links with its own shortest-path forwarding
function sigma_i.  Layer 0 always contains every link (minimal paths);
layers 1..n-1 are rho-sparsified and oriented into DAGs by random vertex
permutations (Listing 1), so their "shortest paths" are non-minimal paths
of the full network — the "fat" path diversity.

Construction schemes (§5.3):
  * ``rand``    — Listing 1 verbatim: keep directed edge (u, v) with
                  pi(u) < pi(v) and probability rho.
  * ``pi_min``  — overlap-minimising variant (§5.3.2): edge inclusion
                  probability is biased against edges already heavily
                  used by the shortest paths of earlier layers.
  * ``undir``   — ablation: sparsify without DAG orientation.
  * ``spain``   — SPAIN adaptation: each layer is a BFS spanning tree from a
                  random root.
  * ``past``    — PAST adaptation: per-layer re-randomised shortest-path
                  tie-breaks on the full graph.
  * ``ksp``     — k-shortest-paths style: every layer keeps all links and
                  routes on randomly perturbed link weights, by (min, +)
                  all-pairs distances.

``rand``, ``undir``, ``spain`` and ``past`` sample the layer adjacencies
on the host with numpy (the JAX package's exact draws); every layer's
APSP and forwarding tables then come out of one batched device pass
(:mod:`repro_torch.core.paths`, through the engine ``engine=`` or
``REPRO_PATH_ENGINE`` resolves).  ``ksp`` draws its weights on the device
from the threefry stream.  ``pi_min`` samples each layer on the device
from the edge usage of the layers built before it, so its layers are
built one after another.

Forwarding is destination-based: ``nh[i, s, t]`` = next hop at router s for
a packet tagged layer i, destination t; unreachable entries are -1.  The
tables are tensors on the device they were built on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import prng, resolve_device
from ..kernels.ref import fused_add_mul
from . import paths as paths_mod
from .topology import Topology

__all__ = ["LayeredRouting", "LoopCheckReport", "build_layers",
           "layer_disjoint_paths", "layer_disjoint_paths_batch",
           "usable_walks", "walk_edges"]

_UNREACH = 10_000


@dataclasses.dataclass(frozen=True)
class LoopCheckReport:
    """Outcome of :meth:`LayeredRouting.validate_loop_free`.

    Truthy iff every checked entry delivered.  ``witnesses`` holds the
    offending ``(layer, src, dst)`` triples (capped), each tagged in
    ``kinds`` as ``"hole"`` (walk fell off the table) or ``"loop"``
    (walk never reached dst within the hop budget).
    """

    ok: bool
    n_checked: int
    exhaustive: bool
    witnesses: Tuple[Tuple[int, int, int], ...] = ()
    kinds: Tuple[str, ...] = ()

    def __bool__(self) -> bool:
        return self.ok

    def describe(self) -> str:
        if self.ok:
            mode = "exhaustive" if self.exhaustive else "sampled"
            return f"loop-free ({self.n_checked} entries, {mode})"
        shown = ", ".join(f"{k}@(l={li},s={s},t={t})" for (li, s, t), k
                          in zip(self.witnesses, self.kinds))
        return (f"{len(self.witnesses)} bad forwarding entr"
                f"{'y' if len(self.witnesses) == 1 else 'ies'} "
                f"of {self.n_checked} checked: {shown}")


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
    # Fault lanes (repro_torch.core.failures): per-link death step and
    # churn intervals, (N, N) and (N, N, K, 2) int32 host arrays.
    link_down_step: Optional[np.ndarray] = None
    link_churn: Optional[np.ndarray] = None
    churn_conv: int = 0
    # Set when the stack was built with representation="compressed" (the
    # default under the blocked engine); nh stays the dense stack.
    compressed: Optional[paths_mod.CompressedTables] = None

    @property
    def n_layers(self) -> int:
        return int(self.nh.shape[0])

    def usable_layers(self, s: int, t: int) -> np.ndarray:
        return np.nonzero(self.reach[:, s, t].cpu().numpy())[0]

    def validate_loop_free(self, n_samples: int = 200, seed: int = 0,
                           max_hops: int = 64, raise_on_fail: bool = True,
                           max_witnesses: int = 16) -> LoopCheckReport:
        """Walk the tables for (layer, s, t) entries; every reachable
        entry must hit t within max_hops (shortest-path forwarding =>
        loop-free).  The samples are drawn on the host as the JAX package
        draws them and walk in one batched walk on the tables' device.

        When ``n_samples`` covers the whole ``L * N * (N - 1)`` entry
        space every entry is checked instead of sampling with
        replacement.  Returns a :class:`LoopCheckReport` naming the
        offending ``(layer, src, dst)`` witnesses (capped at
        ``max_witnesses``); with ``raise_on_fail`` (the default) a bad
        table raises ``AssertionError`` carrying the same witnesses."""
        L, N, _ = self.nh.shape
        total = L * N * (N - 1)
        exhaustive = n_samples >= total
        if exhaustive:
            li, s, t = np.nonzero(~np.eye(N, dtype=bool)[None]
                                  & np.ones((L, N, N), dtype=bool))
        else:
            rng = np.random.default_rng(seed)
            li = rng.integers(L, size=n_samples)
            s = rng.integers(N, size=n_samples)
            t = (s + 1 + rng.integers(N - 1, size=n_samples)) % N  # t != s
        keep = self.reach.cpu().numpy()[li, s, t]
        li, s, t = li[keep], s[keep], t[keep]
        if len(li) == 0:
            return LoopCheckReport(ok=True, n_checked=0,
                                   exhaustive=exhaustive)
        seqs = paths_mod.walk_paths_layers(self.nh, li, s, t, max_hops)
        holes = (seqs < 0).any(axis=1)
        stuck = ~holes & (seqs[:, -1] != t)
        bad = holes | stuck
        witnesses = []
        kinds = []
        for i in np.nonzero(bad)[0][:max_witnesses]:
            witnesses.append((int(li[i]), int(s[i]), int(t[i])))
            kinds.append("hole" if holes[i] else "loop")
        report = LoopCheckReport(ok=not bad.any(), n_checked=int(len(li)),
                                 exhaustive=exhaustive,
                                 witnesses=tuple(witnesses),
                                 kinds=tuple(kinds))
        if raise_on_fail and not report.ok:
            raise AssertionError(report.describe())
        return report


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


_WINDOW = 32


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum of a 1-D tensor in XLA:CPU's order, bitwise on any device.

    XLA on the CPU rewrites a 1-D f32 reduce of more than 32 elements
    into windows of 32 (zero padding split evenly, the odd element
    after), each summed in order from +0.0, and repeats on the window
    sums until at most 32 are left, which it sums in order.  Here every
    level is one padded reshape and 32 elementwise adds, so the card and
    the CPU round the same sums in the same order (``torch.sum`` does
    not: each device has its own reduction tree)."""
    x = x.to(torch.float32).reshape(-1)
    while x.shape[0] > _WINDOW:
        n = x.shape[0]
        pad = -n % _WINDOW
        rows = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)) \
            .reshape(-1, _WINDOW)
        x = torch.zeros(rows.shape[0], dtype=torch.float32, device=x.device)
        for j in range(_WINDOW):
            x = x + rows[:, j]
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


def _pi_min_stack(adj: torch.Tensor, nbr: torch.Tensor, iu: torch.Tensor,
                  ju: torch.Tensor, key: torch.Tensor, n_layers: int,
                  rho: float, max_l: int, engine: str = "dense"):
    """The §5.3.2 build: each layer a DAG whose edges are kept with a
    probability that shrinks with their accumulated usage by the layers
    before it (counting-semiring fixpoint), then its tables; the layers
    are built one after another, as the JAX package's scan builds them.
    Arithmetic follows its program: ``1 - 0.75 * norm`` is one fused
    multiply-add (XLA contracts it) and the probabilities' normaliser is
    :func:`xla_sum`."""
    n = adj.shape[0]
    e = iu.shape[0]
    k0, krest = prng.split(key)
    nh0, reach0, dist0 = paths_mod._layer_tables_core(adj[None], nbr, k0,
                                                      max_l, engine)
    usage = paths_mod._edge_usage_core(nh0[0], reach0[0], max_l)
    las, nhs, reaches, dists = [adj[None]], [nh0], [reach0], [dist0]
    keys = prng.split(krest, n_layers - 1) if n_layers > 1 else []
    scale = np.float32(rho) * np.float32(e)
    one = torch.ones(e, dtype=torch.float32, device=adj.device)
    for k in keys:
        k_pi, k_keep, k_fw = prng.split(k, 3)
        u_sym = usage + usage.T
        mx = u_sym.max()
        norm = torch.where(mx > 0, u_sym / torch.clamp_min(mx, 1e-30), 0.0)
        pi = prng.permutation(k_pi, n)
        # Edge keep-probability shrinks with historical usage but keeps
        # expected density ~= rho.
        raw = fused_add_mul(one, torch.full_like(one, -0.75), norm[iu, ju])
        prob = raw * (float(scale) / torch.clamp_min(xla_sum(raw), 1e-9))
        keep = prng.uniform(k_keep, (e,)) < torch.clamp(prob, 0.0, 1.0)
        fwd = pi[iu] < pi[ju]
        uu = torch.where(fwd, iu, ju)
        vv = torch.where(fwd, ju, iu)
        la = torch.zeros((n, n), dtype=torch.bool, device=adj.device)
        la[uu, vv] = keep
        nh, reach, dist = paths_mod._layer_tables_core(la[None], nbr, k_fw,
                                                       max_l, engine)
        usage = usage + paths_mod._edge_usage_core(nh[0], reach[0], max_l)
        las.append(la[None])
        nhs.append(nh)
        reaches.append(reach)
        dists.append(dist)
    return (torch.cat(las), torch.cat(nhs), torch.cat(reaches),
            torch.cat(dists))


def _ksp_next_hops(has_edge: torch.Tensor, w_nbr: torch.Tensor,
                   d: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Next hops minimising ``w[s, u] + D[u, t]`` over the neighbors u of
    s (first minimum on ties) for the destination columns of ``d`` (N, C);
    -1 where no neighbor reaches t."""
    inf = torch.tensor(float("inf"), device=d.device)
    cost = torch.where(has_edge[:, :, None],
                       w_nbr[:, :, None] + d[nbr], inf)          # (N, D, C)
    j = cost.argmin(dim=1)                                    # first minimum
    best = torch.gather(nbr, 1, j).to(torch.int32)
    return torch.where(torch.isfinite(cost.amin(dim=1)), best, -1)


def _ksp_stack(adj: torch.Tensor, nbr: torch.Tensor, key: torch.Tensor,
               n_layers: int, max_l: int, engine: str = "dense"):
    """k-shortest-paths-style layers: per-layer perturbed edge weights,
    (min, +) all-pairs distances, and next hops minimising
    ``w[s, u] + D[u, t]`` over neighbors u (first minimum on ties).
    Every layer keeps all links; reach and dist are layer 0's.  The
    blocked engine takes the destinations ``_CHUNK`` at a time, an
    (N, Dmax, _CHUNK) cost slab instead of the (N, Dmax, N) cube; the
    argmin is per column, so the tables are the same."""
    n = adj.shape[0]
    dev = adj.device
    idx = torch.arange(n, device=dev)
    k0, kw = prng.split(key)
    nh0, _, dist0 = paths_mod._layer_tables_core(adj[None], nbr, k0, max_l,
                                                 engine)
    hop = dist0[0]
    u01 = prng.uniform(kw, (n_layers - 1, n, n))
    inf = torch.tensor(float("inf"), device=dev)
    w = torch.where(adj[None], 1.0 + 0.25 * u01, inf)
    w = torch.minimum(w, w.transpose(1, 2))
    w[:, idx, idx] = 0.0
    d = paths_mod._minplus_apsp_core(w, max_l)

    nbr = nbr.long()
    has_edge = torch.gather(adj, 1, nbr)                      # (N, D)
    chunk = paths_mod._CHUNK if engine == "blocked" else n
    nh = [nh0]
    for w_l, d_l in zip(w, d):
        w_nbr = torch.gather(w_l, 1, nbr)                     # (N, D)
        nh_l = torch.cat([_ksp_next_hops(has_edge, w_nbr, d_l[:, c:c + chunk],
                                         nbr)
                          for c in range(0, n, chunk)], dim=1)
        nh_l[idx, idx] = idx.to(torch.int32)
        nh.append(nh_l[None])
    shape = (n_layers, n, n)
    return (adj[None].expand(shape).clone(), torch.cat(nh),
            (hop <= max_l)[None].expand(shape).clone(),
            hop[None].expand(shape).clone())


def build_layers(topo: Topology, n_layers: int, rho: float,
                 scheme: str = "rand", seed: int = 0,
                 max_len: Optional[int] = None,
                 engine: Optional[str] = None,
                 representation: Optional[str] = None,
                 device="cuda") -> LayeredRouting:
    """Construct the FatPaths layer stack (layer 0 = all links, minimal).

    Layer adjacencies are sampled on the host (``ksp``: every layer is the
    whole graph, with weights drawn on the device; ``pi_min``: sampled on
    the device, layer by layer); all L layers' tables come out of one
    batched pass on ``device`` (``pi_min``: one pass a layer).
    ``build_stats`` records the host (sampling), device (table
    construction) and compression wall-time split.

    ``engine`` overrides the ``REPRO_PATH_ENGINE`` resolution (``dense``
    below 512 routers, ``blocked`` from there up; both give the same
    tables).  ``representation="compressed"`` attaches
    :class:`~repro_torch.core.paths.CompressedTables` (the default when
    the engine resolves blocked), ``"dense"`` keeps the dense stack only.
    """
    dev = resolve_device(device)
    adj = np.asarray(topo.adj, dtype=bool)
    n = adj.shape[0]
    eng = paths_mod.path_engine(n, engine)
    if representation in (None, "", "auto"):
        rep = "compressed" if eng == "blocked" else "dense"
    elif representation in ("dense", "compressed"):
        rep = representation
    else:
        raise ValueError(f"unknown representation {representation!r}")
    if max_len is None:
        # Allow "almost minimal" detours: nominal diameter + slack.
        max_len = max(6, topo.diameter_nominal + 4)
    rng = np.random.default_rng(seed)
    key = prng.PRNGKey(seed, dev)
    nbr = torch.as_tensor(paths_mod.neighbor_table(adj), device=dev)

    t0 = time.perf_counter()
    if scheme == "pi_min":
        iu, ju = np.nonzero(np.triu(adj, 1))
        t_dev = time.perf_counter()
        la, nh, reach, dist = _pi_min_stack(
            torch.as_tensor(adj, device=dev), nbr,
            torch.as_tensor(iu, device=dev), torch.as_tensor(ju, device=dev),
            key, n_layers, float(rho), max_len, eng)
    elif scheme == "ksp":
        t_dev = time.perf_counter()
        la, nh, reach, dist = _ksp_stack(torch.as_tensor(adj, device=dev),
                                         nbr, key, n_layers, max_len, eng)
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
        nh, reach, dist = paths_mod._layer_tables_core(la, nbr, key, max_len,
                                                       eng)
    paths_mod._sync(dev)
    t1 = time.perf_counter()

    pathlen = torch.where(reach, dist, _UNREACH).to(torch.int16)
    compressed = None
    if rep == "compressed":
        compressed = paths_mod.CompressedTables.from_dense(nh)
    paths_mod._sync(dev)
    t2 = time.perf_counter()
    return LayeredRouting(
        topo=topo, scheme=scheme, rho=rho,
        nh=nh, reach=reach, pathlen=pathlen, layer_adj=la,
        build_stats={"total_s": t2 - t0, "device_s": t1 - t_dev,
                     "host_s": t_dev - t0, "compress_s": t2 - t1},
        compressed=compressed,
    )


def _greedy_disjoint(paths: np.ndarray, reach_lt: np.ndarray, t: int) -> int:
    """Greedy edge-disjoint count over one (L, max_hops+1) path batch."""
    kept_edges = set()
    count = 0
    for i in range(paths.shape[0]):
        if not reach_lt[i]:
            continue
        path = paths[i]
        edges = set()
        ok = True
        prev = int(path[0])
        for v in path[1:]:
            v = int(v)
            if prev == t:
                break
            if v < 0:
                ok = False
                break
            e = (min(prev, v), max(prev, v))
            if e in kept_edges or e in edges:
                ok = False
                break
            edges.add(e)
            prev = v
        if ok and prev == t and edges:
            kept_edges |= edges
            count += 1
    return count


def layer_disjoint_paths_batch(lr: LayeredRouting, s: np.ndarray,
                               t: np.ndarray, max_hops: int = 16
                               ) -> np.ndarray:
    """:func:`layer_disjoint_paths` for many (s, t) pairs: every (pair,
    layer) table walk happens in one batched walk on the tables' device
    (off the compressed tables when the routing carries them); only the
    greedy edge-disjointness filter runs per pair on the host."""
    s = np.asarray(s, dtype=np.int32)
    t = np.asarray(t, dtype=np.int32)
    n_pairs = len(s)
    L = lr.n_layers
    li = np.tile(np.arange(L, dtype=np.int32), n_pairs)
    tables = lr.compressed if lr.compressed is not None else lr.nh
    walks = paths_mod.walk_paths_layers(tables, li, np.repeat(s, L),
                                        np.repeat(t, L), max_hops)
    walks = walks.reshape(n_pairs, L, max_hops + 1)
    reach = lr.reach.cpu().numpy()
    out = np.zeros(n_pairs, dtype=np.int64)
    for p in range(n_pairs):
        out[p] = _greedy_disjoint(walks[p], reach[:, s[p], t[p]], int(t[p]))
    return out


def layer_disjoint_paths(lr: LayeredRouting, s: int, t: int,
                         max_hops: int = 16) -> int:
    """How many pairwise edge-disjoint (s->t) paths do the layers realise?

    Greedy: walk each usable layer's path, keep it if it shares no
    (undirected) edge with already-kept paths.  This is the quantity behind
    the paper's "nine layers suffice for three disjoint paths" (Fig 12).
    """
    return int(layer_disjoint_paths_batch(lr, np.array([s]), np.array([t]),
                                          max_hops)[0])


def usable_walks(lr: LayeredRouting, s: np.ndarray, t: np.ndarray,
                 max_hops: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walk every usable (pair, layer) of the pairs ``(s[k], t[k])``: the
    layers whose ``reach`` holds, in one batched walk on the tables'
    device (off the compressed tables when the routing carries them).

    Returns ``(pair, layer, seqs)``: the (W,) pair and layer index of each
    walk, pairs in the given order and layers ascending within a pair, and
    the (W, max_hops + 1) int32 router sequences of
    :func:`paths.walk_paths_layers`."""
    s = np.asarray(s, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    dev = lr.reach.device
    usable = lr.reach[:, torch.as_tensor(s, device=dev),
                      torch.as_tensor(t, device=dev)].T.cpu().numpy()
    pair, layer = np.nonzero(usable)
    tables = lr.compressed if lr.compressed is not None else lr.nh
    seqs = paths_mod.walk_paths_layers(tables, layer, s[pair], t[pair],
                                       max_hops)
    return pair, layer, seqs


def walk_edges(seqs: np.ndarray, t: np.ndarray, eix: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The hops of (W, H + 1) walks towards ``t`` (W,) as edge ids.

    Returns ``(edges, stop)``: (W, H) directed edge ids of the hops
    ``(seq[j], seq[j + 1])`` from the (N, N) ``eix`` (-1 where there is
    no such edge or the walk holds a hole), and per walk the first hop
    ``j`` at which ``seq[j] == t`` or ``seq[j + 1] < 0`` (H if none): the
    hop where a reading of the walk stops.  Which walks a caller accepts
    is the caller's rule."""
    a, b = seqs[:, :-1], seqs[:, 1:]
    edges = np.where((a >= 0) & (b >= 0),
                     eix[np.maximum(a, 0), np.maximum(b, 0)], -1)
    halt = (a == t[:, None]) | (b < 0)
    stop = np.where(halt.any(axis=1), halt.argmax(axis=1), halt.shape[1])
    return edges, stop
