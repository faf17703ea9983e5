"""Topology generators for the networks studied in the FatPaths paper.

Every generator returns a :class:`Topology` holding a symmetric boolean
adjacency matrix over routers, the per-router endpoint concentration, and
bookkeeping (name, structural parameters, nominal diameter).

Implemented (paper §2.2 / Appendix A):
  * Slim Fly (MMS construction, diameter 2), prime ``q`` only — all paper
    instances reproduced here use prime q (19, 29); see DESIGN.md §7.
  * Dragonfly ("balanced", a = 2p = 2h, g = a·h + 1), diameter 3.
  * Jellyfish (random regular graph), flexible.
  * Xpander (single ℓ-lift of a complete graph), semi-flexible.
  * HyperX / Hamming graph (regular, L ∈ {2, 3}); L=2 is a Flattened
    Butterfly.
  * Three-stage fat tree (Clos, D = 4) with k/2 endpoints per edge router.
  * Complete graph (clique) and star (single crossbar) baselines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

__all__ = [
    "Topology",
    "slim_fly",
    "dragonfly",
    "jellyfish",
    "xpander",
    "hyperx",
    "fat_tree",
    "two_layer_fat_tree",
    "cost_matched_ft2",
    "clique",
    "star",
    "equivalent_jellyfish",
    "by_name",
    "TOPOLOGY_FAMILIES",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """An interconnection network: routers + full-duplex inter-router links.

    Attributes:
      name: human-readable identifier, e.g. ``"SF(q=19)"``.
      family: short family tag (``sf``, ``df``, ``jf``, ``xp``, ``hx``,
        ``ft``, ``clique``, ``star``).
      adj: (N_r, N_r) symmetric bool adjacency, zero diagonal.
      concentration: (N_r,) int endpoints attached to each router.
      diameter_nominal: the topology's designed diameter (paper Table 5);
        the *measured* diameter is available via ``repro_torch.core.paths``.
      params: structural input parameters.
    """

    name: str
    family: str
    adj: np.ndarray
    concentration: np.ndarray
    diameter_nominal: int
    params: Dict[str, int]

    # ---- derived quantities -------------------------------------------------
    @property
    def n_routers(self) -> int:
        return int(self.adj.shape[0])

    @property
    def n_endpoints(self) -> int:
        return int(self.concentration.sum())

    @property
    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1).astype(np.int64)

    @property
    def network_radix(self) -> int:
        """k' — max channels from a router to other routers."""
        return int(self.degrees.max())

    @property
    def router_radix(self) -> int:
        """k = k' + p (max over routers)."""
        return int((self.degrees + self.concentration).max())

    @property
    def n_links(self) -> int:
        """Number of undirected inter-router cables."""
        return int(self.adj.sum()) // 2

    @property
    def n_cables(self) -> int:
        """All cables including endpoint links (paper Fig 10 accounting)."""
        return self.n_links + self.n_endpoints

    @property
    def edge_density(self) -> float:
        """(#cables)/(#endpoints), the paper's cost proxy (Fig 10)."""
        return self.n_cables / max(1, self.n_endpoints)

    # ---- edge indexing helpers ---------------------------------------------
    def directed_edges(self) -> np.ndarray:
        """(E_dir, 2) int32 array of directed edges (u, v), lexicographic."""
        u, v = np.nonzero(self.adj)
        return np.stack([u, v], axis=1).astype(np.int32)

    def edge_index_matrix(self) -> np.ndarray:
        """(N_r, N_r) int32: directed edge id for (u, v), -1 if no edge."""
        e = self.directed_edges()
        m = np.full((self.n_routers, self.n_routers), -1, dtype=np.int32)
        m[e[:, 0], e[:, 1]] = np.arange(len(e), dtype=np.int32)
        return m

    def validate(self) -> None:
        a = self.adj
        assert a.ndim == 2 and a.shape[0] == a.shape[1], "square"
        assert a.dtype == np.bool_, "bool adjacency"
        assert not a.diagonal().any(), "no self loops"
        assert (a == a.T).all(), "undirected"
        assert (self.concentration >= 0).all()


def _finish(name, family, adj, conc, d, params) -> Topology:
    adj = np.asarray(adj, dtype=np.bool_)
    np.fill_diagonal(adj, False)
    adj = adj | adj.T
    conc = np.asarray(conc, dtype=np.int64)
    t = Topology(name, family, adj, conc, d, dict(params))
    t.validate()
    return t


# -----------------------------------------------------------------------------
# Slim Fly (MMS graphs) — Besta & Hoefler SC'14, diameter 2.
# -----------------------------------------------------------------------------
def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for f in range(2, int(math.isqrt(n)) + 1):
        if n % f == 0:
            return False
    return True


def _primitive_root(q: int) -> int:
    """Smallest primitive root modulo prime q."""
    phi = q - 1
    factors = set()
    m = phi
    f = 2
    while f * f <= m:
        while m % f == 0:
            factors.add(f)
            m //= f
        f += 1
    if m > 1:
        factors.add(m)
    for g in range(2, q):
        if all(pow(g, phi // p, q) != 1 for p in factors):
            return g
    raise ValueError(f"no primitive root for {q}")


def slim_fly(q: int, concentration: Optional[int] = None) -> Topology:
    """MMS Slim Fly over GF(q), prime q with q = 4w + delta, delta in {-1,0,1}.

    Routers: two classes of q^2 each — (0, x, y) and (1, m, c) with
    x, y, m, c in GF(q).  Edges:
      (0,x,y) ~ (0,x,y')  iff  y - y' in X   (quadratic-residue-like set)
      (1,m,c) ~ (1,m,c')  iff  c - c' in X'
      (0,x,y) ~ (1,m,c)   iff  y = m*x + c
    Network radix k' = (3q - delta) / 2.  Default p = ceil(k'/2).
    """
    if not _is_prime(q):
        raise ValueError(f"slim_fly requires prime q, got {q}")
    delta = 1 if q % 4 == 1 else -1  # prime q > 2 is odd: q = 4w ± 1
    xi = _primitive_root(q)
    # Generator sets, verified to yield (3q-delta)/2-regular diameter-2 MMS
    # graphs for all primes 5..43 (see tests/test_topology.py):
    #   q = 4w+1:  X  = even powers of xi (the quadratic residues),
    #   q = 4w-1:  X  = {+-xi^(2i) : 0 <= i < w}   (w symmetric pairs),
    #   both:      X' = xi * X.
    if delta == 1:
        X = sorted({pow(xi, 2 * i, q) for i in range((q - 1) // 2)})
    else:
        w = (q + 1) // 4
        base = {pow(xi, 2 * i, q) for i in range(w)}
        X = sorted(base | {(q - b) % q for b in base})
    Xp = sorted({(xi * b) % q for b in X})
    X = np.array(X, dtype=np.int64)
    Xp = np.array(Xp, dtype=np.int64)

    nr = 2 * q * q
    adj = np.zeros((nr, nr), dtype=np.bool_)

    rng_q = np.arange(q)
    # Intra-"column" edges: y - y' in X (class 0), c - c' in X' (class 1).
    diff = (rng_q[:, None] - rng_q[None, :]) % q
    in_X = np.isin(diff, X)
    in_Xp = np.isin(diff, Xp)
    for x in range(q):
        b0 = x * q
        adj[b0 : b0 + q, b0 : b0 + q] |= in_X
        b1 = q * q + x * q
        adj[b1 : b1 + q, b1 : b1 + q] |= in_Xp
    # Bipartite edges: (0, x, y) ~ (1, m, c) iff y = m*x + c (vectorised).
    xg, mg, cg = np.meshgrid(rng_q, rng_q, rng_q, indexing="ij")
    yg = (mg * xg + cg) % q
    rows = (xg * q + yg).ravel()
    cols = (q * q + mg * q + cg).ravel()
    adj[rows, cols] = True

    kprime = (3 * q - delta) // 2
    p = concentration if concentration is not None else (kprime + 1) // 2
    conc = np.full(nr, p, dtype=np.int64)
    return _finish(
        f"SF(q={q})", "sf", adj, conc, 2, {"q": q, "kprime": kprime, "p": p}
    )


# -----------------------------------------------------------------------------
# Dragonfly, "balanced": a = 2p = 2h, g = a*h + 1.
# -----------------------------------------------------------------------------
def dragonfly(p: int) -> Topology:
    """Balanced maximum-capacity Dragonfly parameterised by concentration p.

    a = 2p routers per group, h = p global links per router,
    g = a*h + 1 groups, one global link between every group pair.
    k' = (a - 1) + h = 3p - 1, diameter 3.
    """
    a, h = 2 * p, p
    g = a * h + 1
    nr = a * g
    adj = np.zeros((nr, nr), dtype=np.bool_)

    # Intra-group complete graphs.
    for gi in range(g):
        s = gi * a
        adj[s : s + a, s : s + a] = True
    # Global links: group gi's global port j (j in [0, a*h)) connects to group
    # ((gi + j + 1) mod g); the router is j // h, its h-slot is j % h.
    # The standard "consecutive" arrangement pairs port j of group gi with
    # the matching port of the peer group.
    for gi in range(g):
        for j in range(a * h):
            gj = (gi + j + 1) % g
            if gj == gi:
                continue
            # Peer group's port index pointing back to gi:
            jj = (gi - gj - 1) % g
            ri = gi * a + j // h
            rj = gj * a + jj // h
            adj[ri, rj] = True
            adj[rj, ri] = True

    conc = np.full(nr, p, dtype=np.int64)
    return _finish(
        f"DF(p={p})", "df", adj, conc, 3,
        {"p": p, "a": a, "h": h, "g": g, "kprime": 3 * p - 1},
    )


# -----------------------------------------------------------------------------
# Jellyfish: random regular graph.
# -----------------------------------------------------------------------------
def jellyfish(n_routers: int, kprime: int, concentration: int, seed: int = 0) -> Topology:
    """Random k'-regular graph (pairing model with retries)."""
    if n_routers * kprime % 2 != 0:
        raise ValueError("n_routers * kprime must be even")
    rng = np.random.default_rng(seed)
    for attempt in range(200):
        stubs = np.repeat(np.arange(n_routers), kprime)
        rng.shuffle(stubs)
        u, v = stubs[0::2], stubs[1::2]
        ok = u != v
        adj = np.zeros((n_routers, n_routers), dtype=np.bool_)
        # reject multi-edges by checking before set
        dup = adj[u[ok], v[ok]]
        if (~ok).sum() == 0:
            adj[u, v] = True
            adj[v, u] = True
            if (adj.sum(axis=1) == kprime).all() and not dup.any():
                # also require connectivity
                if _connected(adj):
                    conc = np.full(n_routers, concentration, dtype=np.int64)
                    return _finish(
                        f"JF(Nr={n_routers},k'={kprime})", "jf", adj, conc, 3,
                        {"kprime": kprime, "p": concentration, "seed": seed + attempt},
                    )
        seed += 1
        rng = np.random.default_rng(seed * 7919 + attempt)
    # Fall back to networkx's configuration-model-free generator.
    import networkx as nx

    g = nx.random_regular_graph(kprime, n_routers, seed=seed)
    adj = nx.to_numpy_array(g, dtype=bool)
    conc = np.full(n_routers, concentration, dtype=np.int64)
    return _finish(
        f"JF(Nr={n_routers},k'={kprime})", "jf", adj, conc, 3,
        {"kprime": kprime, "p": concentration, "seed": seed},
    )


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    frontier = np.zeros(n, dtype=bool)
    frontier[0] = True
    seen[0] = True
    while frontier.any():
        nxt = adj[frontier].any(axis=0) & ~seen
        seen |= nxt
        frontier = nxt
    return bool(seen.all())


# -----------------------------------------------------------------------------
# Xpander: single ℓ-lift of K_{k'+1}.
# -----------------------------------------------------------------------------
def xpander(kprime: int, lift: Optional[int] = None, concentration: Optional[int] = None,
            seed: int = 0) -> Topology:
    """ℓ-lift of the complete graph K_{k'+1} (paper A.4, ℓ = k' default).

    N_r = ℓ (k'+1); each base edge (s, t) of K_{k'+1} is replaced by a random
    perfect matching between the ℓ copies of s and the ℓ copies of t.
    """
    l = lift if lift is not None else kprime
    base_n = kprime + 1
    nr = l * base_n
    rng = np.random.default_rng(seed)
    adj = np.zeros((nr, nr), dtype=np.bool_)
    for s in range(base_n):
        for t in range(s + 1, base_n):
            pi = rng.permutation(l)
            si = s * l + np.arange(l)
            ti = t * l + pi
            adj[si, ti] = True
            adj[ti, si] = True
    p = concentration if concentration is not None else (kprime + 1) // 2
    conc = np.full(nr, p, dtype=np.int64)
    return _finish(
        f"XP(k'={kprime},l={l})", "xp", adj, conc, 3,
        {"kprime": kprime, "lift": l, "p": p, "seed": seed},
    )


# -----------------------------------------------------------------------------
# HyperX / Hamming graph: S^L vertices, clique along each dimension.
# -----------------------------------------------------------------------------
def hyperx(L: int, S: int, concentration: Optional[int] = None) -> Topology:
    """Regular HyperX (L, S, K=1). L=2 = Flattened Butterfly. k' = L(S-1)."""
    nr = S ** L
    idx = np.arange(nr)
    coords = np.stack([(idx // (S ** d)) % S for d in range(L)], axis=1)
    adj = np.zeros((nr, nr), dtype=np.bool_)
    # Vertices differing in exactly one coordinate are adjacent.
    diff = (coords[:, None, :] != coords[None, :, :]).sum(axis=2)
    adj = diff == 1
    kprime = L * (S - 1)
    p = concentration if concentration is not None else max(1, int(round(kprime / L)))
    conc = np.full(nr, p, dtype=np.int64)
    return _finish(
        f"HX(L={L},S={S})", "hx", adj, conc, L,
        {"L": L, "S": S, "kprime": kprime, "p": p},
    )


# -----------------------------------------------------------------------------
# Three-stage fat tree (Clos), D = 4 router hops between distant endpoints.
# -----------------------------------------------------------------------------
def fat_tree(k: int, oversubscription: int = 1) -> Topology:
    """Three-layer fat tree from radix-k routers (paper A.6).

    k pods; per pod k/2 edge + k/2 aggregation routers; (k/2)^2 core routers.
    Only edge routers host endpoints: p = (k/2) * oversubscription.
    ``oversubscription=2`` gives the paper's cost-matched 2x fat tree.
    """
    if k % 2 != 0:
        raise ValueError("fat_tree requires even k")
    half = k // 2
    n_edge = k * half
    n_agg = k * half
    n_core = half * half
    nr = n_edge + n_agg + n_core

    def edge_id(pod, i):
        return pod * half + i

    def agg_id(pod, i):
        return n_edge + pod * half + i

    def core_id(i, j):
        return n_edge + n_agg + i * half + j

    adj = np.zeros((nr, nr), dtype=np.bool_)
    for pod in range(k):
        for e in range(half):
            for a in range(half):
                adj[edge_id(pod, e), agg_id(pod, a)] = True
    # Aggregation router (pod, a) connects to core routers (a, j) for all j.
    for pod in range(k):
        for a in range(half):
            for j in range(half):
                adj[agg_id(pod, a), core_id(a, j)] = True
    adj |= adj.T

    conc = np.zeros(nr, dtype=np.int64)
    conc[:n_edge] = half * oversubscription
    return _finish(
        f"FT3(k={k}{',2x' if oversubscription == 2 else ''})", "ft", adj, conc, 4,
        {"k": k, "oversub": oversubscription, "p": half * oversubscription},
    )


def two_layer_fat_tree(leaves: int, spines: int,
                       concentration: int) -> Topology:
    """Two-layer (leaf-spine) fat tree, the arXiv:1301.6179 construction.

    Every leaf connects to every spine (one cable each); endpoints attach
    only to leaves.  Diameter 2, full bisection when ``spines >=
    concentration``.  Cables per endpoint is ``1 + spines/concentration``,
    which is what :func:`cost_matched_ft2` tunes to equalise link cost
    against a target low-diameter topology.  Spines are modelled as
    logical crossbars (a physical build would decompose a radix-``leaves``
    spine into a sub-tree; that is invisible at the routing level).
    """
    if leaves < 1 or spines < 1 or concentration < 1:
        raise ValueError("two_layer_fat_tree needs positive L, S, p")
    nr = leaves + spines
    adj = np.zeros((nr, nr), dtype=np.bool_)
    adj[:leaves, leaves:] = True
    adj |= adj.T
    conc = np.zeros(nr, dtype=np.int64)
    conc[:leaves] = concentration
    return _finish(
        f"FT2(L={leaves},S={spines},p={concentration})", "ft2", adj, conc, 2,
        {"leaves": leaves, "spines": spines, "p": concentration},
    )


def cost_matched_ft2(target: Topology) -> Topology:
    """The two-layer fat tree whose endpoint count and cables-per-endpoint
    (``edge_density``) match ``target``'s — the paper's cost-equalised
    baseline pairing (§2.2.3 methodology applied to the 1301.6179 FT2).

    Per-leaf concentration is set to the target's network radix, spines
    to ``round(p * (density - 1))`` (density = 1 + S/p for an FT2), and
    the leaf count to whatever reproduces the endpoint total.
    """
    p = max(1, target.network_radix)
    spines = max(1, int(round(p * (target.edge_density - 1.0))))
    leaves = max(2, int(round(target.n_endpoints / p)))
    ft2 = two_layer_fat_tree(leaves, spines, p)
    return dataclasses.replace(ft2, name=f"{target.name}-FT2")


# -----------------------------------------------------------------------------
# Corner cases: clique and star.
# -----------------------------------------------------------------------------
def clique(kprime: int, concentration: Optional[int] = None) -> Topology:
    nr = kprime + 1
    adj = ~np.eye(nr, dtype=np.bool_)
    p = concentration if concentration is not None else kprime
    conc = np.full(nr, p, dtype=np.int64)
    return _finish(f"K{nr}", "clique", adj, conc, 1, {"kprime": kprime, "p": p})


def star(n_endpoints: int) -> Topology:
    """Single crossbar with all endpoints attached (TCP validation baseline)."""
    adj = np.zeros((1, 1), dtype=np.bool_)
    conc = np.array([n_endpoints], dtype=np.int64)
    return _finish(f"Star({n_endpoints})", "star", adj, conc, 0,
                   {"p": n_endpoints})


# -----------------------------------------------------------------------------
# Equivalent Jellyfish + registry.
# -----------------------------------------------------------------------------
def equivalent_jellyfish(topo: Topology, seed: int = 0) -> Topology:
    """The X-JF with identical N_r, k', p (paper §2.2.3)."""
    kprime = int(round(topo.adj.sum() / topo.n_routers))
    p = int(round(topo.n_endpoints / topo.n_routers))
    if topo.n_routers * kprime % 2 != 0:
        kprime -= 1
    jf = jellyfish(topo.n_routers, kprime, p, seed=seed)
    return dataclasses.replace(jf, name=f"{topo.name}-JF")


TOPOLOGY_FAMILIES = {
    "sf": slim_fly,
    "df": dragonfly,
    "jf": jellyfish,
    "xp": xpander,
    "hx": hyperx,
    "ft": fat_tree,
    "ft2": two_layer_fat_tree,
    "clique": clique,
    "star": star,
}


def by_name(spec: str, **kw) -> Topology:
    """Build a topology from a compact spec like ``sf:19``, ``df:6``,
    ``hx:2x16``, ``ft:8``, ``ft2:861x42x43``, ``jf:128x12x6``, ``xp:16``."""
    fam, _, arg = spec.partition(":")
    if fam == "sf":
        return slim_fly(int(arg), **kw)
    if fam == "df":
        return dragonfly(int(arg), **kw)
    if fam == "hx":
        L, S = arg.split("x")
        return hyperx(int(L), int(S), **kw)
    if fam == "ft":
        return fat_tree(int(arg), **kw)
    if fam == "ft2":
        L, S, p = (int(x) for x in arg.split("x"))
        return two_layer_fat_tree(L, S, p, **kw)
    if fam == "jf":
        nr, kp, p = (int(x) for x in arg.split("x"))
        return jellyfish(nr, kp, p, **kw)
    if fam == "xp":
        return xpander(int(arg), **kw)
    if fam == "clique":
        return clique(int(arg), **kw)
    if fam == "star":
        return star(int(arg), **kw)
    raise ValueError(f"unknown topology spec {spec!r}")
