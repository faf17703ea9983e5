"""Traffic patterns (paper §2.4) and flow workloads.

A pattern is a mapping from source endpoint ids to destination endpoint
ids over ``N`` endpoints.  Endpoint e lives on router ``e // p`` (uniform
concentration) or per-router offsets for non-uniform concentration.

Workloads add flow sizes and Poisson arrival times (paper §2.3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .topology import Topology

__all__ = [
    "endpoint_router_map",
    "random_uniform",
    "random_permutation",
    "off_diagonal",
    "shuffle",
    "stencil2d",
    "all_to_one",
    "adversarial",
    "worst_case",
    "randomized_mapping",
    "FlowWorkload",
    "make_workload",
    "PATTERNS",
]


def endpoint_router_map(topo: Topology) -> np.ndarray:
    """(N,) router id of each endpoint."""
    return np.repeat(np.arange(topo.n_routers), topo.concentration)


# ---- §2.4 patterns: src endpoint id -> dst endpoint id ----------------------
def random_uniform(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, n, size=n)
    # avoid self-talk
    self_hit = t == np.arange(n)
    t[self_hit] = (t[self_hit] + 1) % n
    return t


def random_permutation(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    while True:
        t = rng.permutation(n)
        if not (t == np.arange(n)).any():
            return t
        # derangement retry is cheap; expected < e attempts


def off_diagonal(n: int, c: int = 1) -> np.ndarray:
    return (np.arange(n) + c) % n


def shuffle(n: int) -> np.ndarray:
    """Bit-rotation ("shuffle") pattern: t(s) = rotl_i(s), 2^i <= n < 2^(i+1)."""
    i = max(1, int(np.floor(np.log2(max(2, n)))))
    s = np.arange(n)
    rot = ((s << 1) | (s >> (i - 1))) & ((1 << i) - 1)
    return rot % n


def stencil2d(n: int, offsets: Tuple[int, ...] = (1, -1, 42, -42)) -> np.ndarray:
    """4-point stencil as four off-diagonals; returns (4, N) destinations
    (4x oversubscribed — each endpoint talks to four peers)."""
    return np.stack([(np.arange(n) + c) % n for c in offsets])


def all_to_one(n: int, seed: int = 0, acks: bool = False):
    """Many-to-one incast onto a seeded victim endpoint.

    ``acks=False`` (the PATTERNS-compatible default) returns the (n,)
    destination map: everyone sends to the victim (the victim itself
    sends to its neighbour so the map stays self-talk-free).

    ``acks=True`` returns ``(src, dst, is_ack)`` arrays: the data flows
    ``i -> victim`` for every ``i != victim`` PLUS the reverse ACK-path
    flows ``victim -> i`` — the TCP-outcast scenario, where the victim's
    ACK/response traffic shares the congested last hop in reverse and
    per-sender fairness collapses.  ``is_ack`` marks the reverse flows.
    """
    rng = np.random.default_rng(seed)
    tgt = int(rng.integers(n))
    if not acks:
        t = np.full(n, tgt)
        t[tgt] = (tgt + 1) % n
        return t
    senders = np.setdiff1d(np.arange(n), [tgt])
    src = np.concatenate([senders, np.full(len(senders), tgt)])
    dst = np.concatenate([np.full(len(senders), tgt), senders])
    is_ack = np.concatenate([np.zeros(len(senders), bool),
                             np.ones(len(senders), bool)])
    return src, dst, is_ack


def adversarial(n: int, seed: int = 0) -> np.ndarray:
    """Skewed off-diagonal with a large offset chosen to maximise colliding
    router pairs (§2.4.6): offset ~ N/2 + small prime jitter."""
    rng = np.random.default_rng(seed)
    c = n // 2 + int(rng.integers(1, 7)) * 13
    return (np.arange(n) + c) % n


def worst_case(topo: Topology, seed: int = 0,
               sample_cap: int = 4096, device="cuda") -> np.ndarray:
    """Jyothi et al. style worst-case: pair endpoints to maximise total
    path length via linear-sum assignment on router distances (§2.4.7).
    The router distances are computed on ``device``: the card unless the
    caller asks for the CPU, and without a card ``cuda`` raises."""
    from scipy.optimize import linear_sum_assignment

    from . import paths as paths_mod

    ep2r = endpoint_router_map(topo)
    n = len(ep2r)
    rng = np.random.default_rng(seed)
    if n > sample_cap:
        # Assignment on a subsample; remaining endpoints get the adversarial
        # off-diagonal (keeps O(n^3) Hungarian tractable).
        idx = rng.choice(n, size=sample_cap, replace=False)
    else:
        idx = np.arange(n)
    dist = paths_mod.shortest_path_lengths(topo.adj, device=device).cpu().numpy()
    d = dist[np.ix_(ep2r[idx], ep2r[idx])].astype(np.float64)
    np.fill_diagonal(d, -1e6)  # forbid self-pairing
    rows, cols = linear_sum_assignment(-d)  # maximise distance
    t = adversarial(n, seed)
    t[idx[rows]] = idx[cols]
    self_hit = t == np.arange(n)
    t[self_hit] = (t[self_hit] + 1) % n
    return t


def randomized_mapping(t: np.ndarray, seed: int = 0) -> np.ndarray:
    """Randomised workload mapping (§3.4): relabel endpoints u.a.r. so
    logical neighbours land on random routers."""
    rng = np.random.default_rng(seed)
    n = len(t)
    relabel = rng.permutation(n)
    out = np.empty(n, dtype=t.dtype)
    out[relabel] = relabel[t]
    return out


PATTERNS = {
    "uniform": random_uniform,
    "permutation": random_permutation,
    "offdiag": off_diagonal,
    "shuffle": shuffle,
    "alltoone": all_to_one,
    "adversarial": adversarial,
}


# ---- Flow workloads ----------------------------------------------------------
@dataclasses.dataclass
class FlowWorkload:
    """A set of flows over endpoints: arrays indexed by flow id.

    ``active_step``/``is_ack`` are the open-loop dynamic-traffic lanes:
    when ``active_step`` is set, flow ``i`` only participates in the
    transport scan from step ``active_step[i]`` on (arrivals built by
    :mod:`repro_torch.core.arrivals`); ``None`` keeps the closed-loop
    batch semantics (everyone active from step 0).  ``is_ack`` marks reverse
    ACK-path flows (see :func:`all_to_one` with ``acks=True``) so
    evaluators can separate data goodput from ACK traffic.
    """

    src: np.ndarray         # (F,) endpoint ids
    dst: np.ndarray         # (F,) endpoint ids
    size: np.ndarray        # (F,) bytes
    start: np.ndarray       # (F,) seconds
    src_router: np.ndarray  # (F,)
    dst_router: np.ndarray  # (F,)
    active_step: Optional[np.ndarray] = None  # (F,) int32 activation steps
    is_ack: Optional[np.ndarray] = None       # (F,) bool reverse-ACK marker

    @property
    def n_flows(self) -> int:
        return len(self.src)


def make_workload(topo: Topology, pattern: str = "permutation",
                  flow_size: float = 1 << 20, n_rounds: int = 1,
                  arrival_rate: float = 0.0, randomize: bool = True,
                  seed: int = 0, frac_endpoints: float = 1.0,
                  size_spread: float = 0.0, acks: bool = False,
                  ack_frac: float = 0.05, device="cuda") -> FlowWorkload:
    """Build a flow workload from a named pattern.

    Args:
      pattern: key of PATTERNS, or ``stencil`` / ``worstcase``.
      flow_size: mean flow size in bytes (a flow == a message, §7.1.4).
      n_rounds: independent pattern instances (e.g. 4 permutations in
        parallel => 4x oversubscription as in Fig 4).
      arrival_rate: flows per endpoint per second for Poisson starts
        (0 => all flows start at t=0).
      randomize: apply §3.4 randomised endpoint mapping.
      frac_endpoints: fraction of communicating endpoints (§7.1.10).
      size_spread: lognormal sigma for flow sizes (0 => fixed size).
      acks: ``alltoone`` only — also emit the victim's reverse ACK-path
        flows (TCP-outcast scenario); marked in ``is_ack`` and sized at
        ``ack_frac * flow_size``.
      ack_frac: ACK flow size as a fraction of ``flow_size``.
      device: where ``worstcase`` computes its router distances: the
        card unless the caller asks for the CPU (``cuda`` without a card
        raises).  The other patterns are built with numpy and never
        read it.
    """
    rng = np.random.default_rng(seed)
    ep2r = endpoint_router_map(topo)
    n = len(ep2r)
    srcs, dsts, ack_rows = [], [], []
    for r in range(n_rounds):
        if pattern == "stencil":
            st = stencil2d(n, offsets=(1, -1, 42 if n <= 10_000 else 1337,
                                       -(42 if n <= 10_000 else 1337)))
            for row in st:
                srcs.append(np.arange(n))
                dsts.append(row)
                ack_rows.append(np.zeros(n, dtype=bool))
            continue
        if pattern == "alltoone" and acks:
            s, d, a = all_to_one(n, seed=seed + r, acks=True)
            if randomize:
                relabel = np.random.default_rng(seed + 101 + r).permutation(n)
                s, d = relabel[s], relabel[d]
            srcs.append(s)
            dsts.append(d)
            ack_rows.append(a)
            continue
        if pattern == "worstcase":
            t = worst_case(topo, seed=seed + r, device=device)
        else:
            fn = PATTERNS[pattern]
            if pattern in ("uniform", "permutation", "alltoone", "adversarial"):
                t = fn(n, seed=seed + r)
            elif pattern == "offdiag":
                t = fn(n, c=1 + r)
            else:
                t = fn(n)
        if randomize:
            t = randomized_mapping(t, seed=seed + 101 + r)
        srcs.append(np.arange(n))
        dsts.append(t)
        ack_rows.append(np.zeros(n, dtype=bool))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    is_ack = np.concatenate(ack_rows)
    keep = src != dst
    src, dst, is_ack = src[keep], dst[keep], is_ack[keep]
    if frac_endpoints < 1.0:
        mask = rng.random(len(src)) < frac_endpoints
        src, dst, is_ack = src[mask], dst[mask], is_ack[mask]
    f = len(src)
    if size_spread > 0:
        size = flow_size * rng.lognormal(0.0, size_spread, size=f)
    else:
        size = np.full(f, float(flow_size))
    if is_ack.any():
        size = np.where(is_ack, size * float(ack_frac), size)
    if arrival_rate > 0:
        start = rng.exponential(1.0 / arrival_rate, size=f).cumsum()
        start = start * (f / max(start[-1], 1e-9)) / arrival_rate / f  # window
        start = rng.uniform(0, f / (arrival_rate * n), size=f)
    else:
        start = np.zeros(f)
    return FlowWorkload(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        size=size.astype(np.float64), start=start.astype(np.float64),
        src_router=ep2r[src].astype(np.int32),
        dst_router=ep2r[dst].astype(np.int32),
        is_ack=is_ack if is_ack.any() else None,
    )
