"""Flow-level transport + load-balancing simulator (paper §7, htsim analogue).

A discrete-time simulator: all flows advance together in Δt steps, and
link sharing is an iterative max-min water-filling that never
oversubscribes a link (:func:`repro_torch.kernels.waterfill
.waterfill_step`, the CUDA kernel on the card).

Modelled per paper §3 / §7.1.3:

* **Transport** — ``ndp`` (receiver-driven fair share at line-rate
  start), ``tcp`` (slow start, AIMD), ``dctcp`` (gentle decrease).
* **Load balancing** — ``ecmp`` (one of ``n_ecmp`` minimal tables,
  pinned), ``letflow`` (flowlet re-routing among minimal tables),
  ``fatpaths`` (flowlet re-routing across FatPaths layers).
* **Flowlet elasticity** — ``p_gap = dt/gap * (1 - rate/line + eps)``.

Endpoint NICs are virtual links (injection + ejection), so incast and
concentration effects are captured.

The step body runs the same float32 operations in the same order as the
JAX package's scan, and its random draws come from the same threefry
stream (:mod:`repro_torch.prng`): per-flow keys ``fold_in(key, flow)``,
and per chunk one ``uniform(fold_in(flow_key, chunk), (chunk, 2))``
block, sliced for the tail chunk.  Python float constants are rounded to
float32 before they meet a tensor, as JAX rounds its weak-typed scalars.
``sent_acc + sent`` is rounded once, as XLA contracts the reference's
``sent_acc + d * s`` into a fused multiply-add (the water-filling step
returns it).

The scan is a Python loop over steps.  Its only host syncs are the path
trim and the link plan in :func:`prepare` and one ``exhausted()`` check
per chunk of the adaptive horizon, which stops once every flow is
finished or provably stuck; skipped steps are exact no-ops, so early exit
returns what the full horizon would.

Dynamic traffic: ``arrs["active_at"]`` is a per-flow activation step
(from :attr:`FlowWorkload.active_step`, built by
:mod:`repro_torch.core.arrivals`; zeros for a static workload).  A flow
takes part once ``step >= active_at`` and ``start <= t``, so a workload
whose activations are all zero gives the static result bitwise.  The
adaptive horizon needs nothing more: a flow not yet active keeps
``remaining > 0``.

Mid-run link death, link churn, loss recovery and per-step recording
raise ``NotImplementedError`` until ported (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import prng, resolve_device
from ..kernels.waterfill import LinkPlan, link_plan, waterfill_step
from . import paths as paths_mod
from .layers import LayeredRouting
from .topology import Topology
from .traffic import FlowWorkload

__all__ = ["SimConfig", "SimResult", "simulate", "simulate_seeds",
           "ecmp_routing", "prepare", "shape_signature"]


def _f32(x: float) -> float:
    """``x`` rounded to float32 (a Python float that float32 holds exactly)."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    transport: str = "ndp"          # ndp | tcp | dctcp
    balancing: str = "fatpaths"     # ecmp | letflow | fatpaths
    dt: float = 10e-6               # seconds per step
    n_steps: int = 2000
    line_rate: float = 12.5e9       # bytes/s (100 GbE)
    link_latency: float = 1e-6      # per hop (INET-matched fixed delay)
    sw_latency: float = 10e-6       # endpoint software stack latency
    flowlet_gap: float = 50e-6      # LetFlow-style gap timescale
    gap_eps: float = 0.05           # baseline re-roll probability factor
    max_hops: int = 12
    fair_iters: int = 2             # water-filling refinement iterations
    tcp_init: float = 0.05          # initial rate fraction (slow start)
    tcp_ai: float = 0.02            # additive increase per step (frac of line)
    tcp_md: float = 0.5             # multiplicative decrease (tcp)
    dctcp_md: float = 0.85          # gentle decrease (dctcp)
    horizon_chunk: int = 64         # scan chunk size (also the PRNG block)
    adaptive_horizon: bool = True   # stop once all flows are done/stuck
    # Kept so the fields match the JAX package's; kernels are chosen by
    # the tensors' device, so only "" is accepted.
    kernel_backend: str = ""
    # Loss-recovery lanes: only recovery="off", record=0 is ported.
    recovery: str = "off"           # off | on
    rto_base: int = 16
    rto_cap: int = 256
    ecn_thresh: float = 0.65
    record: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.kernel_backend != "":
            raise ValueError(
                f"kernel_backend={self.kernel_backend!r}: the port picks "
                "kernels by the tensors' device; leave it ''")


@dataclasses.dataclass
class SimResult:
    fct: np.ndarray            # (F,) seconds; NaN if unfinished
    delivered: np.ndarray      # (F,) bytes delivered
    size: np.ndarray           # (F,) flow sizes
    finished: np.ndarray       # (F,) bool
    link_util_mean: float
    config: SimConfig
    # (F,) step index at which each flow completed; -1 = still in flight.
    depart_step: Optional[np.ndarray] = None
    # Recovery lanes of the JAX package (always None here until ported).
    retrans_bytes: Optional[np.ndarray] = None
    goodput_steps: Optional[np.ndarray] = None
    stalled_steps: Optional[np.ndarray] = None

    @property
    def throughput_per_flow(self) -> np.ndarray:
        return np.where(self.finished, self.size / np.maximum(self.fct, 1e-12),
                        np.nan)

    def fct_stats(self) -> Dict[str, float]:
        ok = self.finished
        f = self.fct[ok]
        if len(f) == 0:
            return {"mean": float("nan"), "p50": float("nan"),
                    "p99": float("nan"), "finished": 0.0}
        return {
            "mean": float(f.mean()),
            "p50": float(np.quantile(f, 0.50)),
            "p99": float(np.quantile(f, 0.99)),
            "finished": float(ok.mean()),
        }


def ecmp_routing(topo: Topology, n_tables: int = 8, seed: int = 0,
                 max_len: Optional[int] = None,
                 device="cuda") -> LayeredRouting:
    """Minimal-path-only multi-table routing: n differently tie-broken
    shortest-path tables (flow-hash ECMP / LetFlow substrate).  APSP runs
    once; the n tables come out of one batched forwarding pass."""
    dev = resolve_device(device)
    adj_np = np.asarray(topo.adj, dtype=bool)
    n = adj_np.shape[0]
    if max_len is None:
        max_len = max(6, topo.diameter_nominal + 2)
    t0 = time.perf_counter()
    paths_mod.path_engine()
    nbr = torch.as_tensor(paths_mod.neighbor_table(adj_np), device=dev)
    adj = torch.as_tensor(adj_np, device=dev)
    stack = adj[None].expand((n_tables, n, n))
    t_dev = time.perf_counter()
    dist = paths_mod._apsp_core(adj[None], max_len)[0]
    nh = paths_mod._forwarding_core(stack, dist[None].expand(stack.shape), nbr,
                                    prng.PRNGKey(seed, dev))
    paths_mod._sync(dev)
    t1 = time.perf_counter()
    reach = dist <= max_len
    nh[:, ~reach] = -1
    idx = torch.arange(n, device=dev)
    nh[:, idx, idx] = idx.to(torch.int32)
    plen = torch.where(reach, dist, 10_000).to(torch.int16)
    t2 = time.perf_counter()
    return LayeredRouting(
        topo=topo, scheme="ecmp", rho=1.0,
        nh=nh, reach=reach[None].expand(stack.shape).clone(),
        pathlen=plen[None].expand(stack.shape).clone(),
        layer_adj=stack.clone(),
        build_stats={"total_s": t2 - t0, "device_s": t1 - t_dev,
                     "host_s": (t_dev - t0) + (t2 - t1)},
    )


def _path_edge_tensor(nh: torch.Tensor, eix: torch.Tensor, src_r: torch.Tensor,
                      dst_r: torch.Tensor, max_hops: int):
    """Walk every layer's table once, ahead of the scan: (L, F, max_hops)
    int32 directed fabric edge ids along each flow's path in each layer
    (-1 once the destination router is reached or the table has a hole)
    plus an (L, F) routed-ok mask."""
    n_layers = nh.shape[0]
    lidx = torch.arange(n_layers, device=nh.device)[:, None]
    cur = src_r[None].expand(n_layers, -1)
    dst = dst_r[None]
    es = []
    for _ in range(max_hops):
        nxt = nh[lidx, cur, dst].long()
        at_dst = cur == dst
        hole = nxt < 0
        stop = at_dst | hole
        e = torch.where(stop, -1, eix[cur, torch.where(hole, cur, nxt)])
        cur = torch.where(stop, cur, nxt)
        es.append(e)
    if es:
        edges = torch.stack(es, dim=2).to(torch.int32)
    else:
        edges = torch.empty(cur.shape + (0,), dtype=torch.int32,
                            device=nh.device)
    return edges, cur == dst


def _virtual_links(topo: Topology, wl: FlowWorkload):
    """(edge-index matrix, fabric edge count, endpoint count) — the
    virtual-link layout shared by :func:`prepare` and
    :func:`shape_signature`."""
    eix = topo.edge_index_matrix()              # (N, N) -> directed edge id
    n_edges = int((eix >= 0).sum())
    # Empty workloads get one (unused) endpoint slot.
    if len(wl.src):
        n_ep = int(max(wl.src.max(), wl.dst.max()) + 1)
    else:
        n_ep = 1
    return eix, n_edges, n_ep


def shape_signature(topo: Topology, routing: LayeredRouting,
                    wl: FlowWorkload) -> Tuple[int, int, int]:
    """(n_flows, e_tot, n_layers) for a cell without building the scan
    operands."""
    _, n_edges, n_ep = _virtual_links(topo, wl)
    return (len(wl.src), n_edges + 2 * n_ep + 1, int(routing.nh.shape[0]))


def _check_lanes_ported(routing: LayeredRouting) -> None:
    for lane in ("link_down_step", "link_churn"):
        if getattr(routing, lane, None) is not None:
            raise NotImplementedError(f"the {lane} lane is not ported yet "
                                      "(ROADMAP A8)")
    if getattr(routing, "compressed", None) is not None:
        raise NotImplementedError("compressed tables are not ported yet "
                                  "(ROADMAP A9)")


def prepare(topo: Topology, routing: LayeredRouting, wl: FlowWorkload,
            cfg: SimConfig, device="cuda"):
    """``(arrs, static)``: the scan's tensors on ``device`` — including
    the per-layer path-edge tensor, so the step body never re-derives
    flow paths, and its :func:`~repro_torch.kernels.waterfill.link_plan`
    — and the static triple ``(e_tot, n_layers, n_steps)``."""
    _check_lanes_ported(routing)
    dev = resolve_device(device)
    eix, n_edges, n_ep = _virtual_links(topo, wl)
    # virtual links: [0, E) fabric, [E, E+n_ep) injection, [E+n_ep, ..) eject,
    # final slot = trash for -1 scatter.
    e_inj = n_edges
    e_ej = n_edges + n_ep
    e_tot = n_edges + 2 * n_ep + 1
    src_r = torch.as_tensor(wl.src_router, device=dev).long()
    dst_r = torch.as_tensor(wl.dst_router, device=dev).long()
    edges, routed = _path_edge_tensor(
        routing.nh.to(dev), torch.as_tensor(eix, device=dev), src_r, dst_r,
        cfg.max_hops)
    # Trim the hop axis to the longest realised path (one host sync).
    n_hops = (edges >= 0).sum(dim=2)
    hmax = max(1, int(n_hops.max())) if edges.numel() else 1
    edges = edges[:, :, :hmax]
    n_flows = len(wl.src)
    n_layers = routing.nh.shape[0]
    src_e = torch.as_tensor(wl.src + e_inj, device=dev).to(torch.int32)
    dst_e = torch.as_tensor(wl.dst + e_ej, device=dev).to(torch.int32)
    # (L, F, H+2): fabric hops + injection + ejection NIC per layer.
    path_edges = torch.cat(
        [edges,
         src_e[None, :, None].expand(n_layers, n_flows, 1),
         dst_e[None, :, None].expand(n_layers, n_flows, 1)], dim=2)
    usable = routing.reach.to(dev)[:, src_r, dst_r].T          # (F, L)
    # Step before which a flow does not exist; zeros for a static workload.
    if wl.active_step is None:
        active_at = torch.zeros(n_flows, dtype=torch.int32, device=dev)
    else:
        active_at = torch.as_tensor(np.asarray(wl.active_step, np.int32),
                                    device=dev)
    # Each link's path entries in (flow, slot) order, for the card's
    # water-filling kernel: built once per cell, never in a step.
    plan_offsets, plan_entries, _ = link_plan(path_edges, e_tot)
    arrs = dict(
        path_edges=path_edges,                                   # (L, F, H+2)
        plan_offsets=plan_offsets,                               # (E+1,)
        plan_entries=plan_entries,
        routed=routed,                                           # (L, F)
        path_hops=n_hops.to(torch.float32),                      # (L, F)
        usable=usable,
        size=torch.as_tensor(wl.size, device=dev).to(torch.float32),
        start=torch.as_tensor(wl.start, device=dev).to(torch.float32),
        active_at=active_at,                                     # (F,)
    )
    return arrs, (e_tot, int(n_layers), int(cfg.n_steps))


def _flow_uniforms(key: torch.Tensor, f: int) -> torch.Tensor:
    """(F, 2) U[0,1) draws where row ``i`` depends only on ``(key, i)``."""
    keys = prng.fold_in(key, torch.arange(f, device=key.device))
    return prng.uniform(keys, (2,))


def _chunk_uniforms(flow_keys: torch.Tensor, c: int, chunk: int) -> torch.Tensor:
    """(chunk, F, 2) U[0,1) draws for one scan chunk: draw ``[s, i]``
    depends only on ``(flow_keys[i], c, s)``; the full block is drawn
    even for a tail chunk."""
    cks = prng.fold_in(flow_keys, c)
    return prng.uniform(cks, (chunk, 2)).movedim(0, 1)


def _pick_layers(u: torch.Tensor, usable: torch.Tensor) -> torch.Tensor:
    """Uniform choice among usable layers per flow, driven by one
    per-flow uniform ``u`` (layer 0 fallback): pick the r-th usable
    layer with r ~ U{0..n_usable-1}."""
    c = torch.cumsum(usable.to(torch.int32), dim=1, dtype=torch.int32)
    n = c[:, -1]
    r = torch.minimum((u * n).to(torch.int32), torch.clamp_min(n - 1, 0))
    pick = (c > r[:, None]).to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where(n > 0, pick, 0)


def _check_lanes(cfg: SimConfig) -> None:
    if str(cfg.recovery).lower() in ("on", "1", "true"):
        raise NotImplementedError("recovery='on' is not ported yet "
                                  "(ROADMAP A8)")
    if int(cfg.record):
        raise NotImplementedError("record=1 is not ported yet (ROADMAP A8)")
    if cfg.transport not in ("ndp", "tcp", "dctcp"):
        raise ValueError(f"unknown transport {cfg.transport!r}")
    if cfg.balancing not in ("ecmp", "letflow", "fatpaths"):
        raise ValueError(f"unknown balancing {cfg.balancing!r}")


def _run_scan(arrs: Dict[str, torch.Tensor], key0: torch.Tensor,
              cfg: SimConfig, static: Tuple[int, int, int]
              ) -> Dict[str, torch.Tensor]:
    """The chunked flow scan: returns the final per-flow state plus
    ``horizon_chunks`` (how many full chunks ran)."""
    _check_lanes(cfg)
    e_tot, n_layers, n_steps = static
    dev = arrs["size"].device
    f = arrs["size"].shape[0]
    line_bytes = _f32(cfg.line_rate * cfg.dt)          # bytes per step at line
    dt = np.float32(cfg.dt)
    gap_rate = _f32(cfg.dt / cfg.flowlet_gap)
    gap_eps = _f32(cfg.gap_eps)
    tcp_init, tcp_ai = _f32(cfg.tcp_init), _f32(cfg.tcp_ai)
    md = _f32(cfg.tcp_md if cfg.transport == "tcp" else cfg.dctcp_md)
    thresh = _f32(0.98)

    reroute = cfg.balancing in ("letflow", "fatpaths")
    chunk = max(1, int(cfg.horizon_chunk))
    n_full, rem = divmod(n_steps, chunk)
    usable = arrs["usable"]
    routed_lf = arrs["routed"]

    k_init, k_scan = prng.split(key0.to(dev))
    layer0 = _pick_layers(_flow_uniforms(k_init, f)[:, 0], usable)
    flow_keys = prng.fold_in(k_scan, torch.arange(f, device=dev))

    if cfg.transport == "ndp":
        rate0 = torch.ones(f, dtype=torch.float32, device=dev)
    else:
        rate0 = torch.full((f,), tcp_init, dtype=torch.float32, device=dev)
    zeros = torch.zeros(f, dtype=torch.float32, device=dev)
    state = dict(remaining=arrs["size"].clone(), layer=layer0, rate=rate0,
                 hops=zeros, sent_acc=zeros, w_acc=zeros,
                 depart_step=torch.full((f,), -1, dtype=torch.int32,
                                        device=dev))

    cap = torch.ones(e_tot, dtype=torch.float32, device=dev)
    plan = LinkPlan(arrs["plan_offsets"], arrs["plan_entries"], f)
    frows = torch.arange(f, device=dev)
    # One packed (L, F, H+4) record — path edges | routed | hop count —
    # so the step gathers by current layer once.
    n_slots = arrs["path_edges"].shape[2]
    packed = torch.cat(
        [arrs["path_edges"].to(torch.int32),
         routed_lf.to(torch.int32)[..., None],
         arrs["path_hops"].to(torch.int32)[..., None]], dim=2)

    # Provably-stuck support for the adaptive horizon: a flow whose
    # current layer cannot route it and that can never re-roll onto a
    # routing layer has weight 0 on every future step.
    if reroute:
        first = (torch.arange(n_layers, device=dev) == 0)[None, :]
        pickable = torch.where(usable.any(dim=1, keepdim=True), usable,
                               first)
        pick_routable = (pickable & routed_lf.T).any(dim=1)
    else:
        pick_routable = torch.zeros(f, dtype=torch.bool, device=dev)

    def step(st, i: int, u: Optional[torch.Tensor]):
        t = float(np.float32(i) * dt)
        started = (arrs["start"] <= t) & (i >= arrs["active_at"])
        done = st["remaining"] <= 0
        active = started & ~done
        g = packed[st["layer"], frows]                          # (F, H+4)
        edges = g[:, :n_slots]
        send = active & (g[:, n_slots] > 0)
        n_hops = g[:, n_slots + 1].to(torch.float32)

        w = send.to(torch.float32)
        desired = torch.clamp_max(st["rate"], 1.0) * w
        sent, share, sent_acc = waterfill_step(
            edges, w, desired, cap, active=send, fair_iters=cfg.fair_iters,
            acc=st["sent_acc"], plan=plan, layer=st["layer"])

        delivered = sent * line_bytes
        new_remaining = torch.clamp_min(st["remaining"] - delivered * w, 0.0)
        newly_done = (new_remaining <= 0) & ~done & started
        hops = torch.where(newly_done, n_hops, st["hops"])
        depart = torch.where(newly_done, i, st["depart_step"])

        if cfg.transport == "ndp":
            rate = torch.ones(f, dtype=torch.float32, device=dev)
        else:
            congested = share < st["rate"] * thresh
            up = torch.where(st["rate"] < 0.5, st["rate"] * 2.0,
                             st["rate"] + tcp_ai)
            rate = torch.where(congested,
                               torch.clamp_min(share * md, tcp_init),
                               torch.clamp_max(up, 1.0))

        if reroute:
            slack = 1.0 - torch.clamp(sent, 0.0, 1.0)
            p_gap = torch.clamp(gap_rate * (slack + gap_eps), 0.0, 1.0)
            roll = u[:, 0] < p_gap
            newpick = _pick_layers(u[:, 1], usable)
            layer = torch.where(roll & active, newpick, st["layer"])
        else:
            layer = st["layer"]
        return dict(remaining=new_remaining, layer=layer, rate=rate,
                    hops=hops, depart_step=depart, w_acc=st["w_acc"] + w,
                    sent_acc=sent_acc)

    def run_chunk(st, c: int, length: int):
        u = _chunk_uniforms(flow_keys, c, chunk)[:length] if reroute else None
        for s in range(length):
            st = step(st, c * chunk + s, u[s] if reroute else None)
        return st

    def exhausted(st) -> bool:
        routed_cur = routed_lf[st["layer"], frows]
        stuck = ~routed_cur & ~pick_routable
        return bool(((st["remaining"] <= 0.0) | stuck).all())

    c_run = 0
    while c_run < n_full and not (cfg.adaptive_horizon and exhausted(state)):
        state = run_chunk(state, c_run, chunk)
        c_run += 1
    if rem:
        # The tail rides chunk index n_full unconditionally.
        state = run_chunk(state, n_full, rem)
    return dict(state, horizon_chunks=c_run)


def _to_result(size: np.ndarray, final, cfg: SimConfig,
               start: Optional[np.ndarray] = None) -> SimResult:
    final = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
             for k, v in final.items()}
    remaining = np.asarray(final["remaining"])
    # Host float64 over the per-flow accumulators.
    sent = float(np.asarray(final["sent_acc"], dtype=np.float64).sum())
    want = float(np.asarray(final["w_acc"], dtype=np.float64).sum())
    # FCT from the integer depart lane, on host with a fixed numpy op
    # order: completion time minus start, plus propagation and software
    # latency over the path taken at completion.
    dep = np.asarray(final["depart_step"])
    hops = np.asarray(final["hops"])
    f32 = np.float32
    start32 = (np.zeros(dep.shape, np.float32) if start is None
               else np.asarray(start, np.float32))
    fct = ((dep.astype(np.float32) + f32(1.0)) * f32(cfg.dt) - start32
           + hops * f32(cfg.link_latency) + f32(cfg.sw_latency))
    fct = np.where(dep >= 0, fct, np.float32(np.nan))
    return SimResult(
        fct=fct,
        delivered=size - remaining,
        size=size,
        finished=remaining <= 0,
        link_util_mean=sent / max(want, 1.0),
        config=cfg,
        depart_step=dep,
    )


def simulate(topo: Topology, routing: LayeredRouting, wl: FlowWorkload,
             cfg: SimConfig, device="cuda") -> SimResult:
    """Run the flow simulator; returns per-flow FCTs and aggregates."""
    return simulate_seeds(topo, routing, wl, cfg, [cfg.seed], device)[0]


def simulate_seeds(topo: Topology, routing: LayeredRouting, wl: FlowWorkload,
                   cfg: SimConfig, seeds, device="cuda") -> list:
    """Seed sweep over one prepared cell: the same topology, routing and
    workload, one PRNG stream per seed (each seed is independent, so the
    scans run one after another).  One :class:`SimResult` per seed,
    identical to :func:`simulate` with ``cfg.seed`` set to each value."""
    seeds = [int(s) for s in seeds]
    if not seeds:
        return []
    arrs, static = prepare(topo, routing, wl, cfg, device)
    size = arrs["size"].cpu().numpy()
    start = arrs["start"].cpu().numpy()
    dev = arrs["size"].device
    out = []
    for s in seeds:
        final = _run_scan(arrs, prng.PRNGKey(s, dev), cfg, static)
        out.append(_to_result(size, final, dataclasses.replace(cfg, seed=s),
                              start=start))
    return out
