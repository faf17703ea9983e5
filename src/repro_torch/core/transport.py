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

Faults and loss recovery, each a lane that is absent, and adds no op to
the step, unless the cell asks for it:

* ``arrs["link_down_step"]`` (mid-run link death, from
  :attr:`LayeredRouting.link_down_step`): a link's capacity drops to 0
  at its step, so flows on it stall and re-pick at a flowlet boundary;
* ``arrs["link_churn"]`` and ``arrs["churn_pick_at"]`` (link churn): zero
  capacity inside each ``(down, up)`` outage, and a layer crossing a link
  inside ``(down, up + conv)`` is not re-picked;
* ``recovery="on"``: a stall timer, a retransmission timeout with
  exponential backoff and a deterministic blackhole escape onto the next
  surviving layer, the rollback of the bytes in flight when a path's
  link dies (ndp pays one trimmed RTT, tcp a full RTO and slow start,
  dctcp a quarter RTO and a gentle decrease), and for dctcp the ECN rate
  rule on the water-filling step's ``util``;
* ``record=1``: per-step goodput and stalled-flow counts written into
  ``(n_steps,)`` device buffers by step index.

The lanes' float expressions are rounded as XLA rounds the reference's
compiled scan: ``remaining + lost * line_bytes`` and the ECN decrease
``1 - (1 - md) * frac`` are fused multiply-adds, the division by ``dt``
(and by the ECN band) a product with the f32 reciprocal, and the goodput
sum runs in XLA:CPU's order (:func:`repro_torch.core.layers.xla_sum`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import prng, resolve_device
from ..kernels.ref import fused_add_mul
from ..kernels.waterfill import LinkPlan, link_plan, waterfill_step
from . import paths as paths_mod
from .layers import LayeredRouting, xla_sum
from .topology import Topology
from .traffic import FlowWorkload

__all__ = ["SimConfig", "SimResult", "simulate", "simulate_seeds",
           "ecmp_routing", "prepare", "shape_signature", "pad_prepared",
           "union_prepared", "split_union", "batch_result"]

_IMAX = np.iinfo(np.int32).max


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
    # Loss-recovery lanes (off: none of their ops runs).
    recovery: str = "off"           # off | on
    rto_base: int = 16              # initial retransmission timeout (steps)
    rto_cap: int = 256              # exponential-backoff ceiling (steps)
    ecn_thresh: float = 0.65        # link claim-utilization ECN mark point
    # record=1 keeps per-step goodput and stalled-flow counts.
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
    # Recovery lanes (None unless cfg.recovery / cfg.record): per-flow
    # retransmitted bytes, per-step goodput (line units) and stalled flows.
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
    once; the n tables come out of one batched forwarding pass, through
    the engine ``REPRO_PATH_ENGINE`` resolves at this size, which also
    decides whether compressed tables are attached."""
    dev = resolve_device(device)
    adj_np = np.asarray(topo.adj, dtype=bool)
    n = adj_np.shape[0]
    if max_len is None:
        max_len = max(6, topo.diameter_nominal + 2)
    t0 = time.perf_counter()
    engine = paths_mod.path_engine(n)
    nbr = torch.as_tensor(paths_mod.neighbor_table(adj_np), device=dev)
    adj = torch.as_tensor(adj_np, device=dev)
    stack = adj[None].expand((n_tables, n, n))
    t_dev = time.perf_counter()
    # The topology is symmetric, so its neighbor table is its in-neighbor
    # table too.
    if engine == "blocked":
        dist = paths_mod._apsp_blocked_core(adj[None], nbr, max_len)[0]
        forwarding = paths_mod._forwarding_blocked_core
    else:
        dist = paths_mod._apsp_core(adj[None], max_len)[0]
        forwarding = paths_mod._forwarding_core
    nh = forwarding(stack, dist[None].expand(stack.shape), nbr,
                    prng.PRNGKey(seed, dev))
    paths_mod._sync(dev)
    t1 = time.perf_counter()
    reach = dist <= max_len
    nh[:, ~reach] = -1
    idx = torch.arange(n, device=dev)
    nh[:, idx, idx] = idx.to(torch.int32)
    plen = torch.where(reach, dist, 10_000).to(torch.int16)
    compressed = None
    if paths_mod.representation_for(n) == "compressed":
        compressed = paths_mod.CompressedTables.from_dense(nh)
    paths_mod._sync(dev)
    t2 = time.perf_counter()
    return LayeredRouting(
        topo=topo, scheme="ecmp", rho=1.0,
        nh=nh, reach=reach[None].expand(stack.shape).clone(),
        pathlen=plen[None].expand(stack.shape).clone(),
        layer_adj=stack.clone(),
        build_stats={"total_s": t2 - t0, "device_s": t1 - t_dev,
                     "host_s": (t_dev - t0) + (t2 - t1)},
        compressed=compressed,
    )


def _path_edge_tensor(tables: Union[torch.Tensor,
                                    paths_mod.CompressedTables],
                      eix: torch.Tensor, src_r: torch.Tensor,
                      dst_r: torch.Tensor, max_hops: int):
    """Walk every layer's table once, ahead of the scan: (L, F, max_hops)
    int32 directed fabric edge ids along each flow's path in each layer
    (-1 once the destination router is reached or the table has a hole)
    plus an (L, F) routed-ok mask.  ``tables`` is the dense (L, N, N)
    stack or :class:`~repro_torch.core.paths.CompressedTables`, whose
    exact lookups give the same edges without a dense table row."""
    if isinstance(tables, paths_mod.CompressedTables):
        n_layers, lookup = tables.sel.shape[0], tables.lookup
    else:
        n_layers = tables.shape[0]

        def lookup(li, cur, dst):
            return tables[li, cur, dst]
    lidx = torch.arange(n_layers, device=eix.device)[:, None]
    cur = src_r[None].expand(n_layers, -1)
    dst = dst_r[None]
    es = []
    for _ in range(max_hops):
        nxt = lookup(lidx, cur, dst).long()
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
                            device=eix.device)
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


def prepare(topo: Topology, routing: LayeredRouting, wl: FlowWorkload,
            cfg: SimConfig, device="cuda"):
    """``(arrs, static)``: the scan's tensors on ``device`` — including
    the per-layer path-edge tensor, so the step body never re-derives
    flow paths, and its :func:`~repro_torch.kernels.waterfill.link_plan`
    — and the static triple ``(e_tot, n_layers, n_steps)``.  The paths
    are walked off the routing's compressed tables when it carries them
    (the same edges, bitwise)."""
    dev = resolve_device(device)
    eix, n_edges, n_ep = _virtual_links(topo, wl)
    # virtual links: [0, E) fabric, [E, E+n_ep) injection, [E+n_ep, ..) eject,
    # final slot = trash for -1 scatter.
    e_inj = n_edges
    e_ej = n_edges + n_ep
    e_tot = n_edges + 2 * n_ep + 1
    src_r = torch.as_tensor(wl.src_router, device=dev).long()
    dst_r = torch.as_tensor(wl.dst_router, device=dev).long()
    ct = routing.compressed
    edges, routed = _path_edge_tensor(
        routing.nh.to(dev) if ct is None else ct.to(dev),
        torch.as_tensor(eix, device=dev), src_r, dst_r, cfg.max_hops)
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
    # Fault lanes: per-virtual-link death step (INT32_MAX = never) and
    # churn intervals with their re-pick steps (up + churn_conv,
    # saturating).  The keys are absent for a fabric without them.
    fabric = eix >= 0
    imax = np.iinfo(np.int32).max
    if routing.link_down_step is not None:
        lds = np.full(e_tot, imax, dtype=np.int32)
        lds[eix[fabric]] = np.asarray(routing.link_down_step,
                                      dtype=np.int32)[fabric]
        arrs["link_down_step"] = torch.as_tensor(lds, device=dev)
    if routing.link_churn is not None:
        lc_r = np.asarray(routing.link_churn, dtype=np.int32)
        lc = np.full((e_tot,) + lc_r.shape[2:], imax, dtype=np.int32)
        lc[eix[fabric]] = lc_r[fabric]
        pick_at = np.minimum(lc[..., 1].astype(np.int64)
                             + int(routing.churn_conv or 0), imax)
        arrs["link_churn"] = torch.as_tensor(lc, device=dev)   # (E, K, 2)
        arrs["churn_pick_at"] = torch.as_tensor(               # (E, K)
            pick_at.astype(np.int32), device=dev)
    return arrs, (e_tot, int(n_layers), int(cfg.n_steps))


def _flow_uniforms(key: torch.Tensor, f: int) -> torch.Tensor:
    """(F, 2) U[0,1) draws where row ``i`` depends only on ``(key, i)``;
    a (B, 1, 2) key stack gives (B, F, 2)."""
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


def _rto_next(rto: torch.Tensor, delivered: torch.Tensor,
              backoff: torch.Tensor, rto_base: int,
              rto_cap: int) -> torch.Tensor:
    """One step of the retransmission-timeout state machine, per flow:
    ``backoff`` (stall-timer expiry, loss on link death) doubles the RTO
    up to ``rto_cap``; a delivery resets it to ``rto_base`` and wins over
    a backoff in the same step."""
    bumped = torch.where(backoff, torch.clamp_max(rto * 2, rto_cap), rto)
    return torch.where(delivered, torch.full_like(rto, rto_base), bumped)


def _escape_layers(layer: torch.Tensor, esc_ok: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic blackhole escape: the next layer, cyclically after
    the current one, that ``esc_ok`` (F, L) allows; flows with none keep
    their layer (``valid`` False).  Draws nothing from the PRNG."""
    n_layers = esc_ok.shape[1]
    order = (layer.long()[:, None] + 1
             + torch.arange(n_layers, device=layer.device)[None, :]) \
        % n_layers
    ok = torch.gather(esc_ok, 1, order)                        # (F, L)
    first = ok.to(torch.int32).argmax(dim=1)
    esc = torch.gather(order, 1, first[:, None])[:, 0]
    valid = ok.any(dim=1)
    return torch.where(valid, esc, layer.long()).to(torch.int32), valid


def _churn_state(i: int, sched: torch.Tensor, pick_at: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-link churn predicates at step ``i``: ``dead`` inside a
    ``(down, up)`` outage (capacity 0), ``unpickable`` inside the wider
    ``(down, up + conv)`` window (no re-pick).  ``sched`` is ``(..., K,
    2)`` int32 with INT32_MAX sentinels, ``pick_at`` the saturating
    ``up + conv`` (``(..., K)``)."""
    down = sched[..., 0]
    dead = ((down <= i) & (i < sched[..., 1])).any(dim=-1)
    unpickable = ((down <= i) & (i < pick_at)).any(dim=-1)
    return dead, unpickable


def _check_config(cfg: SimConfig) -> None:
    if cfg.transport not in ("ndp", "tcp", "dctcp"):
        raise ValueError(f"unknown transport {cfg.transport!r}")
    if cfg.balancing not in ("ecmp", "letflow", "fatpaths"):
        raise ValueError(f"unknown balancing {cfg.balancing!r}")


def _run_scan(arrs: Dict[str, torch.Tensor], key0: torch.Tensor,
              cfg: SimConfig, static: Tuple[int, int, int],
              n_real: Optional[Sequence[int]] = None
              ) -> Dict[str, torch.Tensor]:
    """The chunked flow scan: returns the final per-flow state plus
    ``horizon_chunks`` (how many full chunks ran) and, with
    ``cfg.record``, the ``goodput_t`` and ``stalled_t`` buffers.

    ``key0`` is one PRNG key (2,), or a stack (B, 2) of keys for the B
    elements of a union (:func:`union_prepared`): element b owns flow rows
    ``[b*F_pad, (b+1)*F_pad)`` and draws from its own key with its local
    flow index, exactly as it would alone; one key is a stack of one.
    ``n_real`` is each element's real flow count (default: all rows),
    which the rollback's rounding rule reads.  ``horizon_chunks`` has the
    key's batch shape: an int for one key, a list for a stack.
    ``cfg.record`` takes one element only."""
    _check_config(cfg)
    e_tot, n_layers, n_steps = static
    dev = arrs["size"].device
    f = arrs["size"].shape[0]
    keys = key0.reshape(-1, 2)
    n_elem = keys.shape[0]
    if f % n_elem:
        raise ValueError(f"{f} flow rows do not split into {n_elem} elements")
    fp = f // n_elem
    n_real = [fp] * n_elem if n_real is None else [int(n) for n in n_real]
    if len(n_real) != n_elem or not all(0 <= n <= fp for n in n_real):
        raise ValueError(f"n_real {n_real} does not fit {n_elem} elements "
                         f"of {fp} rows")
    line_bytes = _f32(cfg.line_rate * cfg.dt)          # bytes per step at line
    dt = np.float32(cfg.dt)
    gap_rate = _f32(cfg.dt / cfg.flowlet_gap)
    gap_eps = _f32(cfg.gap_eps)
    tcp_init, tcp_ai = _f32(cfg.tcp_init), _f32(cfg.tcp_ai)
    md = _f32(cfg.tcp_md if cfg.transport == "tcp" else cfg.dctcp_md)
    thresh = _f32(0.98)
    tiny_sent = _f32(1e-6)

    reroute = cfg.balancing in ("letflow", "fatpaths")
    chunk = max(1, int(cfg.horizon_chunk))
    n_full, rem = divmod(n_steps, chunk)
    usable = arrs["usable"]
    routed_lf = arrs["routed"]
    # Fault and recovery lanes: each adds its ops only when present.
    recovery_on = str(cfg.recovery).lower() in ("on", "1", "true")
    record_on = bool(int(cfg.record))
    if record_on and n_elem > 1:
        # The goodput sum's order follows the unpadded flow count.
        raise ValueError("record=1 takes one element, not a union of "
                         f"{n_elem}")
    has_lds = "link_down_step" in arrs
    has_churn = "link_churn" in arrs
    has_death = has_lds or has_churn
    # ECN marking on the links' load replaces the share-vs-rate signal as
    # dctcp's congestion signal under recovery.
    want_util = recovery_on and cfg.transport == "dctcp"

    # Per element: split its key, then fold in the local flow index
    # (folding in the union's index would change every other element's
    # draws).
    k_init, k_scan = prng.split(keys.to(dev)).movedim(1, 0)[:, :, None]
    layer0 = _pick_layers(_flow_uniforms(k_init, fp).reshape(f, 2)[:, 0],
                          usable)
    flow_keys = prng.fold_in(k_scan, torch.arange(fp, device=dev)
                             ).reshape(f, 2)

    if cfg.transport == "ndp":
        rate0 = torch.ones(f, dtype=torch.float32, device=dev)
    else:
        rate0 = torch.full((f,), tcp_init, dtype=torch.float32, device=dev)
    zeros = torch.zeros(f, dtype=torch.float32, device=dev)
    state = dict(remaining=arrs["size"].clone(), layer=layer0, rate=rate0,
                 hops=zeros, sent_acc=zeros, w_acc=zeros,
                 depart_step=torch.full((f,), -1, dtype=torch.int32,
                                        device=dev))
    if recovery_on:
        # stall: consecutive ~zero-share steps; rto: current timeout;
        # blocked_until: the step before which a penalised flow may not
        # send; retrans_acc: lost line units that had to be resent.
        izeros = torch.zeros(f, dtype=torch.int32, device=dev)
        state.update(stall=izeros, blocked_until=izeros, retrans_acc=zeros,
                     rto=torch.full((f,), int(cfg.rto_base),
                                    dtype=torch.int32, device=dev))
    bufs = None
    if record_on:
        bufs = dict(goodput_t=torch.zeros(n_steps, dtype=torch.float32,
                                          device=dev),
                    stalled_t=torch.zeros(n_steps, dtype=torch.float32,
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
    esc_ok = None
    if reroute:
        first = (torch.arange(n_layers, device=dev) == 0)[None, :]
        pickable = torch.where(usable.any(dim=1, keepdim=True), usable,
                               first)
        pick_routable = (pickable & routed_lf.T).any(dim=1)
        if recovery_on:
            # The layers the blackhole escape may take: pickable ones
            # that route the flow.
            esc_ok = pickable & routed_lf.T                       # (F, L)
    else:
        pick_routable = torch.zeros(f, dtype=torch.bool, device=dev)
    if has_churn:
        pe_safe = torch.where(arrs["path_edges"] >= 0, arrs["path_edges"],
                              e_tot - 1).long()                    # (L, F, S)
        churn_down = arrs["link_churn"][..., 0]                    # (E, K)
    if recovery_on and has_death:
        # Bytes in flight on a path: rate x its latency in steps, per
        # (layer, flow) once; the latency is one fused multiply-add, then
        # a product with the f32 reciprocal of dt.
        pipe_lf = fused_add_mul(
            torch.tensor(_f32(cfg.sw_latency), device=dev),
            arrs["path_hops"],
            torch.tensor(_f32(cfg.link_latency), device=dev)) \
            * float(np.float32(1.0) / dt)                       # (L, F)
        line_t = torch.tensor(line_bytes, device=dev)
        # Taken per element, on its real flow count.
        lim = torch.tensor([n - n % 8 for n in n_real], device=dev)
        vector_rows = (torch.arange(fp, device=dev)[None]
                       < lim[:, None]).reshape(f)
    if want_util:
        ecn = _f32(cfg.ecn_thresh)
        recip_band = float(np.float32(1.0) / np.float32(
            max(1.0 - float(cfg.ecn_thresh), 1e-6)))
        md_gap = torch.tensor(_f32(1.0 - cfg.dctcp_md), device=dev)

    def step(st, i: int, u: Optional[torch.Tensor]):
        t = float(np.float32(i) * dt)
        started = (arrs["start"] <= t) & (i >= arrs["active_at"])
        done = st["remaining"] <= 0
        active = started & ~done
        g = packed[st["layer"], frows]                          # (F, H+4)
        edges = g[:, :n_slots]
        routed = g[:, n_slots] > 0
        n_hops = g[:, n_slots + 1].to(torch.float32)
        if recovery_on:
            # A flow penalised by its transport's loss response sends
            # nothing until its blocked_until step.
            unblocked = i >= st["blocked_until"]
            send = active & routed & unblocked
        else:
            send = active & routed

        w = send.to(torch.float32)
        desired = torch.clamp_max(st["rate"], 1.0) * w
        # Dead links (mid-run death, churn outages) have capacity 0.
        cap_t = cap
        if has_lds:
            cap_t = torch.where(i < arrs["link_down_step"], cap, 0.0)
        if has_churn:
            churn_dead, link_unpick = _churn_state(
                i, arrs["link_churn"], arrs["churn_pick_at"])
            cap_t = torch.where(churn_dead, 0.0, cap_t)
        wf = waterfill_step(
            edges, w, desired, cap_t, active=send, fair_iters=cfg.fair_iters,
            want_util=want_util, acc=st["sent_acc"], plan=plan,
            layer=st["layer"])
        if want_util:
            sent, share, util, sent_acc = wf
        else:
            sent, share, sent_acc = wf

        # Lost in flight: at the step a path's link dies, the bytes in
        # the pipe (capped by what was sent) roll back from sent_acc into
        # remaining.
        if recovery_on and has_death:
            safe_e = torch.where(edges >= 0, edges, e_tot - 1).long()
            died_now = None
            if has_lds:
                died_now = (arrs["link_down_step"][safe_e] == i).any(dim=1)
            if has_churn:
                c_hit = (churn_down[safe_e] == i).flatten(1).any(dim=1)
                died_now = c_hit if died_now is None else died_now | c_hit
            hit = active & routed & died_now
            pipe_steps = pipe_lf[st["layer"], frows]
            lost = torch.where(
                hit, torch.minimum(st["sent_acc"], st["rate"] * pipe_steps),
                0.0)

        delivered = sent * line_bytes
        if recovery_on and has_death:
            # Rounded as XLA:CPU rounds the reference here: in its 8-lane
            # vector loop the select behind ``delivered * w`` folds into
            # the subtraction, which then fuses with the product; its
            # scalar remainder (the last F mod 8 flows) rounds the
            # product first.  ``+ lost * line_bytes`` rounds the product
            # first everywhere (+0.0 is no identity of an add).
            sub = torch.where(
                vector_rows & send,
                fused_add_mul(st["remaining"], -sent, line_t),
                st["remaining"] - delivered * w)
            new_remaining = torch.clamp_min(sub, 0.0) + lost * line_bytes
        else:
            new_remaining = torch.clamp_min(st["remaining"] - delivered * w,
                                            0.0)
        newly_done = (new_remaining <= 0) & ~done & started
        hops = torch.where(newly_done, n_hops, st["hops"])
        depart = torch.where(newly_done, i, st["depart_step"])

        if cfg.transport == "ndp":
            rate = torch.ones(f, dtype=torch.float32, device=dev)
        elif want_util:
            # ECN: a decrease graded by the worst link utilization on the
            # path (full dctcp_md at saturation); a dead link reports a
            # huge utilization.
            frac = torch.clamp((util - ecn) * recip_band, 0.0, 1.0)
            up = torch.where(st["rate"] < 0.5, st["rate"] * 2.0,
                             st["rate"] + tcp_ai)
            down = st["rate"] * fused_add_mul(torch.ones_like(frac), -md_gap,
                                              frac)
            rate = torch.where(frac > 0, torch.clamp_min(down, tcp_init),
                               torch.clamp_max(up, 1.0))
        else:
            congested = share < st["rate"] * thresh
            up = torch.where(st["rate"] < 0.5, st["rate"] * 2.0,
                             st["rate"] + tcp_ai)
            rate = torch.where(congested,
                               torch.clamp_min(share * md, tcp_init),
                               torch.clamp_max(up, 1.0))

        if recovery_on:
            progress = sent > tiny_sent
            # Stall timer: consecutive steps an unblocked, wanting flow
            # got ~zero share.
            stalled = active & unblocked & ~progress
            stall_new = torch.where(stalled, st["stall"] + 1, 0)
            expire = stalled & (stall_new >= st["rto"])
            backoff = expire
            blocked = st["blocked_until"]
            if has_death:
                if cfg.transport == "ndp":
                    pen = 1             # trimming: one trimmed RTT
                elif cfg.transport == "tcp":
                    pen = st["rto"]     # a full RTO and slow start
                    rate = torch.where(hit, tcp_init, rate)
                else:                   # dctcp: a quarter RTO, gentle
                    pen = torch.clamp_min(st["rto"] // 4, 1)
                    rate = torch.where(
                        hit, torch.clamp_min(st["rate"] * md, tcp_init),
                        rate)
                blocked = torch.where(hit, i + pen, blocked)
                if cfg.transport != "ndp":
                    backoff = backoff | hit
            rto = _rto_next(st["rto"], progress, backoff, int(cfg.rto_base),
                            int(cfg.rto_cap))
            stall_out = torch.where(expire, 0, stall_new)

        if reroute:
            slack = 1.0 - torch.clamp(sent, 0.0, 1.0)
            p_gap = torch.clamp(gap_rate * (slack + gap_eps), 0.0, 1.0)
            roll = u[:, 0] < p_gap
            if has_churn:
                # A layer crossing a link inside its (down, up + conv)
                # window is not re-picked; with every candidate gated the
                # flow keeps its layer.
                layer_live = ~link_unpick[pe_safe].any(dim=2).T    # (F, L)
                cand = usable & layer_live
                newpick = _pick_layers(u[:, 1], cand)
                roll = roll & cand.any(dim=1)
            else:
                newpick = _pick_layers(u[:, 1], usable)
            layer = torch.where(roll & active, newpick, st["layer"])
        else:
            layer = st["layer"]
        if recovery_on and reroute:
            # Blackhole escape once the stall timer crosses the RTO; ecmp
            # stays pinned (the never-recovers control).
            esc_layer, esc_valid = _escape_layers(
                st["layer"], esc_ok & layer_live if has_churn else esc_ok)
            layer = torch.where(expire & esc_valid, esc_layer, layer)

        out = dict(remaining=new_remaining, layer=layer, rate=rate,
                   hops=hops, depart_step=depart, w_acc=st["w_acc"] + w,
                   sent_acc=sent_acc)
        if recovery_on:
            out.update(stall=stall_out, rto=rto, blocked_until=blocked,
                       retrans_acc=st["retrans_acc"])
            if has_death:
                # fma(d, s, acc) from the kernel, then - lost: the
                # reference's sent_acc + sent - lost.
                out["sent_acc"] = sent_acc - lost
                out["retrans_acc"] = st["retrans_acc"] + lost
        if record_on:
            bufs["goodput_t"][i] = xla_sum(sent * w)
            bufs["stalled_t"][i] = (active & (sent <= tiny_sent)).sum()
        return out

    def run_chunk(st, c: int, length: int):
        u = _chunk_uniforms(flow_keys, c, chunk)[:length] if reroute else None
        for s in range(length):
            st = step(st, c * chunk + s, u[s] if reroute else None)
        return st

    def exhausted(st) -> list:
        """Per element: is every flow done or provably stuck (one sync)."""
        routed_cur = routed_lf[st["layer"], frows]
        stuck = ~routed_cur & ~pick_routable
        gone = (st["remaining"] <= 0.0) | stuck
        return gone.view(n_elem, fp).all(dim=1).tolist()

    # Each element's horizon is the first chunk at which it was found
    # exhausted, as it would be alone; the loop runs while any element is
    # live.  Running an exhausted element on changes no field _to_result
    # reads: its done flows have ~done False and its stuck flows send
    # False, so w = 0, nothing is delivered, rolled back or newly done,
    # and the water-filling step's fma(acc, 0, s) leaves sent_acc as it
    # was.  The same holds for the steps that early exit skips.
    horizon = [None] * n_elem
    c_run = 0
    while c_run < n_full:
        if cfg.adaptive_horizon:
            for b, done_b in enumerate(exhausted(state)):
                if done_b and horizon[b] is None:
                    horizon[b] = c_run
            if None not in horizon:
                break
        state = run_chunk(state, c_run, chunk)
        c_run += 1
    horizon = [c_run if h is None else h for h in horizon]
    if rem:
        # The tail rides chunk index n_full unconditionally.
        state = run_chunk(state, n_full, rem)
    return dict(state, horizon_chunks=(horizon if key0.dim() > 1
                                       else horizon[0]), **(bufs or {}))


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
    ret = final.get("retrans_acc")
    return SimResult(
        fct=fct,
        delivered=size - remaining,
        size=size,
        finished=remaining <= 0,
        link_util_mean=sent / max(want, 1.0),
        config=cfg,
        depart_step=dep,
        retrans_bytes=(None if ret is None
                       else ret * f32(cfg.line_rate * cfg.dt)),
        goodput_steps=final.get("goodput_t"),
        stalled_steps=final.get("stalled_t"),
    )


def pad_prepared(arrs: Dict[str, torch.Tensor], static: Tuple[int, int, int],
                 *, n_flows: int, n_edges: int, hop_slots: int):
    """One cell's :func:`prepare` output padded to a bucket's shape, so
    that cells of different sizes join one union scan, without changing
    what the real flows do:

    * flows: a padded flow has ``start=inf``, ``active_at=INT32_MAX``,
      size 0, ``usable``/``routed`` False and ``-1`` hop slots, so it never
      starts and sends with weight 0; draws are keyed by flow index, so
      real flows draw as before;
    * hop slots: ``-1`` columns, which the scan maps to the trash link;
    * links: extra slots have capacity 1 and no flow indexes them; only
      the trash id moves to ``n_edges - 1``.  ``link_down_step`` and
      ``link_churn`` are padded with INT32_MAX (never down); the churn
      event axis K is never padded.

    The link plan keeps its entries (flow ids are unchanged) and gains
    empty segments for the new links.  The layer count and the step count
    are never padded.  Returns ``(arrs, static)``."""
    e_tot, n_layers, n_steps = static
    f, h = arrs["size"].shape[0], arrs["path_edges"].shape[2]
    if n_flows < f or n_edges < e_tot or hop_slots < h:
        raise ValueError(f"pad target ({n_flows},{n_edges},{hop_slots}) "
                         f"smaller than cell ({f},{e_tot},{h})")
    pf = n_flows - f

    def padf(x, fill, dim):
        shape = list(x.shape)
        shape[dim] = pf
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=x.device)], dim=dim)

    def padl(x):
        shape = (n_edges - e_tot,) + tuple(x.shape[1:])
        return torch.cat([x, torch.full(shape, _IMAX, dtype=x.dtype,
                                        device=x.device)])

    pe = arrs["path_edges"]
    pe = torch.cat([pe, torch.full(pe.shape[:2] + (hop_slots - h,), -1,
                                   dtype=pe.dtype, device=pe.device)], dim=2)
    off = arrs["plan_offsets"]
    out = dict(
        path_edges=padf(pe, -1, 1),
        plan_offsets=torch.cat([off, off[-1:].expand(n_edges - e_tot)]),
        plan_entries=arrs["plan_entries"],
        routed=padf(arrs["routed"], False, 1),
        path_hops=padf(arrs["path_hops"], 0.0, 1),
        usable=padf(arrs["usable"], False, 0),
        size=padf(arrs["size"], 0.0, 0),
        start=padf(arrs["start"], float("inf"), 0),
        active_at=padf(arrs["active_at"], _IMAX, 0),
    )
    for k in ("link_down_step", "link_churn", "churn_pick_at"):
        if k in arrs:
            out[k] = padl(arrs[k])
    return out, (int(n_edges), n_layers, n_steps)


def union_prepared(elements: Sequence[Dict[str, torch.Tensor]],
                   static: Tuple[int, int, int]):
    """B padded cells (:func:`pad_prepared`, one shape ``static``) as one
    flow set for :func:`_run_scan`: element b's flows are rows
    ``[b*F_pad, (b+1)*F_pad)`` and its live link e < E_pad - 1 is link
    ``b*(E_pad - 1) + e``; one trash link sits at the end, and ``-1``
    stays ``-1``, so no element's own trash slot becomes a neighbour's
    link.  The link plan is the elements' plans laid end to end, flow ids
    shifted by ``b*F_pad`` and offsets by the entries before: each link's
    entries belong to one element and keep its (flow, slot) order, so the
    water-filling step sums every element's links as it would alone.
    An element may appear more than once (one per sim seed).  Returns
    ``(arrs, static)`` of the union."""
    e_pad, n_layers, n_steps = static
    live = e_pad - 1
    fp = elements[0]["size"].shape[0]
    keys = set(elements[0])
    if any(set(a) != keys or a["size"].shape[0] != fp
           or a["plan_offsets"].shape[0] != e_pad + 1 for a in elements):
        raise ValueError("union elements must share one padded shape and "
                         "the same lanes")
    cat = torch.cat
    out = dict(
        path_edges=cat([torch.where(a["path_edges"] >= 0,
                                    a["path_edges"] + b * live, -1)
                        for b, a in enumerate(elements)], dim=1),
        routed=cat([a["routed"] for a in elements], dim=1),
        path_hops=cat([a["path_hops"] for a in elements], dim=1),
    )
    for k in ("usable", "size", "start", "active_at"):
        out[k] = cat([a[k] for a in elements])
    offsets, base = [], 0
    for a in elements:
        offsets.append(a["plan_offsets"][:live].to(torch.int64) + base)
        base += int(a["plan_entries"].shape[0])
    if base >= 2 ** 31:
        raise ValueError(f"{base} plan entries overflow int32 offsets")
    # The end of the last live link, and the trash link's empty segment.
    offsets.append(torch.tensor([base, base], dtype=torch.int64,
                                device=elements[0]["size"].device))
    out["plan_offsets"] = cat(offsets).to(torch.int32)
    out["plan_entries"] = cat([a["plan_entries"] + b * fp
                               for b, a in enumerate(elements)])
    for k in ("link_down_step", "link_churn", "churn_pick_at"):
        if k in keys:
            out[k] = cat([a[k][:live] for a in elements]
                         + [elements[0][k][live:]])
    return out, (len(elements) * live + 1, n_layers, n_steps)


_PER_FLOW = ("remaining", "layer", "rate", "hops", "sent_acc", "w_acc",
             "depart_step", "stall", "rto", "blocked_until", "retrans_acc")


def split_union(final: Dict, n_elem: int) -> List[Dict[str, np.ndarray]]:
    """A union scan's final state (run with a key stack) as one host dict
    per element: its padded rows and its own ``horizon_chunks``."""
    host = {k: v.cpu().numpy() for k, v in final.items()
            if k in _PER_FLOW}
    fp = final["remaining"].shape[0] // n_elem
    return [dict({k: v[b * fp:(b + 1) * fp] for k, v in host.items()},
                 horizon_chunks=final["horizon_chunks"][b])
            for b in range(n_elem)]


def batch_result(size: np.ndarray, final, cfg: SimConfig,
                 n_flows: Optional[int] = None,
                 start: Optional[np.ndarray] = None) -> SimResult:
    """One element of a batched scan -> :class:`SimResult`, stripping the
    flow padding (``n_flows`` = the cell's real flow count).  ``start``
    is the cell's flow start times; omit for all-start-at-zero
    workloads."""
    if n_flows is not None:
        final = {k: (v[:n_flows] if k in _PER_FLOW else v)
                 for k, v in final.items()}
        size = size[:n_flows]
        if start is not None:
            start = np.asarray(start)[:n_flows]
    return _to_result(np.asarray(size), final, cfg, start=start)


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
