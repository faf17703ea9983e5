"""The registered evaluation-matrix axes: topologies, routing schemes,
traffic patterns, evaluators.

* ``TOPOLOGIES`` — paper topologies at cost-matched "small" defaults
  (``sf`` == ``sf(q=5)``); compact ``by_name`` forms (``"sf:11"``) are
  accepted too via :func:`topo_spec`.
* ``ROUTINGS``   — ``ecmp`` / ``letflow`` (minimal multi-table) and
  ``fatpaths`` / ``minimal`` (layer stacks).  Builders receive a
  :class:`RoutingCtx` whose ``stack`` memoizer keys expensive artifacts
  by ``(topo, scheme, seed)``, so ``ecmp``/``letflow`` share one table
  stack and a grid never rebuilds a layer stack.
* ``TRAFFIC``    — the static §2.4 patterns, ``collide`` (the Fig 5
  microcase), and the open-loop ``load``, ``incast`` and ``anycast``
  streams (activation steps from :mod:`repro_torch.core.arrivals`).
* ``EVALUATORS`` — ``transport`` (the flow simulator) and ``outcast``
  (fairness under incast).

Evaluators return ``(metrics, meta)``: plain-float metrics for the
:class:`~repro_torch.experiments.results.RunResult` record, and
bookkeeping meta.  Every builder gets the session's ``device``.

The JAX package registers more: the ``failures``/``churn`` routing
wrappers and the ``degradation``/``recovery``/``availability``/``mat``/
``fabric`` evaluators.  :data:`NOT_PORTED` names the ROADMAP item each
waits on.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .. import prng
from ..core import arrivals
from ..core import paths as paths_mod
from ..core import routing as routing_mod
from ..core import topology as topo_mod
from ..core.layers import LayeredRouting, build_layers
from ..core.topology import Topology
from ..core.traffic import FlowWorkload, endpoint_router_map, make_workload
from ..core.transport import SimConfig, ecmp_routing, simulate_seeds
from .registry import Registry
from .specs import Spec, SpecError, SpecLike

__all__ = ["TOPOLOGIES", "ROUTINGS", "TRAFFIC", "EVALUATORS", "NOT_PORTED",
           "RoutingBundle", "RoutingCtx", "topo_spec", "transport_plan",
           "transport_meta", "table_meta", "check_ported"]

TOPOLOGIES = Registry("topology")
ROUTINGS = Registry("routing scheme")
TRAFFIC = Registry("traffic pattern")
EVALUATORS = Registry("evaluator")

#: Axis entries of the JAX package not ported yet -> their ROADMAP item.
NOT_PORTED = {
    "failures": "A8", "churn": "A8", "degradation": "A8", "recovery": "A8",
    "availability": "A8", "mat": "A11", "fabric": "A11",
}


def check_ported(spec: SpecLike) -> None:
    """Raise ``NotImplementedError`` for an axis entry that exists in the
    JAX package but not yet here."""
    name = Spec.coerce(spec).name
    if name in NOT_PORTED:
        raise NotImplementedError(f"{name!r} is not ported yet "
                                  f"(ROADMAP {NOT_PORTED[name]})")


# -----------------------------------------------------------------------------
# Topologies.  Defaults are the repo's "small" cost-matched set.
# -----------------------------------------------------------------------------
@TOPOLOGIES.register("sf", q=5, p=None)
def _sf(q, p) -> Topology:
    return topo_mod.slim_fly(q, concentration=p)


@TOPOLOGIES.register("df", p=3)
def _df(p) -> Topology:
    return topo_mod.dragonfly(p)


@TOPOLOGIES.register("jf", n=50, k=6, p=3, seed=0)
def _jf(n, k, p, seed) -> Topology:
    return topo_mod.jellyfish(n, k, p, seed=seed)


@TOPOLOGIES.register("xp", k=8, lift=None, p=None, seed=0)
def _xp(k, lift, p, seed) -> Topology:
    return topo_mod.xpander(k, lift=lift, concentration=p, seed=seed)


@TOPOLOGIES.register("hx", l=2, s=6, p=None)
def _hx(l, s, p) -> Topology:
    return topo_mod.hyperx(l, s, concentration=p)


@TOPOLOGIES.register("ft", k=8, oversub=1)
def _ft(k, oversub) -> Topology:
    return topo_mod.fat_tree(k, oversubscription=oversub)


@TOPOLOGIES.register("ft2", l=8, s=4, p=4)
def _ft2(l, s, p) -> Topology:
    return topo_mod.two_layer_fat_tree(l, s, p)


@TOPOLOGIES.register("ft2eq", of="sf(q=5)")
def _ft2eq(of) -> Topology:
    """Cost-equalised two-layer fat tree of another registered topology
    (arXiv 1301.6179 construction; endpoint count and cables-per-endpoint
    matched — the paper's FT2 baseline pairing)."""
    return topo_mod.cost_matched_ft2(TOPOLOGIES.build(Spec.coerce(of)))


@TOPOLOGIES.register("clique", k=12, p=None)
def _clique(k, p) -> Topology:
    return topo_mod.clique(k, concentration=p)


@TOPOLOGIES.register("star", n=16)
def _star(n) -> Topology:
    return topo_mod.star(n)


@TOPOLOGIES.register("jfeq", of="sf(q=5)", seed=0)
def _jfeq(of, seed) -> Topology:
    """Equivalent Jellyfish of another registered topology (§2.2.3)."""
    return topo_mod.equivalent_jellyfish(TOPOLOGIES.build(Spec.coerce(of)),
                                         seed=seed)


_COMPACT_KEYS = {"sf": ("q",), "df": ("p",), "ft": ("k",), "xp": ("k",),
                 "clique": ("k",), "star": ("n",), "hx": ("l", "s"),
                 "jf": ("n", "k", "p"), "ft2": ("l", "s", "p")}


def topo_spec(obj: SpecLike) -> Spec:
    """Coerce a topology spec, also accepting the compact
    :func:`repro_torch.core.topology.by_name` form (``"sf:11"``)."""
    if isinstance(obj, str) and ":" in obj:
        fam, _, arg = obj.partition(":")
        keys = _COMPACT_KEYS.get(fam)
        if keys is None:
            raise SpecError(f"unknown compact topology spec {obj!r}; "
                            f"known families: {', '.join(sorted(_COMPACT_KEYS))}")
        vals = arg.split("x")
        if len(vals) != len(keys):
            raise SpecError(f"compact spec {obj!r} needs "
                            f"{len(keys)} 'x'-separated values")
        return Spec(fam, tuple((k, int(v)) for k, v in zip(keys, vals)))
    return Spec.coerce(obj)


# -----------------------------------------------------------------------------
# Routing schemes.
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoutingBundle:
    """A built routing stack + the load-balancing mode that drives it."""

    routing: LayeredRouting
    balancing: str            # ecmp | letflow | fatpaths


@dataclasses.dataclass(frozen=True)
class RoutingCtx:
    """What a routing builder gets from the session: the topology, the
    device, and a ``stack(key, thunk)`` memoizer for expensive artifacts."""

    topo: Topology
    topo_key: str
    seed: int
    stack: Callable[[tuple, Callable[[], LayeredRouting]], LayeredRouting]
    device: torch.device


def _minimal_tables(ctx: RoutingCtx, n: int) -> LayeredRouting:
    # ecmp and letflow differ only in balancing — one shared table stack.
    return ctx.stack(
        ("tables", ctx.topo_key, int(n), ctx.seed),
        lambda: ecmp_routing(ctx.topo, n_tables=int(n), seed=ctx.seed,
                             device=ctx.device))


def _layer_stack(ctx: RoutingCtx, scheme: str, n_layers: int,
                 rho: float) -> LayeredRouting:
    return ctx.stack(
        ("layers", ctx.topo_key, scheme, int(n_layers), float(rho), ctx.seed),
        lambda: build_layers(ctx.topo, int(n_layers), float(rho),
                             scheme=scheme, seed=ctx.seed, device=ctx.device))


@ROUTINGS.register("ecmp", n=8)
def _ecmp(ctx: RoutingCtx, n) -> RoutingBundle:
    return RoutingBundle(_minimal_tables(ctx, n), "ecmp")


@ROUTINGS.register("letflow", n=8)
def _letflow(ctx: RoutingCtx, n) -> RoutingBundle:
    return RoutingBundle(_minimal_tables(ctx, n), "letflow")


@ROUTINGS.register("fatpaths", n_layers=9, rho=0.6, scheme="rand")
def _fatpaths(ctx: RoutingCtx, n_layers, rho, scheme) -> RoutingBundle:
    return RoutingBundle(_layer_stack(ctx, scheme, n_layers, rho), "fatpaths")


@ROUTINGS.register("minimal", n_layers=9)
def _minimal(ctx: RoutingCtx, n_layers) -> RoutingBundle:
    """Minimal-only ablation: a rho=1 stack driven by flowlet balancing
    (Fig 11's 'minimal' arm)."""
    return RoutingBundle(_layer_stack(ctx, "rand", n_layers, 1.0), "fatpaths")


# -----------------------------------------------------------------------------
# Traffic patterns.  Builders: (topo, seed, device, **spec kwargs).
# -----------------------------------------------------------------------------
def _register_workload(name: str, doc: str = "", **overrides):
    defaults = dict(rounds=1, flow_size=float(1 << 20), randomize=True,
                    frac=1.0, spread=0.0, arrival=0.0)
    defaults.update(overrides)

    @TRAFFIC.register(name, **defaults)
    def _build(topo, seed, device, rounds, flow_size, randomize, frac,
               spread, arrival, _name=name, **kw) -> FlowWorkload:
        return make_workload(topo, _name, flow_size=flow_size,
                             n_rounds=int(rounds), arrival_rate=arrival,
                             randomize=bool(randomize), seed=seed,
                             frac_endpoints=frac, size_spread=spread,
                             device=device, **kw)

    if doc:
        _build.__doc__ = doc


_register_workload("uniform", doc="random uniform destinations (§2.4.1)")
_register_workload("permutation", doc="random permutation / derangement "
                                      "(§2.4.2)")
_register_workload("offdiag", doc="off-diagonal shift pattern (§2.4.3)")
_register_workload("shuffle", doc="bit-rotation shuffle pattern (§2.4.4)")
_register_workload("alltoone", acks=0, ack_frac=0.05,
                   doc="incast onto one victim endpoint; acks=1 adds the "
                       "reverse ACK-path flows (TCP outcast)")
# The paper's skew cases run un-randomized (§3.4 is the mitigation):
_register_workload("adversarial", rounds=2, randomize=False,
                   doc="skewed off-diagonal maximising colliding router "
                       "pairs (§2.4.6)")
_register_workload("stencil", randomize=False,
                   doc="4-point stencil as four off-diagonals (§2.4.5)")
_register_workload("worstcase", randomize=False,
                   doc="assignment-maximised path lengths (§2.4.7)")


@TRAFFIC.register("collide", rounds=4, flow_size=float(4 << 20))
def _collide(topo, seed, device, rounds, flow_size) -> FlowWorkload:
    """Fig 5 microcase: every endpoint of router A sends ``rounds`` flows
    to endpoints of a router B at distance min(2, diameter) — all flows
    share the (often unique) minimal path."""
    ep2r = endpoint_router_map(topo)
    dist = paths_mod.shortest_path_lengths(
        np.asarray(topo.adj, bool), max_l=8, device=device).cpu().numpy()
    conc = np.asarray(topo.concentration)
    target = 2 if (dist[(dist > 0) & (dist < 10_000)] >= 2).any() else 1
    pair = next(((a, b) for a in range(topo.n_routers)
                 for b in range(topo.n_routers)
                 if dist[a, b] == target and conc[a] > 0 and conc[b] > 0),
                None)
    if pair is None:
        raise SpecError(f"no routable endpoint pair on {topo.name}")
    a_eps = np.where(ep2r == pair[0])[0]
    b_eps = np.where(ep2r == pair[1])[0]
    m = min(len(a_eps), len(b_eps))
    src = np.tile(a_eps[:m], int(rounds))
    dst = np.tile(b_eps[:m], int(rounds))
    return FlowWorkload(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        size=np.full(len(src), float(flow_size)),
        start=np.zeros(len(src)),
        src_router=ep2r[src].astype(np.int32),
        dst_router=ep2r[dst].astype(np.int32))


# -----------------------------------------------------------------------------
# Open-loop dynamic traffic: continuous arrivals, incast waves, anycast
# placement.  Activation steps come from repro_torch.core.arrivals
# (deterministic in (key, flow), prefix-stable).
# -----------------------------------------------------------------------------
@TRAFFIC.register("load", level=0.5, pattern="uniform",
                  flow_size=float(256 << 10), window=256, process="poisson",
                  shape=1.5, bound=64.0, dt=10e-6, line_rate=12.5e9,
                  samples=32)
def _load(topo, seed, device, level, pattern, flow_size, window, process,
          shape, bound, dt, line_rate, samples) -> FlowWorkload:
    """Open-loop stream offering ``level`` x bisection bandwidth over a
    ``window``-step arrival window (endpoint pairs drawn from ``pattern``;
    interarrivals from ``process`` = poisson | pareto)."""
    level = float(level)
    if not 0.0 < level:
        raise SpecError(f"load level must be > 0 (got {level})")
    bisect = arrivals.bisection_bandwidth(topo, line_rate=float(line_rate),
                                          samples=int(samples),
                                          seed=int(seed))
    rate = level * bisect * float(dt) / float(flow_size)  # flows per step
    n = max(1, int(round(rate * int(window))))
    rounds = max(1, -(-n // max(1, topo.n_endpoints)))
    base = make_workload(topo, str(pattern), flow_size=float(flow_size),
                         n_rounds=rounds, randomize=True, seed=seed,
                         device=device)
    idx = np.arange(n) % base.n_flows
    steps = arrivals.activation_steps(
        prng.PRNGKey(int(seed), device), n, rate=rate, process=str(process),
        shape=float(shape), bound=float(bound))
    return FlowWorkload(
        src=base.src[idx], dst=base.dst[idx], size=base.size[idx],
        start=arrivals.activation_starts(steps, float(dt)),
        src_router=base.src_router[idx], dst_router=base.dst_router[idx],
        active_step=steps)


@TRAFFIC.register("incast", fan_in=8, waves=4, wave_period=64,
                  flow_size=float(256 << 10), acks=1, ack_frac=0.05,
                  dt=10e-6)
def _incast(topo, seed, device, fan_in, waves, wave_period, flow_size, acks,
            ack_frac, dt) -> FlowWorkload:
    """Synchronized incast waves: ``fan_in`` seeded senders fire at one
    victim every ``wave_period`` steps; acks=1 adds the victim's reverse
    ACK-path flows (the outcast evaluator's workload)."""
    ep2r = endpoint_router_map(topo)
    n = len(ep2r)
    rng = np.random.default_rng(seed)
    victim = int(rng.integers(n))
    others = np.setdiff1d(np.arange(n), [victim])
    fan_in = min(int(fan_in), len(others))
    senders = np.concatenate([
        np.random.default_rng(seed + 7 * w + 1).choice(
            others, size=fan_in, replace=False)
        for w in range(max(1, int(waves)))])
    sched = arrivals.incast_schedule(len(senders), fan_in, int(wave_period))
    src, dst, step = senders, np.full(len(senders), victim), sched
    is_ack = np.zeros(len(senders), dtype=bool)
    if acks:
        src = np.concatenate([src, dst])
        dst = np.concatenate([dst, senders])
        step = np.concatenate([step, sched])
        is_ack = np.concatenate([is_ack, np.ones(len(senders), dtype=bool)])
    size = np.where(is_ack, float(flow_size) * float(ack_frac),
                    float(flow_size))
    step = step.astype(np.int32)
    return FlowWorkload(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        size=size.astype(np.float64),
        start=arrivals.activation_starts(step, float(dt)),
        src_router=ep2r[src].astype(np.int32),
        dst_router=ep2r[dst].astype(np.int32),
        active_step=step, is_ack=is_ack)


@TRAFFIC.register("anycast", replicas=4, policy="closest",
                  flow_size=float(256 << 10), window=128, process="poisson",
                  shape=1.5, bound=64.0, dt=10e-6)
def _anycast(topo, seed, device, replicas, policy, flow_size, window,
             process, shape, bound, dt) -> FlowWorkload:
    """Anycast service placement: every client resolves to one of
    ``replicas`` seeded replica endpoints by the router distance table
    (boolean APSP on ``device``; policy = closest | farthest); window > 0
    makes the request stream open-loop."""
    ep2r = endpoint_router_map(topo)
    n = len(ep2r)
    if n < 2:
        raise SpecError(f"anycast needs >= 2 endpoints on {topo.name}")
    rng = np.random.default_rng(seed)
    reps = np.sort(rng.choice(n, size=min(int(replicas), n - 1),
                              replace=False))
    clients = np.setdiff1d(np.arange(n), reps)
    dist = paths_mod.shortest_path_lengths(
        np.asarray(topo.adj, bool), max_l=16, device=device).cpu().numpy()
    d = dist[ep2r[clients][:, None], ep2r[reps][None, :]]
    if policy == "closest":
        pick = np.argmin(d, axis=1)
    elif policy == "farthest":
        pick = np.argmax(d, axis=1)
    else:
        raise SpecError(f"unknown anycast policy {policy!r}; "
                        "choose 'closest' or 'farthest'")
    src, dst = clients, reps[pick]
    f = len(src)
    if int(window) > 0:
        steps = arrivals.activation_steps(
            prng.PRNGKey(int(seed), device), f, rate=f / float(int(window)),
            process=str(process), shape=float(shape), bound=float(bound))
    else:
        steps = np.zeros(f, dtype=np.int32)
    return FlowWorkload(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        size=np.full(f, float(flow_size)),
        start=arrivals.activation_starts(steps, float(dt)),
        src_router=ep2r[src].astype(np.int32),
        dst_router=ep2r[dst].astype(np.int32),
        active_step=steps)


# -----------------------------------------------------------------------------
# Evaluators.  Signature: (session, cell, **kw) -> (metrics, meta).
# -----------------------------------------------------------------------------
def _fct_metrics(sims) -> Dict[str, float]:
    fct = np.concatenate([r.fct[r.finished] for r in sims])
    tput = np.concatenate([r.throughput_per_flow for r in sims])
    finished = float(np.mean([r.finished.mean() for r in sims]))
    util = float(np.mean([r.link_util_mean for r in sims]))
    if len(fct) == 0:
        p50 = p99 = mean = float("nan")
    else:
        p50 = float(np.quantile(fct, 0.50) * 1e6)
        p99 = float(np.quantile(fct, 0.99) * 1e6)
        mean = float(fct.mean() * 1e6)
    if tput.size and not np.all(np.isnan(tput)):
        tput_gbs = float(np.nanmean(tput) / 1e9)
    else:
        tput_gbs = float("nan")
    return {"fct_p50_us": p50, "fct_p99_us": p99, "fct_mean_us": mean,
            "finished": finished, "tput_gbs": tput_gbs, "link_util": util}


def transport_plan(cell, steps, transport, seeds, dt, flowlet_gap,
                   adaptive=1, chunk=64, recovery="off", rto_base=16,
                   rto_cap=256, ecn_thresh=0.65,
                   record=0) -> Tuple[SimConfig, list]:
    """The transport evaluator's execution plan for one cell:
    ``(SimConfig, sim_seeds)``.  ``adaptive`` toggles the early-exit
    horizon (results are identical either way), and
    ``REPRO_FULL_HORIZON=1`` force-disables it process-wide without
    changing any spec string.  ``chunk`` feeds the PRNG block layout, so
    changing it changes the simulated draws."""
    adaptive_on = bool(int(adaptive)) and \
        os.environ.get("REPRO_FULL_HORIZON", "") != "1"
    cfg = SimConfig(transport=transport, balancing=cell.bundle.balancing,
                    n_steps=int(steps), dt=dt, flowlet_gap=flowlet_gap,
                    horizon_chunk=int(chunk), adaptive_horizon=adaptive_on,
                    recovery=str(recovery), rto_base=int(rto_base),
                    rto_cap=int(rto_cap), ecn_thresh=float(ecn_thresh),
                    record=int(record), seed=cell.seed)
    sim_seeds = [cell.seed + 1000 * i for i in range(max(1, int(seeds)))]
    return cfg, sim_seeds


def transport_meta(cell, cfg, sim_seeds) -> Dict[str, Any]:
    """RunResult meta for a transport-family cell; a dynamic (open-loop)
    workload also records its offered byte rate (host float64)."""
    meta = {"n_seeds": len(sim_seeds), "transport": cfg.transport,
            "balancing": cell.bundle.balancing}
    wl = cell.workload
    if wl.active_step is not None:
        meta["offered_gbs"] = arrivals.offered_gbs(wl.size, wl.active_step,
                                                   cfg.dt)
    return meta


@EVALUATORS.register("transport", steps=2000, transport="ndp", seeds=1,
                     dt=10e-6, flowlet_gap=50e-6, adaptive=1, chunk=64,
                     recovery="off", rto_base=16, rto_cap=256,
                     ecn_thresh=0.65)
def _transport(session, cell, steps, transport, seeds, dt, flowlet_gap,
               adaptive, chunk, recovery, rto_base, rto_cap,
               ecn_thresh) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Flow-level simulation (§7); ``seeds`` > 1 runs a sim-seed sweep
    over one prepared cell.  ``recovery=on`` is not ported yet."""
    cfg, sim_seeds = transport_plan(cell, steps, transport, seeds, dt,
                                    flowlet_gap, adaptive, chunk, recovery,
                                    rto_base, rto_cap, ecn_thresh)
    sims = simulate_seeds(cell.topo, cell.bundle.routing, cell.workload,
                          cfg, sim_seeds, device=session.device)
    return _fct_metrics(sims), transport_meta(cell, cfg, sim_seeds)


@EVALUATORS.register("outcast", steps=2000, transport="ndp", seeds=1,
                     dt=10e-6, flowlet_gap=50e-6, adaptive=1, chunk=64)
def _outcast(session, cell, steps, transport, seeds, dt, flowlet_gap,
             adaptive, chunk) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Outcast fairness under incast: the standard FCT metrics plus the
    Jain fairness index over per-victim-flow goodput and the p99/p50 FCT
    tail ratio, measured over the data flows into the modal destination
    (ACK-path flows excluded)."""
    cfg, sim_seeds = transport_plan(cell, steps, transport, seeds, dt,
                                    flowlet_gap, adaptive, chunk)
    sims = simulate_seeds(cell.topo, cell.bundle.routing, cell.workload,
                          cfg, sim_seeds, device=session.device)
    wl = cell.workload
    dsts, counts = np.unique(wl.dst, return_counts=True)
    victim = int(dsts[np.argmax(counts)])
    data = wl.dst == victim
    if wl.is_ack is not None:
        data &= ~wl.is_ack
    horizon_s = cfg.n_steps * cfg.dt
    goodput, fcts = [], []
    for r in sims:
        elapsed = np.where(r.finished, np.maximum(r.fct, cfg.dt),
                           np.maximum(horizon_s - wl.start, cfg.dt))
        goodput.append((r.delivered / elapsed)[data])
        fcts.append(r.fct[data & r.finished])
    g = np.concatenate(goodput)
    fct = np.concatenate(fcts)
    jain = float(g.sum() ** 2 / (len(g) * (g ** 2).sum())) \
        if g.size and (g ** 2).sum() > 0 else float("nan")
    tail = float(np.quantile(fct, 0.99) / max(np.quantile(fct, 0.50), 1e-12)) \
        if fct.size else float("nan")
    metrics = dict(_fct_metrics(sims), jain_goodput=jain,
                   fct_p99_over_p50=tail, victim_flows=float(data.sum()))
    return metrics, transport_meta(cell, cfg, sim_seeds)


def table_meta(bundle: RoutingBundle) -> Dict[str, int]:
    """§5.5 deployment accounting for a built stack."""
    return {"table_exact": int(routing_mod.table_entries_exact(bundle.routing)),
            "table_prefix": int(routing_mod.table_entries_prefix(bundle.routing))}
