"""The registered evaluation-matrix axes: topologies, routing schemes,
traffic patterns, evaluators.

* ``TOPOLOGIES`` — paper topologies at cost-matched "small" defaults
  (``sf`` == ``sf(q=5)``); compact ``by_name`` forms (``"sf:11"``) are
  accepted too via :func:`topo_spec`.
* ``ROUTINGS``   — ``ecmp`` / ``letflow`` (minimal multi-table),
  ``fatpaths`` / ``minimal`` (layer stacks), and the ``failures`` /
  ``churn`` wrappers that damage another scheme's stack (seeded dead
  links before or during the run, or links that die and come back).
  Builders receive a :class:`RoutingCtx` whose ``stack`` memoizer keys
  expensive artifacts by ``(topo, scheme, seed)``, so ``ecmp``/``letflow``
  share one table stack and a grid never rebuilds a layer stack.
* ``TRAFFIC``    — the static §2.4 patterns, ``collide`` (the Fig 5
  microcase), and the open-loop ``load``, ``incast`` and ``anycast``
  streams (activation steps from :mod:`repro_torch.core.arrivals`).
* ``EVALUATORS`` — ``transport`` (the flow simulator), ``outcast``
  (fairness under incast), under faults ``degradation`` (a failure-rate
  ladder), ``recovery`` (time to recover from a mid-run fault) and
  ``availability`` (SLO compliance under churn), and off the scan ``mat``
  (the §6.4 throughput LP) and ``fabric`` (link loads on a modelled
  cluster fabric).

Evaluators return ``(metrics, meta)``: plain-float metrics for the
:class:`~repro_torch.experiments.results.RunResult` record, and
bookkeeping meta.  Every builder gets the session's ``device``.
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import prng
from ..core import arrivals
from ..core import failures as failures_mod
from ..core import paths as paths_mod
from ..core import routing as routing_mod
from ..core import topology as topo_mod
from ..core.layers import LayeredRouting, build_layers
from ..core.throughput import mat_lp, mat_single_layer
from ..core.topology import Topology
from ..core.traffic import FlowWorkload, endpoint_router_map, make_workload
from ..core.transport import SimConfig, ecmp_routing, simulate_seeds
from .registry import Registry
from .specs import Spec, SpecError, SpecLike

__all__ = ["TOPOLOGIES", "ROUTINGS", "TRAFFIC", "EVALUATORS",
           "RoutingBundle", "RoutingCtx", "topo_spec", "transport_plan",
           "transport_meta", "table_meta", "stack_rep_key", "fct_metrics"]

TOPOLOGIES = Registry("topology")
ROUTINGS = Registry("routing scheme")
TRAFFIC = Registry("traffic pattern")
EVALUATORS = Registry("evaluator")

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
    """A built routing stack + the load-balancing mode that drives it.

    ``failure_meta`` is set by the ``failures(...)`` and ``churn(...)``
    axes: a JSON-safe summary of the damage (dead links and layers,
    disconnected pairs, churn events), computed on the host at build time
    and merged into cell meta by :func:`transport_meta`."""

    routing: LayeredRouting
    balancing: str            # ecmp | letflow | fatpaths
    failure_meta: Optional[Dict[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class RoutingCtx:
    """What a routing builder gets from the session: the topology, the
    device, and a ``stack(key, thunk)`` memoizer for expensive artifacts."""

    topo: Topology
    topo_key: str
    seed: int
    stack: Callable[[tuple, Callable[[], LayeredRouting]], LayeredRouting]
    device: torch.device


def stack_rep_key(topo: Topology) -> tuple:
    """Memo-key suffix for routing stacks: the path engine and table
    representation resolved at this topology's size.  ``REPRO_PATH_ENGINE``
    can change within one process, and a stack built by one engine must
    not be served to a caller of the other (nor one without compressed
    tables to a caller expecting them), so every stack key carries it."""
    n = topo.n_routers
    return (paths_mod.path_engine(n), paths_mod.representation_for(n))


def _minimal_tables(ctx: RoutingCtx, n: int) -> LayeredRouting:
    # ecmp and letflow differ only in balancing — one shared table stack.
    return ctx.stack(
        ("tables", ctx.topo_key, int(n), ctx.seed) + stack_rep_key(ctx.topo),
        lambda: ecmp_routing(ctx.topo, n_tables=int(n), seed=ctx.seed,
                             device=ctx.device))


def _layer_stack(ctx: RoutingCtx, scheme: str, n_layers: int,
                 rho: float) -> LayeredRouting:
    return ctx.stack(
        ("layers", ctx.topo_key, scheme, int(n_layers), float(rho), ctx.seed)
        + stack_rep_key(ctx.topo),
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


@ROUTINGS.register("failures", of="fatpaths", rate=0.05, pattern="bernoulli",
                   mode="repair", down_step=-1, fseed=0)
def _failures(ctx: RoutingCtx, of, rate, pattern, mode, down_step,
              fseed) -> RoutingBundle:
    """Degraded-fabric wrapper: build ``of``'s stack, then kill a seeded
    set of links (``rate`` x ``pattern`` = bernoulli | switch | blast).
    ``down_step < 0`` (default) damages the fabric before the run, with
    ``mode="repair"`` (tables rebuilt on the masked adjacency) or
    ``mode="drop"`` (broken entries invalidated, no re-convergence);
    ``down_step >= 0`` keeps pristine tables and kills the links at that
    scan step.  The mask key depends on the cell seed and ``fseed``, not
    the scheme; an empty mask (rate=0) reproduces the undamaged cell."""
    inner_spec = Spec.coerce(of)
    if inner_spec.name == "failures":
        raise SpecError("failures(of=...) cannot nest another failures spec")
    fn, kw = ROUTINGS.resolve(inner_spec)
    inner = fn(ctx, **kw)
    rate, down_step = float(rate), int(down_step)
    pattern, mode = str(pattern), str(mode)
    key = failures_mod.scenario_key(ctx.seed, int(fseed), ctx.device)
    dead = failures_mod.failure_mask(key, ctx.topo.adj, rate, pattern)
    ckey = ("failed", ctx.topo_key, ROUTINGS.canonical(inner_spec), rate,
            pattern, mode, down_step, int(fseed), ctx.seed) \
        + stack_rep_key(ctx.topo)
    if down_step >= 0 and dead.any():
        lr = ctx.stack(ckey, lambda: dataclasses.replace(
            inner.routing, build_stats=None,
            link_down_step=failures_mod.link_down_schedule(dead, down_step)))
        report = failures_mod.FailureReport(
            failed_links=int(np.triu(dead, 1).sum()),
            total_links=int(np.triu(np.asarray(ctx.topo.adj, bool), 1).sum()),
            rate=rate, pattern=pattern, mode="midrun",
            dead_layers=0, disconnected_pairs=0, down_step=down_step)
    else:
        lr, report = ctx.stack(ckey, lambda: failures_mod.apply_failures(
            inner.routing, dead, mode=mode, seed=ctx.seed, rate=rate,
            pattern=pattern))
    return RoutingBundle(lr, inner.balancing, failure_meta=report.as_meta())


@ROUTINGS.register("churn", of="fatpaths", rate=0.1, pattern="flap",
                   mtbf=120.0, mttr=40.0, conv=8, events=4, proc="exp",
                   shape=1.5, fseed=0)
def _churn(ctx: RoutingCtx, of, rate, pattern, mtbf, mttr, conv, events,
           proc, shape, fseed) -> RoutingBundle:
    """Link-churn wrapper: build ``of``'s stack, then attach a seeded
    schedule of per-link (down, up) outages (``pattern`` = flap | rolling
    | repair; ``mtbf``/``mttr`` mean steps between / to repair, ``proc``
    = exp | pareto, ``events`` cycles per flapping link).  Capacity
    returns at ``up``; flowlets may re-pick the link ``conv`` steps
    later.  An empty schedule (rate=0) returns the inner bundle itself.
    Composes with ``failures(...)`` in either order."""
    inner_spec = Spec.coerce(of)
    if inner_spec.name == "churn":
        raise SpecError("churn(of=...) cannot nest another churn spec")
    fn, kw = ROUTINGS.resolve(inner_spec)
    inner = fn(ctx, **kw)
    rate = float(rate)
    key = failures_mod.scenario_key(ctx.seed, int(fseed), ctx.device)
    sched = failures_mod.churn_schedule(
        key, ctx.topo.adj, rate, pattern=str(pattern), mtbf=float(mtbf),
        mttr=float(mttr), events=int(events), proc=str(proc),
        shape=float(shape))
    summ = failures_mod.churn_summary(sched)
    if summ["churn_events"] == 0:
        return inner
    ckey = ("churn", ctx.topo_key, ROUTINGS.canonical(inner_spec), rate,
            str(pattern), float(mtbf), float(mttr), int(conv), int(events),
            str(proc), float(shape), int(fseed), ctx.seed) \
        + stack_rep_key(ctx.topo)
    lr = ctx.stack(ckey, lambda: dataclasses.replace(
        inner.routing, build_stats=None, link_churn=sched,
        churn_conv=int(conv)))
    fm = dict(inner.failure_meta or {})
    fm.update(churn_pattern=str(pattern), churn_rate=rate,
              churn_mtbf=float(mtbf), churn_mttr=float(mttr),
              churn_conv=int(conv), **summ)
    return RoutingBundle(lr, inner.balancing, failure_meta=fm)


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
    out = {"fct_p50_us": p50, "fct_p99_us": p99, "fct_mean_us": mean,
           "finished": finished, "tput_gbs": tput_gbs, "link_util": util}
    # Recovery cells also report retransmitted bytes (host float64).
    rb = [r.retrans_bytes for r in sims if r.retrans_bytes is not None]
    if rb:
        out["retrans_mb"] = float(
            np.mean([np.asarray(b, np.float64).sum() for b in rb]) / 2 ** 20)
    return out


#: Public alias: the batched sweep assembles the same record from its sims.
fct_metrics = _fct_metrics


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
    workload also records its offered byte rate (host float64), and a
    fault-injected cell its damage summary."""
    meta = {"n_seeds": len(sim_seeds), "transport": cfg.transport,
            "balancing": cell.bundle.balancing}
    wl = cell.workload
    if wl.active_step is not None:
        meta["offered_gbs"] = arrivals.offered_gbs(wl.size, wl.active_step,
                                                   cfg.dt)
    if cell.bundle.failure_meta is not None:
        meta.update(cell.bundle.failure_meta)
    return meta


@EVALUATORS.register("transport", steps=2000, transport="ndp", seeds=1,
                     dt=10e-6, flowlet_gap=50e-6, adaptive=1, chunk=64,
                     recovery="off", rto_base=16, rto_cap=256,
                     ecn_thresh=0.65)
def _transport(session, cell, steps, transport, seeds, dt, flowlet_gap,
               adaptive, chunk, recovery, rto_base, rto_cap,
               ecn_thresh) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Flow-level simulation (§7); ``seeds`` > 1 runs a sim-seed sweep
    over one prepared cell.  ``recovery=on`` arms the loss-recovery lanes
    (RTO, blackhole escape, lost-in-flight accounting)."""
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


def _trailing_mean(x: np.ndarray, window: int) -> np.ndarray:
    """Trailing ``window``-step moving mean with growing head windows
    (the first k < window entries average what exists).  ONE shared
    implementation for every plateau/band computation — the recovery,
    availability, and degradation evaluators must smooth identically or
    their thresholds drift apart."""
    x = np.asarray(x, np.float64)
    csum = np.concatenate([[0.0], np.cumsum(x)])
    n = np.arange(1, len(x) + 1)
    lo = np.maximum(0, n - window)
    return (csum[n] - csum[lo]) / (n - lo)


def _curve_points_meta(n: int, curve_points: int) -> np.ndarray:
    """Downsampled step indices for trajectory meta (shared by the
    recovery and availability evaluators)."""
    return np.unique(np.linspace(0, max(0, n - 1),
                                 min(int(curve_points), max(1, n)))
                     .round().astype(int))


def _run_alternate(session, cell, rspec, steps, transport, seeds, dt,
                   flowlet_gap, adaptive=1, chunk=64, **plan_kw):
    """Run THIS cell's workload under an alternate routing spec — the
    scenario runner shared by the degradation and availability
    evaluators (baseline / rate-ladder / pristine-control runs).
    Returns ``(sims, bundle, cfg, sim_seeds)``; the alternate bundle is
    memoized in the session like any other routing artifact."""
    bundle = session.routing(cell.spec.topo, rspec, seed=cell.seed)
    shim = types.SimpleNamespace(bundle=bundle, seed=cell.seed)
    cfg, sim_seeds = transport_plan(shim, steps, transport, seeds, dt,
                                    flowlet_gap, adaptive, chunk, **plan_kw)
    sims = simulate_seeds(cell.topo, bundle.routing, cell.workload,
                          cfg, sim_seeds, device=session.device)
    return sims, bundle, cfg, sim_seeds


@EVALUATORS.register("degradation", rates="0.05:0.15:0.3",
                     patterns="bernoulli:switch", mode="repair", steps=400,
                     transport="ndp", seeds=1, dt=10e-6, flowlet_gap=50e-6,
                     adaptive=1, chunk=64)
def _degradation(session, cell, rates, patterns, mode, steps, transport,
                 seeds, dt, flowlet_gap, adaptive, chunk
                 ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Degradation curves: re-run the cell's routing scheme under
    escalating seeded link failures — one scenario per (pattern, rate),
    plus the shared rate-0 baseline — and report absolute and
    baseline-relative throughput/FCT alongside disconnection counts.
    ``rates``/``patterns`` are colon-separated lists.  Failure masks are
    NESTED in rate (see :mod:`repro_torch.core.failures`), so the
    dead-link/disconnected-pair counts are monotone in rate by
    construction, and the throughput curve degrades monotonically up to
    simulation noise."""
    rate_list = sorted({float(r) for r in str(rates).split(":") if r})
    pattern_list = [p for p in str(patterns).split(":") if p]
    if not rate_list or not pattern_list:
        raise SpecError("degradation needs non-empty rates and patterns")

    def run_scenario(fspec: Spec):
        sims, bundle, _, _ = _run_alternate(
            session, cell, fspec, steps, transport, seeds, dt,
            flowlet_gap, adaptive, chunk)
        return _fct_metrics(sims), bundle.failure_meta

    of = cell.spec.routing.format()
    base_m, _ = run_scenario(Spec("failures", (
        ("of", of), ("rate", 0.0), ("mode", str(mode)))))
    metrics = {"tput_base": base_m["tput_gbs"],
               "fct_p99_base": base_m["fct_p99_us"],
               "finished_base": base_m["finished"]}
    meta: Dict[str, Any] = {"failure_mode": str(mode),
                            "failure_rates": rate_list,
                            "failure_patterns": pattern_list,
                            "scenarios": {}}
    base_tput = base_m["tput_gbs"]
    for pat in pattern_list:
        discs = []
        for rate in rate_list:
            m, fm = run_scenario(Spec("failures", (
                ("of", of), ("rate", rate), ("pattern", pat),
                ("mode", str(mode)))))
            tag = f"{pat}_r{rate:g}"
            rel = (m["tput_gbs"] / base_tput
                   if base_tput and base_tput > 0 else float("nan"))
            metrics.update({
                f"tput_{tag}": m["tput_gbs"],
                f"tput_rel_{tag}": rel,
                f"fct_p99_{tag}": m["fct_p99_us"],
                f"finished_{tag}": m["finished"],
                f"disc_{tag}": float(fm["disconnected_pairs"]),
                f"dead_layers_{tag}": float(fm["dead_layers"]),
            })
            discs.append(fm["disconnected_pairs"])
            meta["scenarios"][tag] = fm
        metrics[f"monotone_disc_{pat}"] = float(
            all(a <= b for a, b in zip(discs, discs[1:])))
    return metrics, meta


@EVALUATORS.register("recovery", steps=400, transport="ndp", seeds=1,
                     dt=10e-6, flowlet_gap=50e-6, chunk=64, rto_base=16,
                     rto_cap=256, ecn_thresh=0.65, eps=0.05, window=16,
                     curve_points=64)
def _recovery(session, cell, steps, transport, seeds, dt, flowlet_gap,
              chunk, rto_base, rto_cap, ecn_thresh, eps, window,
              curve_points) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Time-to-recover under a mid-run fault: run the cell with the
    recovery lanes armed and the per-step record lane on (full horizon —
    the trajectory must be exact), then measure how long aggregate
    goodput takes to climb back within ``eps`` of its pre-fault plateau
    after the ``failures(down_step=...)`` link death.

    Reported metrics: ``ttr_steps`` (steps from the fault until the
    trailing ``window``-step mean goodput re-enters the plateau band;
    NaN if it never does inside the horizon), ``recovered`` (0/1),
    ``dip_frac`` (deepest post-fault goodput dip relative to plateau),
    ``plateau_goodput`` (line-rate units), ``stalled_peak`` (worst
    post-fault stalled-flow count) — plus the standard FCT metrics
    (which include ``retrans_mb``, the retransmitted-byte total).  Meta
    carries the downsampled goodput/stalled trajectories (host float64
    means over seeds, so both sweep engines serialize identical curves).
    Composed without a mid-run fault the cell is trivially recovered
    (``ttr_steps=0``); a layer-pinned scheme (ecmp) over a blackhole
    never re-enters the band — the acceptance control."""
    cfg, sim_seeds = transport_plan(
        cell, steps, transport, seeds, dt, flowlet_gap, adaptive=0,
        chunk=chunk, recovery="on", rto_base=rto_base, rto_cap=rto_cap,
        ecn_thresh=ecn_thresh, record=1)
    sims = simulate_seeds(cell.topo, cell.bundle.routing, cell.workload,
                          cfg, sim_seeds, device=session.device)
    g = np.mean([np.asarray(r.goodput_steps, np.float64) for r in sims],
                axis=0)
    st = np.mean([np.asarray(r.stalled_steps, np.float64) for r in sims],
                 axis=0)
    n = len(g)
    window = max(1, int(window))
    eps = float(eps)
    fm = cell.bundle.failure_meta or {}
    down = int(fm.get("link_down_step", -1))
    if down < 0:
        # No one-shot death: fall back to the first churn down-event, so
        # recovery-from-first-outage is measurable on churn cells too.
        down = int(fm.get("churn_first_down", -1))
    if down < 1 or down >= n:
        plateau = float(g[-window:].mean()) if n else float("nan")
        ttr, recovered, dip = 0.0, 1.0, 0.0
    else:
        plateau = float(g[max(0, down - window):down].mean())
        post = g[down:]
        # Trailing moving mean over the POST-fault segment only (early
        # windows are short) — pre-fault steps must not inflate it.
        sm = _trailing_mean(post, window)
        target = (1.0 - eps) * plateau
        hits = np.nonzero(sm >= target)[0]
        recovered = 1.0 if hits.size else 0.0
        ttr = float(hits[0]) if hits.size else float("nan")
        dip = (float((plateau - post.min()) / plateau)
               if plateau > 0 else float("nan"))
    metrics = dict(
        _fct_metrics(sims), ttr_steps=ttr, recovered=recovered,
        dip_frac=dip, plateau_goodput=plateau,
        stalled_peak=float(st[down:].max() if 0 <= down < n else st.max()))
    idx = _curve_points_meta(n, curve_points)
    meta = dict(transport_meta(cell, cfg, sim_seeds),
                recovery_eps=eps, recovery_window=window,
                rto_base=int(rto_base), rto_cap=int(rto_cap),
                curve_steps=[int(i) for i in idx],
                goodput_curve=[float(g[i]) for i in idx],
                stalled_curve=[float(st[i]) for i in idx])
    return metrics, meta


@EVALUATORS.register("availability", slo=0.8, steps=400, transport="ndp",
                     seeds=1, dt=10e-6, flowlet_gap=50e-6, chunk=64,
                     recovery="on", rto_base=16, rto_cap=256,
                     ecn_thresh=0.65, window=16, curve_points=64)
def _availability(session, cell, slo, steps, transport, seeds, dt,
                  flowlet_gap, chunk, recovery, rto_base, rto_cap,
                  ecn_thresh, window, curve_points
                  ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Availability-SLO compliance under link churn: run the cell (full
    horizon, per-step record lane on, recovery lanes armed by default)
    and score every post-churn step against the PRISTINE plateau — the
    tail trailing-mean goodput of a control run of the same cell with
    its ``churn(...)`` wrapper stripped, same workload and seeds.

    A step complies when the trailing ``window``-step mean goodput is
    >= ``slo`` x plateau.  Reported metrics: ``availability`` (compliant
    fraction of steps from the first churn down-event), ``violations``
    (number of entries into violation), ``max_outage_steps`` (longest
    violating stretch), ``plateau_goodput`` — plus the standard FCT
    metrics.  Cells without a churn schedule are trivially available
    (1.0).  Meant for saturating workloads (e.g. a huge permutation)
    where pristine goodput holds a plateau; the acceptance pairing is
    ``churn(of=fatpaths...)`` vs the layer-pinned ``churn(of=ecmp...)``
    control on the same flapping fabric."""
    cfg, sim_seeds = transport_plan(
        cell, steps, transport, seeds, dt, flowlet_gap, adaptive=0,
        chunk=chunk, recovery=str(recovery), rto_base=rto_base,
        rto_cap=rto_cap, ecn_thresh=ecn_thresh, record=1)
    sims = simulate_seeds(cell.topo, cell.bundle.routing, cell.workload,
                          cfg, sim_seeds, device=session.device)
    g = np.mean([np.asarray(r.goodput_steps, np.float64) for r in sims],
                axis=0)
    n = len(g)
    window = max(1, int(window))
    slo = float(slo)

    # Pristine control: the same cell with the churn wrapper stripped
    # (shared scenario runner; no-churn cells are their own control).
    rspec = cell.spec.routing
    if rspec.name == "churn":
        _, rkw = ROUTINGS.resolve(rspec)
        pristine_spec = Spec.coerce(rkw["of"])
    else:
        pristine_spec = rspec
    sims0, _, _, _ = _run_alternate(
        session, cell, pristine_spec, steps, transport, seeds, dt,
        flowlet_gap, adaptive=0, chunk=chunk, recovery=str(recovery),
        rto_base=rto_base, rto_cap=rto_cap, ecn_thresh=ecn_thresh,
        record=1)
    g0 = np.mean([np.asarray(r.goodput_steps, np.float64) for r in sims0],
                 axis=0)
    plateau = float(_trailing_mean(g0, window)[-1]) if len(g0) \
        else float("nan")

    fm = cell.bundle.failure_meta or {}
    down = int(fm.get("churn_first_down", -1))
    if down < 1 or down >= n or not plateau > 0:
        availability, violations, max_outage = 1.0, 0.0, 0.0
    else:
        sm = _trailing_mean(g[down:], window)
        ok = sm >= slo * plateau
        availability = float(ok.mean())
        bad = np.concatenate([[0], (~ok).astype(np.int64), [0]])
        d = np.diff(bad)
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        violations = float(len(starts))
        max_outage = float((ends - starts).max()) if len(starts) else 0.0
    metrics = dict(
        _fct_metrics(sims), availability=availability,
        violations=violations, max_outage_steps=max_outage,
        plateau_goodput=plateau)
    idx = _curve_points_meta(n, curve_points)
    meta = dict(transport_meta(cell, cfg, sim_seeds),
                availability_slo=slo, availability_window=window,
                pristine_routing=pristine_spec.format(),
                curve_steps=[int(i) for i in idx],
                goodput_curve=[float(g[i]) for i in idx],
                pristine_curve=[float(g0[i]) for i in idx])
    return metrics, meta


@EVALUATORS.register("mat", max_hops=16, capacity=1.0)
def _mat(session, cell, max_hops, capacity
         ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Maximum achievable throughput: LP relaxation + greedy single-layer
    rounding (§6.4)."""
    lp = mat_lp(cell.bundle.routing, cell.workload, max_hops=int(max_hops),
                capacity=capacity)
    single = mat_single_layer(cell.bundle.routing, cell.workload,
                              max_hops=int(max_hops), capacity=capacity)
    metrics = {"mat_T": float(lp.throughput),
               "mat_T_single": float(single.throughput),
               "n_paths": float(lp.n_paths),
               "n_demands": float(lp.n_demands)}
    return metrics, {"lp_status": lp.status}


@EVALUATORS.register("fabric", line_rate=12.5e9, quanta=32)
def _fabric(session, cell, line_rate, quanta
            ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Route the workload's flows over a modelled ClusterFabric and report
    link loads (ECMP hash-split for ecmp/letflow cells, greedy flowlets
    for fatpaths/minimal cells).  The fabric's candidate paths are the
    cell's OWN routing stack — a 'minimal' cell is measured over its
    minimal-only layers, not a default FatPaths stack."""
    fb = session.bundle_fabric(cell.spec.topo, cell.spec.routing,
                               seed=cell.seed, line_rate=line_rate,
                               flowlet_quanta=int(quanta))
    scheme = "fatpaths" if cell.bundle.balancing == "fatpaths" else "ecmp"
    wl = cell.workload
    flows = list(zip(wl.src.tolist(), wl.dst.tolist(), wl.size.tolist()))
    rep = fb.evaluate_flows(flows, scheme=scheme,
                            kind=cell.spec.pattern.name,
                            n_ranks=cell.topo.n_endpoints,
                            payload_bytes=float(wl.size.sum()))
    metrics = {"bottleneck_mb": rep.bottleneck_bytes / 2 ** 20,
               "time_ms": rep.time_s * 1e3,
               "util_gini": rep.util_gini,
               "links_used": float(rep.n_links_used),
               "fabric_gb": rep.fabric_bytes / 1e9}
    return metrics, {"fabric_scheme": scheme}


def table_meta(bundle: RoutingBundle) -> Dict[str, int]:
    """§5.5 deployment accounting for a built stack."""
    return {"table_exact": int(routing_mod.table_entries_exact(bundle.routing)),
            "table_prefix": int(routing_mod.table_entries_prefix(bundle.routing))}
