"""Session layer: artifact memoization across experiment cells.

A :class:`Session` is the unit of reuse for a whole evaluation grid:
topologies, forwarding-layer stacks (keyed by ``(topo, scheme, seed)``)
and workloads are built at most once, whatever order the cells run in;
``ecmp`` and ``letflow`` cells share one minimal-table stack.
``session.stats`` counts builds vs hits and accumulates build wall time
(``build_wall_s``, ``<kind>_build_s``, and the device/host split the
layer builders report), so each ``RunResult.meta`` carries the per-cell
``build_s`` / ``cache_hits`` / ``cache_builds``.

Every artifact is built on the session's ``device`` (``"cuda"`` unless
the caller asks for ``"cpu"``); asking for ``cuda`` without a card
raises.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from .. import resolve_device
from ..core.layers import build_layers
from ..core.topology import Topology
from ..core.traffic import FlowWorkload
from ..core.transport import ecmp_routing
from .catalog import (EVALUATORS, ROUTINGS, TOPOLOGIES, TRAFFIC,
                      RoutingBundle, RoutingCtx, stack_rep_key, table_meta,
                      topo_spec)
from .results import RunResult
from .specs import ExperimentSpec, Spec, SpecLike

__all__ = ["Session", "ResolvedCell"]


class ResolvedCell:
    """An :class:`ExperimentSpec` with its artifacts materialized."""

    def __init__(self, spec: ExperimentSpec, topo: Topology,
                 bundle: RoutingBundle, workload: FlowWorkload):
        self.spec = spec
        self.topo = topo
        self.bundle = bundle
        self.workload = workload
        self.seed = spec.seed


class Session:
    """Memoizing context for running experiment cells on one device."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cache: Dict[tuple, Any] = {}
        self.stats = collections.Counter()

    # ---- memoization core ----------------------------------------------------
    def _memo(self, key: tuple, build: Callable[[], Any]) -> Any:
        if key in self._cache:
            self.stats[f"{key[0]}_hit"] += 1
            return self._cache[key]
        self.stats[f"{key[0]}_build"] += 1
        t0 = time.perf_counter()
        value = build()
        dt = time.perf_counter() - t0
        self.stats[f"{key[0]}_build_s"] += dt
        self.stats["build_wall_s"] += dt
        bs = getattr(value, "build_stats", None)
        if isinstance(bs, dict):
            self.stats["build_device_s"] += bs.get("device_s", 0.0)
            self.stats["build_host_s"] += bs.get("host_s", 0.0)
        self._cache[key] = value
        return value

    def _stack_memo(self, key: tuple, build: Callable[[], Any]) -> Any:
        return self._memo(("stack",) + key, build)

    # ---- artifact builders ---------------------------------------------------
    # Cache keys use the defaults-filled canonical spec form, so "sf" and
    # "sf(q=5)" (or "sf:5") resolve to the same artifacts.
    def topology(self, spec: SpecLike) -> Topology:
        spec = topo_spec(spec)
        return self._memo(("topo", TOPOLOGIES.canonical(spec)),
                          lambda: TOPOLOGIES.build(spec))

    def routing(self, topo: SpecLike, scheme: SpecLike,
                seed: int = 0) -> RoutingBundle:
        tspec = topo_spec(topo)
        rspec = Spec.coerce(scheme)
        fn, kw = ROUTINGS.resolve(rspec)   # validate before building topo
        ctx = RoutingCtx(topo=self.topology(tspec),
                         topo_key=TOPOLOGIES.canonical(tspec),
                         seed=int(seed), stack=self._stack_memo,
                         device=self.device)
        return fn(ctx, **kw)

    def workload(self, topo: SpecLike, pattern: SpecLike,
                 seed: int = 0) -> FlowWorkload:
        tspec = topo_spec(topo)
        pspec = Spec.coerce(pattern)
        fn, kw = TRAFFIC.resolve(pspec)
        t = self.topology(tspec)
        return self._memo(
            ("workload", TOPOLOGIES.canonical(tspec),
             TRAFFIC.canonical(pspec), int(seed)),
            lambda: fn(t, int(seed), self.device, **kw))

    def fabric(self, topo: SpecLike, n_layers: int = 9, rho: float = 0.6,
               seed: int = 0, layer_scheme: str = "rand", n_tables: int = 8,
               line_rate: float = 12.5e9, flowlet_quanta: int = 32):
        """A ClusterFabric sharing this session's cached routing stacks."""
        from ..dist.fabric import ClusterFabric

        tspec = topo_spec(topo)
        t = self.topology(tspec)
        tkey = TOPOLOGIES.canonical(tspec)
        # Same key tuples as catalog._layer_stack/_minimal_tables (incl.
        # the stack_rep_key suffix) so fabric cells share the transport
        # cells' stacks.
        layers = self._stack_memo(
            ("layers", tkey, layer_scheme, int(n_layers), float(rho),
             int(seed)) + stack_rep_key(t),
            lambda: build_layers(t, int(n_layers), float(rho),
                                 scheme=layer_scheme, seed=int(seed),
                                 device=self.device))
        tables = self._stack_memo(
            ("tables", tkey, int(n_tables), int(seed)) + stack_rep_key(t),
            lambda: ecmp_routing(t, n_tables=int(n_tables), seed=int(seed),
                                 device=self.device))
        key = ("fabric", tkey, layer_scheme, int(n_layers), float(rho),
               int(seed), int(n_tables), float(line_rate),
               int(flowlet_quanta))
        return self._memo(key, lambda: ClusterFabric(
            t, n_layers=int(n_layers), rho=float(rho), seed=int(seed),
            layer_scheme=layer_scheme, n_tables=int(n_tables),
            line_rate=float(line_rate), flowlet_quanta=int(flowlet_quanta),
            layers=layers, ecmp=tables, device=self.device))

    def bundle_fabric(self, topo: SpecLike, scheme: SpecLike, seed: int = 0,
                      line_rate: float = 12.5e9, flowlet_quanta: int = 32):
        """A ClusterFabric whose candidate paths are exactly the given
        routing scheme's stack — 'minimal(...)' cells are evaluated over
        their minimal-only layers, not a default FatPaths stack.  Both
        fabric sides point at the bundle's stack; only the side matching
        the scheme's balancing mode is meaningful."""
        from ..dist.fabric import ClusterFabric

        tspec = topo_spec(topo)
        rspec = Spec.coerce(scheme)
        bundle = self.routing(tspec, rspec, seed=seed)
        lr = bundle.routing
        key = ("fabric_cell", TOPOLOGIES.canonical(tspec),
               ROUTINGS.canonical(rspec), int(seed), float(line_rate),
               int(flowlet_quanta))
        return self._memo(key, lambda: ClusterFabric(
            self.topology(tspec), n_layers=lr.n_layers, rho=lr.rho,
            seed=int(seed), line_rate=float(line_rate),
            flowlet_quanta=int(flowlet_quanta), layers=lr, ecmp=lr,
            device=self.device))

    # ---- cell execution ------------------------------------------------------
    def resolve(self, spec: ExperimentSpec) -> ResolvedCell:
        return ResolvedCell(
            spec=spec,
            topo=self.topology(spec.topo),
            bundle=self.routing(spec.topo, spec.routing, seed=spec.seed),
            workload=self.workload(spec.topo, spec.pattern, seed=spec.seed))

    def run(self, topo, routing: Optional[SpecLike] = None,
            pattern: Optional[SpecLike] = None,
            evaluator: SpecLike = "transport", seed: int = 0) -> RunResult:
        """Evaluate one cell; accepts an ExperimentSpec or the four axes."""
        if isinstance(topo, ExperimentSpec):
            if (routing is not None or pattern is not None
                    or Spec.coerce(evaluator) != Spec("transport")
                    or seed != 0):
                raise ValueError(
                    "run(ExperimentSpec) takes no other arguments; "
                    "dataclasses.replace the spec instead")
            spec = topo
        else:
            spec = ExperimentSpec(topo=topo_spec(topo),
                                  routing=Spec.coerce(routing),
                                  pattern=Spec.coerce(pattern),
                                  evaluator=Spec.coerce(evaluator),
                                  seed=int(seed))
        fn, kw = EVALUATORS.resolve(spec.evaluator)
        t0 = time.perf_counter()
        pre = self.stats_snapshot()
        cell = self.resolve(spec)
        metrics, meta = fn(self, cell, **kw)
        wall = time.perf_counter() - t0
        return self.finish_result(spec, cell, metrics, meta, pre, wall)

    # Execution-bookkeeping counters snapshotted around each cell so the
    # per-cell build-vs-simulate split can be attributed.
    _SNAPSHOT_KEYS = ("build_wall_s", "build_device_s", "stack_build",
                      "stack_hit")

    def stats_snapshot(self) -> Dict[str, float]:
        return {k: self.stats[k] for k in self._SNAPSHOT_KEYS}

    def finish_result(self, spec: ExperimentSpec, cell: ResolvedCell,
                      metrics: Dict[str, float], ev_meta: Dict[str, Any],
                      pre: Dict[str, float], wall: float,
                      extra_meta: Optional[Dict[str, Any]] = None,
                      post: Optional[Dict[str, float]] = None) -> RunResult:
        """Assemble the canonical :class:`RunResult` for one evaluated
        cell (the same record the JAX package emits).  Both engines, the
        sequential loop and the batched one, go through this.  ``post``
        closes the cell's build-accounting window when other cells have
        been built since (the batched engine resolves every cell before
        it simulates any)."""
        post = post if post is not None else self.stats_snapshot()
        meta = {"n_routers": cell.topo.n_routers,
                "n_endpoints": cell.topo.n_endpoints,
                "n_flows": int(cell.workload.n_flows),
                # build-vs-simulate split for this cell's artifacts
                "build_s": post["build_wall_s"] - pre["build_wall_s"],
                "build_device_s": (post["build_device_s"]
                                   - pre["build_device_s"]),
                "cache_builds": int(post["stack_build"]
                                    - pre["stack_build"]),
                "cache_hits": int(post["stack_hit"]
                                  - pre["stack_hit"]),
                **table_meta(cell.bundle), **ev_meta,
                **(extra_meta or {})}
        return RunResult(
            topo=spec.topo.format(), routing=spec.routing.format(),
            pattern=spec.pattern.format(), evaluator=spec.evaluator.format(),
            seed=spec.seed, metrics=metrics, meta=meta, wall_s=wall)

    def grid(self, topos: Sequence[SpecLike], routings: Sequence[SpecLike],
             patterns: Sequence[SpecLike],
             evaluators: Sequence[SpecLike] = ("transport",),
             seeds: Iterable[int] = (0,)) -> List[ExperimentSpec]:
        """The grid's cells in canonical order (topo-major nesting)."""
        return [ExperimentSpec(topo=topo_spec(t), routing=Spec.coerce(r),
                               pattern=Spec.coerce(p),
                               evaluator=Spec.coerce(e), seed=int(s))
                for t in topos for r in routings for p in patterns
                for e in evaluators for s in seeds]

    def sweep(self, topos: Sequence[SpecLike], routings: Sequence[SpecLike],
              patterns: Sequence[SpecLike],
              evaluators: Sequence[SpecLike] = ("transport",),
              seeds: Iterable[int] = (0,),
              callback: Optional[Callable[[RunResult], None]] = None,
              devices: Optional[int] = None,
              checkpoint_dir: Optional[str] = None) -> List[RunResult]:
        """Run the full grid through this session's caches.

        ``devices`` or ``checkpoint_dir`` routes the grid through the
        batched engine (:func:`repro_torch.experiments.dist_sweep
        .dist_sweep`): cells bucketed by shape, each bucket's (cell,
        sim-seed) elements one union scan, split over ``devices``.
        ``devices=1`` runs the same engine on this session's device.
        Results equal this sequential path's either way;
        ``checkpoint_dir`` makes the sweep resumable cell by cell."""
        if devices is not None or checkpoint_dir is not None:
            from .dist_sweep import dist_sweep
            return dist_sweep(
                self, self.grid(topos, routings, patterns, evaluators, seeds),
                devices=devices, checkpoint_dir=checkpoint_dir,
                callback=callback)
        results: List[RunResult] = []
        for spec in self.grid(topos, routings, patterns, evaluators, seeds):
            rr = self.run(spec)
            if callback is not None:
                callback(rr)
            results.append(rr)
        return results
