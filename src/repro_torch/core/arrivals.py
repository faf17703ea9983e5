"""Open-loop arrival processes: continuous traffic for the flow simulator.

The paper's headline claims (§7: throughput/latency *under load*) are
about fabrics serving a continuous stream of flows, not a one-shot batch
that decays to idle.  This module is the arrival-process subsystem that
feeds the transport scan's dynamic-traffic lane
(:mod:`repro_torch.core.transport`, the ``active_at`` operand and
``depart_step`` state channel): per-flow *activation steps* for Poisson
and bounded-Pareto interarrival processes, synchronized incast wave
schedules, offered-load accounting, and a bisection-bandwidth estimate
that load levels are expressed against.

Determinism contract (the property every batch engine rests on):

* every random draw depends only on ``(key, flow)`` — flow ``i``'s
  uniform comes from ``fold_in(key, i)`` (:mod:`repro_torch.prng`, the
  JAX package's threefry stream bit for bit), exactly like the transport
  scan's per-flow step draws depend only on ``(key, flow, step)`` — so
  growing the flow count (batch padding, or just building a longer
  stream) never changes an earlier flow's draw;
* the interarrival cumsum runs on the host in float64 (``np.cumsum`` is
  a strictly sequential accumulation), so activation steps are
  *prefix-stable*: ``activation_steps(key, n2)[:n1] ==
  activation_steps(key, n1)`` bit for bit for any ``n2 >= n1``.

Conceptually the simulator's flow axis is a ring buffer of flow slots:
a "slot" is occupied from its activation step (``active_at``) until the
flow departs (``depart_step``).  Because the batched scan needs a static
flow axis, the ring is unrolled — every arrival gets its own row up
front and the activation/departure lanes gate when the row participates
in the water-filling step.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng

__all__ = ["flow_uniforms", "interarrival_gaps", "activation_steps",
           "incast_schedule", "offered_load", "offered_gbs",
           "bisection_bandwidth", "activation_starts"]


def flow_uniforms(key: torch.Tensor, n: int) -> np.ndarray:
    """(n,) float64 U[0,1) draws where draw ``i`` depends ONLY on
    ``(key, i)`` — the padding-safe derivation (see module docstring):
    one batched ``fold_in`` over ``arange(n)`` and one scalar uniform per
    key, on the key's device.  Returned as a host array: everything
    downstream is float64 host math, keeping activation steps independent
    of the device."""
    keys = prng.fold_in(key, torch.arange(n, device=key.device))
    return prng.uniform(keys, ()).double().cpu().numpy()


def _bounded_pareto(u: np.ndarray, shape: float, bound: float) -> np.ndarray:
    """Inverse-CDF bounded Pareto on [1, bound] with tail index ``shape``,
    normalized to mean 1 (so a gap stream keeps its configured rate
    while individual gaps stay heavy-tailed => bursty arrival clumps)."""
    a, h = float(shape), float(bound)
    if a <= 0 or h <= 1:
        raise ValueError(f"bounded Pareto needs shape > 0, bound > 1 "
                         f"(got shape={a}, bound={h})")
    x = (1.0 - u * (1.0 - h ** -a)) ** (-1.0 / a)
    if abs(a - 1.0) < 1e-9:
        mean = np.log(h) / (1.0 - 1.0 / h)
    else:
        mean = (a / (a - 1.0)) * (1.0 - h ** (1.0 - a)) / (1.0 - h ** -a)
    return x / mean


def interarrival_gaps(key, n: int, mean_steps: float,
                      process: str = "poisson", shape: float = 1.5,
                      bound: float = 64.0) -> np.ndarray:
    """(n,) interarrival gaps in (fractional) steps, mean ``mean_steps``.

    ``poisson`` draws exponential gaps (a Poisson arrival process);
    ``pareto`` draws bounded-Pareto gaps (heavy-tailed interarrivals —
    the bursty/wave regime).  Gap ``i`` is a pure function of
    ``(key, i)``; see the module docstring's determinism contract."""
    u = np.clip(flow_uniforms(key, n), 1e-12, 1.0 - 1e-12)
    if process == "poisson":
        gaps = -np.log1p(-u)
    elif process == "pareto":
        gaps = _bounded_pareto(u, shape, bound)
    else:
        raise ValueError(f"unknown arrival process {process!r}; "
                         "choose 'poisson' or 'pareto'")
    return gaps * float(mean_steps)


def activation_steps(key, n: int, *, rate: float, process: str = "poisson",
                     shape: float = 1.5, bound: float = 64.0) -> np.ndarray:
    """(n,) int32 activation step per flow for an open-loop stream of
    ``rate`` flow arrivals per simulation step (flow 0 arrives at step
    0; flow i at the floor of the gap cumsum).  Prefix-stable in ``n``
    and deterministic in ``(key, flow)`` — the contract the distributed
    sweep engine's bit-identity guarantee extends over."""
    if n <= 0:
        return np.zeros(0, dtype=np.int32)
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0 (got {rate})")
    gaps = interarrival_gaps(key, n, 1.0 / float(rate), process=process,
                             shape=shape, bound=bound)
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return np.floor(t).astype(np.int32)


def incast_schedule(n_flows: int, fan_in: int, wave_period: int
                    ) -> np.ndarray:
    """(n_flows,) int32 synchronized incast wave schedule: flows arrive
    in waves of ``fan_in``, wave ``w`` activating at step
    ``w * wave_period`` (all senders of a wave fire simultaneously —
    the TCP-incast/outcast stressor)."""
    if fan_in <= 0 or wave_period < 0:
        raise ValueError("incast needs fan_in > 0 and wave_period >= 0")
    return ((np.arange(n_flows) // int(fan_in))
            * int(wave_period)).astype(np.int32)


def offered_load(sizes: np.ndarray, steps: np.ndarray, dt: float,
                 capacity: float) -> float:
    """Realized offered load of an arrival stream as a fraction of
    ``capacity`` (bytes/s): total bytes over the realized arrival window
    ``(max step + 1) * dt``.  For a stream built by
    :func:`activation_steps` at rate ``level * capacity * dt / size``
    this converges to ``level`` as the flow count grows."""
    sizes = np.asarray(sizes, dtype=np.float64)
    if sizes.size == 0 or capacity <= 0:
        return 0.0
    window_s = (float(np.max(steps)) + 1.0) * float(dt)
    return float(sizes.sum() / window_s / float(capacity))


def offered_gbs(sizes: np.ndarray, steps: np.ndarray, dt: float) -> float:
    """Offered byte rate of a dynamic workload in GB/s (host float64 —
    identical whichever engine computes it, so it is safe in RunResult
    meta that the engine-identity diff compares exactly)."""
    sizes = np.asarray(sizes, dtype=np.float64)
    if sizes.size == 0:
        return 0.0
    window_s = (float(np.max(steps)) + 1.0) * float(dt)
    return float(sizes.sum() / window_s / 1e9)


def bisection_bandwidth(topo, line_rate: float = 12.5e9, samples: int = 32,
                        seed: int = 0) -> float:
    """Estimated bisection bandwidth in bytes/s: the minimum, over
    ``samples`` seeded balanced router bipartitions, of the directed
    link count crossing the cut, times ``line_rate``.  An upper-bound
    sampling estimate (true bisection minimizes over ALL balanced cuts),
    deterministic in ``seed`` — good enough as the normalizer that
    ``load(level=...)`` sweeps express offered load against, and exact
    on symmetric topologies where every balanced cut is minimal.

    Each bipartition is drawn from its own ``default_rng((seed, i))``
    stream: sample i depends only on ``(seed, i)``, never on how many
    samples ran before it, so the estimate is stable across processes
    and across ``samples`` prefixes (the per-index keying contract the
    rest of the repo's PRNG draws follow)."""
    adj = np.asarray(topo.adj, dtype=bool)
    n = adj.shape[0]
    if n < 2:
        return float(line_rate)
    best = None
    for i in range(max(1, int(samples))):
        rng = np.random.default_rng((int(seed), i))
        side = np.zeros(n, dtype=bool)
        side[rng.permutation(n)[:n // 2]] = True
        cut = int(adj[side][:, ~side].sum() + adj[~side][:, side].sum())
        best = cut if best is None else min(best, cut)
    return float(max(best, 1)) * float(line_rate)


def activation_starts(steps: np.ndarray, dt: float) -> np.ndarray:
    """(F,) float64 start seconds matching the transport scan's own step
    clock: the scan compares ``start <= i * float32(dt)``, so starts are
    computed through the same float32 product — activation by the
    ``active_at`` lane and by the ``start`` lane then agree exactly on
    the activation step (no one-ulp disagreement)."""
    return (np.asarray(steps).astype(np.float32)
            * np.float32(dt)).astype(np.float64)
