"""Dynamic traffic against the JAX package: the arrival processes and
their accounting (bitwise), the scan's activation lane on the same cell
carried across as numpy, and the open-loop catalog cells (load, incast
with the outcast evaluator, anycast) at rtol 0."""

import dataclasses

import numpy as np
import pytest
import jax

from repro.core import arrivals as j_arrivals
from repro.core import layers as j_layers
from repro.core import topology as j_topo
from repro.core import traffic as j_traffic
from repro.core import transport as j_transport
from repro.experiments import Session as JSession
from repro.experiments.results import compare_results
from repro_torch import interop, prng
from repro_torch.core import arrivals, topology, transport
from repro_torch.experiments import Session

LANES = ("remaining", "hops", "depart_step", "sent_acc", "w_acc", "layer")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("n", [1, 100, 4097])
@pytest.mark.parametrize("seed", [0, 7])
def test_flow_uniforms_bitwise(seed, n):
    np.testing.assert_array_equal(
        arrivals.flow_uniforms(prng.PRNGKey(seed, "cpu"), n),
        j_arrivals.flow_uniforms(jax.random.PRNGKey(seed), n))


@pytest.mark.parametrize("process", ["poisson", "pareto"])
@pytest.mark.parametrize("rate", [0.05, 2.7, 31.0])
def test_activation_steps_bitwise_and_prefix_stable(process, rate):
    kw = dict(rate=rate, process=process, shape=1.3, bound=32.0)
    got = arrivals.activation_steps(prng.PRNGKey(11, "cpu"), 3000, **kw)
    exp = j_arrivals.activation_steps(jax.random.PRNGKey(11), 3000, **kw)
    assert got.dtype == exp.dtype == np.int32
    np.testing.assert_array_equal(got, exp)
    for n1 in (1, 999, 2048):
        np.testing.assert_array_equal(
            arrivals.activation_steps(prng.PRNGKey(11, "cpu"), n1, **kw),
            got[:n1])
    np.testing.assert_array_equal(
        arrivals.interarrival_gaps(prng.PRNGKey(3, "cpu"), 500, 2.5,
                                   process=process),
        j_arrivals.interarrival_gaps(jax.random.PRNGKey(3), 500, 2.5,
                                     process=process))


def test_arrival_validation_matches():
    key = prng.PRNGKey(0, "cpu")
    assert arrivals.activation_steps(key, 0, rate=1.0).shape == (0,)
    with pytest.raises(ValueError, match="rate"):
        arrivals.activation_steps(key, 4, rate=0.0)
    with pytest.raises(ValueError, match="process"):
        arrivals.interarrival_gaps(key, 4, 1.0, process="uniform")
    with pytest.raises(ValueError, match="Pareto"):
        arrivals.interarrival_gaps(key, 4, 1.0, process="pareto", bound=0.5)
    with pytest.raises(ValueError, match="incast"):
        arrivals.incast_schedule(4, 0, 3)


@pytest.mark.parametrize("topo", ["sf5", "df3", "clique"])
def test_schedules_and_accounting_equal(topo):
    build = {"sf5": lambda m: m.slim_fly(5), "df3": lambda m: m.dragonfly(3),
             "clique": lambda m: m.clique(6)}[topo]
    jt, tt = build(j_topo), build(topology)
    for samples, seed in ((32, 0), (5, 3)):
        assert arrivals.bisection_bandwidth(tt, samples=samples, seed=seed) \
            == j_arrivals.bisection_bandwidth(jt, samples=samples, seed=seed)
    for args in ((10, 3, 4), (33, 8, 64), (5, 5, 0)):
        np.testing.assert_array_equal(arrivals.incast_schedule(*args),
                                      j_arrivals.incast_schedule(*args))
    steps = arrivals.activation_steps(prng.PRNGKey(2, "cpu"), 700, rate=1.7)
    sizes = np.random.default_rng(2).random(700) * 1e6
    for dt in (10e-6, 3e-7):
        np.testing.assert_array_equal(arrivals.activation_starts(steps, dt),
                                      j_arrivals.activation_starts(steps, dt))
        assert arrivals.offered_gbs(sizes, steps, dt) == \
            j_arrivals.offered_gbs(sizes, steps, dt)
        assert arrivals.offered_load(sizes, steps, dt, 1e11) == \
            j_arrivals.offered_load(sizes, steps, dt, 1e11)
    assert arrivals.offered_gbs(np.zeros(0), np.zeros(0), 1e-5) == 0.0


@pytest.fixture(scope="module")
def dyn_cell():
    """sf(q=5) adversarial flows with staggered activations that run past
    the first scan chunks, from the JAX package, carried across."""
    topo = j_topo.slim_fly(5)
    wl = j_traffic.make_workload(topo, "adversarial", n_rounds=2,
                                 randomize=False, seed=1)
    steps = j_arrivals.activation_steps(jax.random.PRNGKey(4), wl.n_flows,
                                        rate=2.0, process="pareto")
    wl = dataclasses.replace(wl, active_step=steps,
                             start=j_arrivals.activation_starts(steps, 10e-6))
    routings = {"fatpaths": j_layers.build_layers(topo, 4, 0.6, seed=2),
                "ecmp": j_transport.ecmp_routing(topo, n_tables=4, seed=2)}
    routings["letflow"] = routings["ecmp"]
    t_topo = interop.topology_from_arrays(_fields(topo))
    t_wl = interop.workload_from_arrays(_fields(wl))
    t_routings = {k: interop.routing_from_arrays(t_topo, _fields(v), "cpu")
                  for k, v in routings.items()}
    return topo, wl, routings, t_topo, t_wl, t_routings


@pytest.mark.parametrize("balancing", ["ecmp", "letflow", "fatpaths"])
@pytest.mark.parametrize("transport_name", ["ndp", "tcp", "dctcp"])
def test_scan_activation_lane_bitwise(dyn_cell, transport_name, balancing):
    topo, wl, routings, t_topo, t_wl, t_routings = dyn_cell
    cfg = j_transport.SimConfig(transport=transport_name, balancing=balancing,
                                n_steps=300, horizon_chunk=32)
    jarrs, static = j_transport.prepare(topo, routings[balancing], wl, cfg)
    ref = jax.device_get(j_transport._run_scan(
        jarrs, jax.random.PRNGKey(7), cfg, static))
    t_cfg = interop.config_from_dict(dataclasses.asdict(cfg))
    arrs, t_static = transport.prepare(t_topo, t_routings[balancing], t_wl,
                                       t_cfg, device="cpu")
    np.testing.assert_array_equal(arrs["active_at"].numpy(),
                                  np.asarray(jarrs["active_at"]))
    out = transport._run_scan(arrs, prng.PRNGKey(7, "cpu"), t_cfg, t_static)
    for k in LANES:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(out["horizon_chunks"]) == int(ref["horizon_chunks"])
    dep = out["depart_step"].numpy()
    assert (dep >= 0).any()
    assert (dep[dep >= 0] >= wl.active_step[dep >= 0]).all()


@pytest.mark.parametrize("transport_name", ["ndp", "tcp"])
def test_all_zero_activation_is_the_static_result(dyn_cell, transport_name):
    _, _, _, t_topo, t_wl, t_routings = dyn_cell
    cfg = transport.SimConfig(transport=transport_name, n_steps=200)
    static = dataclasses.replace(t_wl, active_step=None, start=np.zeros(
        t_wl.n_flows))
    zero = dataclasses.replace(static, active_step=np.zeros(t_wl.n_flows,
                                                            np.int32))
    base = transport.simulate(t_topo, t_routings["fatpaths"], static, cfg,
                              device="cpu")
    dyn = transport.simulate(t_topo, t_routings["fatpaths"], zero, cfg,
                             device="cpu")
    for name in ("fct", "delivered", "finished", "depart_step"):
        np.testing.assert_array_equal(getattr(dyn, name),
                                      getattr(base, name), err_msg=name)
    assert dyn.link_util_mean == base.link_util_mean


DYN_CELLS = [
    ("sf", "fatpaths(n_layers=9,rho=0.6)", "load(window=24)",
     "transport(steps=400)"),
    ("sf", "ecmp", "load(level=0.8,window=16,process=pareto)",
     "transport(steps=400,transport=tcp)"),
    ("sf", "fatpaths(n_layers=9,rho=0.6)", "incast", "outcast(steps=400)"),
    ("sf", "letflow", "incast(fan_in=4,waves=3,acks=0)",
     "outcast(steps=300,transport=dctcp)"),
    ("sf", "fatpaths(n_layers=9,rho=0.6)", "anycast(policy=closest)",
     "transport(steps=400)"),
    ("sf", "ecmp", "anycast(policy=farthest,window=0)",
     "transport(steps=400)"),
]


@pytest.fixture(scope="module")
def sessions():
    return JSession(), Session(device="cpu")


@pytest.mark.parametrize("topo,routing,pattern,evaluator", DYN_CELLS)
def test_dynamic_cells_match_reference(sessions, topo, routing, pattern,
                                       evaluator):
    js, ts = sessions
    ref = js.run(topo, routing, pattern, evaluator)
    got = ts.run(topo, routing, pattern, evaluator)
    assert compare_results([ref], [got], rtol=0) == []
    assert got.metrics["finished"] > 0
    assert got.meta["offered_gbs"] == ref.meta["offered_gbs"]
