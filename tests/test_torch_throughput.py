"""The §6.4 MAT LP and its greedy rounding: the port against the JAX
package on the same cells, at rtol 0.  The candidate paths must be the
reference's path for path and in order, since the LP's matrices (and so
HiGHS' answer and status) follow them entry for entry; and every usable
(demand, layer) is walked in one batched walk, never one walk a pair."""

import dataclasses

import numpy as np
import pytest

from repro.core import throughput as JTH
from repro.experiments import Session as JSession
from repro.experiments.results import compare_results
from repro_torch import interop
from repro_torch.core import paths, throughput
from repro_torch.experiments import RunResult, Session

TOPOS = ["clique(k=6)", "sf"]
SCHEMES = ["fatpaths(n_layers=9,rho=0.6)", "ecmp", "minimal(n_layers=3)"]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def sessions():
    return JSession(), Session(device="cpu")


def _cell(sessions, topo, scheme, pattern="permutation", seed=0):
    js, ts = sessions
    return (js.routing(topo, scheme, seed=seed).routing,
            js.workload(topo, pattern, seed=seed),
            ts.routing(topo, scheme, seed=seed).routing,
            ts.workload(topo, pattern, seed=seed))


def _handed_over(lr, t_lr):
    """The reference's stack carried into the port through interop."""
    return interop.routing_from_arrays(t_lr.topo, _fields(lr), "cpu")


@pytest.mark.parametrize("pattern", ["permutation", "uniform", "shuffle",
                                     "adversarial"])
def test_router_demands_equal(sessions, pattern):
    js, ts = sessions
    wl, t_wl = js.workload("sf", pattern), ts.workload("sf", pattern)
    exp = JTH.router_demands(wl, 50)
    got = throughput.router_demands(t_wl, 50)
    assert list(got.items()) == list(exp.items())


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_candidate_paths_equal_path_for_path(sessions, topo, scheme):
    lr, wl, t_lr, t_wl = _cell(sessions, topo, scheme)
    demands = JTH.router_demands(wl, lr.topo.n_routers)
    exp = JTH._candidate_paths(lr, demands, 16)
    got = throughput._candidate_paths(t_lr, demands, 16)
    assert got == exp
    # a hop budget below the paths' length cuts them as the reference does
    assert throughput._candidate_paths(t_lr, demands, 1) == \
        JTH._candidate_paths(lr, demands, 1)


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_mat_equal_on_handed_over_and_own_stacks(sessions, topo, scheme):
    lr, wl, t_lr, t_wl = _cell(sessions, topo, scheme, "adversarial")
    exp_lp = dataclasses.asdict(JTH.mat_lp(lr, wl))
    exp_single = dataclasses.asdict(JTH.mat_single_layer(lr, wl))
    for stack in (_handed_over(lr, t_lr), t_lr):
        assert dataclasses.asdict(throughput.mat_lp(stack, t_wl)) == exp_lp
        assert dataclasses.asdict(
            throughput.mat_single_layer(stack, t_wl)) == exp_single


def test_mat_capacity_and_hops_equal(sessions):
    lr, wl, t_lr, t_wl = _cell(sessions, "sf", SCHEMES[0], "uniform")
    for kw in ({"capacity": 2.5}, {"max_hops": 3}, {"max_hops": 2}):
        assert dataclasses.asdict(throughput.mat_lp(t_lr, t_wl, **kw)) == \
            dataclasses.asdict(JTH.mat_lp(lr, wl, **kw)), kw
        assert dataclasses.asdict(
            throughput.mat_single_layer(t_lr, t_wl, **kw)) == \
            dataclasses.asdict(JTH.mat_single_layer(lr, wl, **kw)), kw


def test_empty_and_pathless_cells_equal(sessions):
    lr, wl, t_lr, t_wl = _cell(sessions, "sf", "ecmp")
    # no demand: every flow stays on its own router
    same = dict(_fields(t_wl), dst_router=t_wl.src_router)
    j_same = dataclasses.replace(wl, dst_router=wl.src_router)
    t_same = interop.workload_from_arrays(same)
    for fn, jfn in ((throughput.mat_lp, JTH.mat_lp),
                    (throughput.mat_single_layer, JTH.mat_single_layer)):
        assert dataclasses.asdict(fn(t_lr, t_same)) == \
            dataclasses.asdict(jfn(lr, j_same))
    # no usable layer anywhere
    j_dark = dataclasses.replace(lr, reach=np.zeros_like(np.asarray(lr.reach)))
    t_dark = _handed_over(j_dark, t_lr)
    got = throughput.mat_lp(t_dark, t_wl)
    assert dataclasses.asdict(got) == dataclasses.asdict(JTH.mat_lp(j_dark, wl))
    assert got.status == "no-paths"
    assert dataclasses.asdict(throughput.mat_single_layer(t_dark, t_wl)) == \
        dataclasses.asdict(JTH.mat_single_layer(j_dark, wl))


def test_one_batched_walk_per_stack(sessions, monkeypatch):
    """Every usable (demand, layer) of a cell is walked in one call of
    ``paths.walk_paths_layers``, whatever the number of demands."""
    _, ts = sessions
    t_lr = ts.routing("sf", SCHEMES[0]).routing
    t_wl = ts.workload("sf", "permutation")
    calls = []
    real = paths.walk_paths_layers

    def counted(*args, **kw):
        calls.append(len(args[1]))
        return real(*args, **kw)

    monkeypatch.setattr(paths, "walk_paths_layers", counted)
    demands = throughput.router_demands(t_wl, 50)
    plist = throughput._candidate_paths(t_lr, demands, 16)
    assert len(calls) == 1 and len(demands) > 100
    assert calls[0] >= sum(len(p) for p in plist) > len(demands)
    ts.run("sf", SCHEMES[0], "permutation", "mat")
    assert len(calls) == 3          # the LP's walk and the greedy's


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_mat_cell_equals_reference(sessions, topo, scheme):
    js, ts = sessions
    ref = js.run(topo, scheme, "permutation", "mat")
    port = ts.run(topo, scheme, "permutation", "mat")
    assert isinstance(port, RunResult)
    assert compare_results([ref], [port], rtol=0) == []
    assert port.meta["lp_status"] == ref.meta["lp_status"] == "optimal"
    assert port.metrics["n_paths"] >= port.metrics["n_demands"] > 0


def test_mat_cell_blocked_engine_walks_compressed_tables(monkeypatch):
    """Under the blocked engine the stack carries compressed tables, and
    the walk reads them: the cell still equals the reference's."""
    monkeypatch.setenv("REPRO_PATH_ENGINE", "blocked")
    js, ts = JSession(), Session(device="cpu")
    spec = ("sf", SCHEMES[0], "adversarial", "mat(max_hops=8)")
    port = ts.run(*spec)
    assert ts.routing("sf", SCHEMES[0]).routing.compressed is not None
    assert compare_results([js.run(*spec)], [port], rtol=0) == []
