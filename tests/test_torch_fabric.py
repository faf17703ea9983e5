"""The cluster-fabric model and the ring strides: the port against the JAX
package, at rtol 0.  The flows of every collective, the strides over a
grid of (n, k), the fabric's reports for each collective x scheme, the
``fabric`` cells, and the session's sharing of stacks with the fabric."""

import dataclasses

import numpy as np
import pytest

from repro.dist import collectives as JC
from repro.dist import fabric as JF
from repro.experiments import Session as JSession
from repro.experiments.results import compare_results
from repro_torch import interop
from repro_torch.core import paths
from repro_torch.dist import collectives, fabric
from repro_torch.experiments import Session

KINDS = ["all-reduce", "all-gather", "reduce-scatter", "collective-permute",
         "all-to-all", "all-to-one", "all-reduce-start"]
SCHEMES = ["fatpaths(n_layers=9,rho=0.6)", "ecmp", "minimal(n_layers=3)"]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def fabrics():
    """Each package's ClusterFabric on sf(q=5), built by the fabric itself
    (its own layer stack and ECMP tables)."""
    js, ts = JSession(), Session(device="cpu")
    return (JF.ClusterFabric(js.topology("sf"), n_layers=9, rho=0.6, seed=0),
            fabric.ClusterFabric(ts.topology("sf"), n_layers=9, rho=0.6,
                                 seed=0, device="cpu"))


@pytest.fixture(scope="module")
def sessions():
    return JSession(), Session(device="cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 5, 8])
@pytest.mark.parametrize("strides", [(1,), (1, 3), (1, 3, 5, 7)])
def test_collective_flows_equal(kind, n, strides):
    for nbytes in (1e6, 3):
        assert fabric.collective_flows(kind, n, nbytes, strides) == \
            JF.collective_flows(kind, n, nbytes, strides)


def test_collective_flows_unknown_kind_raises():
    for mod in (fabric, JF):
        with pytest.raises(ValueError, match="unknown collective kind"):
            mod.collective_flows("broadcast", 4, 1.0)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 6, 8, 12, 16, 30, 64, 97, 210])
def test_layer_strides_equal(n):
    for k in range(0, 9):
        got = collectives.layer_strides(n, k)
        assert got == JC.layer_strides(n, k)
        assert isinstance(got, tuple) and len(got) == k


def test_gini_equal():
    rng = np.random.default_rng(0)
    for x in (np.zeros(5), np.array([]), rng.random(7),
              rng.integers(0, 4, 40).astype(np.float64), np.ones(3)):
        got, exp = fabric._gini(x), JF._gini(x)
        assert got == exp and type(got) is type(exp)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scheme", ["fatpaths", "ecmp"])
def test_collective_time_equal(fabrics, kind, scheme):
    jfb, tfb = fabrics
    for n, strides in ((64, None), (50, (1, 3, 7))):
        exp = jfb.collective_time(kind, n, 1e9, scheme, strides)
        got = tfb.collective_time(kind, n, 1e9, scheme, strides)
        assert got.as_dict() == exp.as_dict()


def test_fabric_internals_equal(fabrics):
    jfb, tfb = fabrics
    assert tfb._max_hops == jfb._max_hops
    np.testing.assert_array_equal(tfb.ep2r, jfb.ep2r)
    with pytest.raises(ValueError, match="unknown scheme"):
        tfb.collective_time("all-reduce", 8, 1.0, "valiant")
    for scheme in ("fatpaths", "ecmp"):
        for s, t in ((0, 1), (3, 41), (49, 0), (7, 7)):
            got = tfb._pair_paths(scheme, s, t)
            exp = jfb._pair_paths(scheme, s, t)
            assert [p.tolist() for p in got] == [p.tolist() for p in exp]
            assert all(p.dtype == np.int64 for p in got)


def test_evaluate_flows_on_handed_over_stacks(sessions):
    """The reference's stacks carried over through interop give the
    reference's reports, with holes in the tables too."""
    js, _ = sessions
    topo = js.topology("sf")
    lr = js.routing("sf", SCHEMES[0]).routing
    ec = js.routing("sf", "ecmp").routing
    nh = np.array(lr.nh)
    nh[1, :, 5] = -1                      # a hole in one layer
    lr = dataclasses.replace(lr, nh=nh)
    t_topo = interop.topology_from_arrays(_fields(topo))
    jfb = JF.ClusterFabric(topo, layers=lr, ecmp=ec)
    tfb = fabric.ClusterFabric(
        t_topo, layers=interop.routing_from_arrays(t_topo, _fields(lr), "cpu"),
        ecmp=interop.routing_from_arrays(t_topo, _fields(ec), "cpu"))
    rng = np.random.default_rng(1)
    flows = [(int(a), int(b), float(c)) for a, b, c in zip(
        rng.integers(0, 400, 300), rng.integers(0, 400, 300),
        rng.random(300) * 1e6)]
    for scheme in ("fatpaths", "ecmp"):
        assert tfb.evaluate_flows(flows, scheme).as_dict() == \
            jfb.evaluate_flows(flows, scheme).as_dict()
    assert tfb.evaluate_flows([], "ecmp").as_dict() == \
        jfb.evaluate_flows([], "ecmp").as_dict()


def test_one_batched_walk_per_call_for_new_pairs(monkeypatch):
    ts = Session(device="cpu")
    fb = ts.fabric("sf")
    calls = []
    real = paths.walk_paths_layers

    def counted(*args, **kw):
        calls.append(len(args[1]))
        return real(*args, **kw)

    monkeypatch.setattr(paths, "walk_paths_layers", counted)
    fb.collective_time("all-to-all", 200, 1e9, "fatpaths")
    assert len(calls) == 1 and calls[0] > 50 * 49    # every pair, one walk
    fb.collective_time("all-to-all", 200, 2e9, "fatpaths")
    assert len(calls) == 1                           # all cached
    fb.collective_time("all-to-all", 200, 1e9, "ecmp")
    assert len(calls) == 2                           # the other stack


@pytest.mark.parametrize("topo", ["clique(k=6)", "sf"])
@pytest.mark.parametrize("scheme", SCHEMES + ["letflow"])
def test_fabric_cell_equals_reference(sessions, topo, scheme):
    js, ts = sessions
    for pattern, ev in (("permutation", "fabric"),
                        ("adversarial", "fabric(line_rate=1e9,quanta=4)")):
        ref = js.run(topo, scheme, pattern, ev)
        port = ts.run(topo, scheme, pattern, ev)
        assert compare_results([ref], [port], rtol=0) == []
        assert port.meta["fabric_scheme"] == ref.meta["fabric_scheme"]


def test_fabric_shares_session_layer_stack():
    s = Session(device="cpu")
    bundle = s.routing("clique(k=6)", "fatpaths(n_layers=9,rho=0.6)")
    fb = s.fabric("clique(k=6)", n_layers=9, rho=0.6)
    assert fb.layers is bundle.routing          # same object, not a rebuild
    assert s.stats["stack_build"] == 2          # layers + fabric's tables
    assert s.fabric("clique(k=6)") is fb
    assert fb.ecmp is s.routing("clique(k=6)", "ecmp").routing
    assert s.stats["stack_build"] == 2


def test_fabric_evaluator_uses_the_cells_own_stack():
    s = Session(device="cpu")
    rr = s.run("clique(k=6)", "minimal(n_layers=3)", "uniform", "fabric")
    # only the cell's minimal stack was built — no shadow FatPaths stack,
    # no unused ECMP table stack
    assert s.stats["stack_build"] == 1
    fb = s.bundle_fabric("clique(k=6)", "minimal(n_layers=3)")
    assert fb.layers is s.routing("clique(k=6)", "minimal(n_layers=3)").routing
    assert rr.meta["fabric_scheme"] == "fatpaths"   # flowlet balancing
    assert fb.layers.n_layers == 3
