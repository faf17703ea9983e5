"""Mid-run faults, link churn and loss recovery: Session.run in the JAX
package (called live, never its goldens) and in the port on the same
cells must give identical RunResults (compare_results at rtol 0), and
every simulation's per-flow lanes and per-step curves must be bitwise
equal: ``depart_step``, ``fct``, ``delivered``, ``retrans_bytes``,
``goodput_steps`` and ``stalled_steps``."""

import contextlib

import numpy as np
import pytest

from repro.experiments import Session as JSession
from repro.experiments import catalog as j_catalog
from repro.experiments.results import compare_results
from repro_torch.experiments import Session
from repro_torch.experiments import catalog as t_catalog

CLIQUE = "clique(k=6)"
BIG = "permutation(flow_size=1000000000.0)"
DEATH = "failures(of={},rate=0.2,down_step=10)"
FLAP = "churn(of={},rate=0.3,pattern={},mtbf=20,mttr=10)"
FP = "fatpaths(n_layers=9)"
SF_FP = "fatpaths(n_layers=9,rho=0.6)"

CELLS = [(CLIQUE, DEATH.format(r), "uniform",
          f"transport(steps=60,transport={t},recovery={rec})")
         for r in (FP, "ecmp(n=4)") for t in ("ndp", "tcp", "dctcp")
         for rec in ("off", "on")]
CELLS += [
    (CLIQUE, FLAP.format(FP, "flap"), BIG,
     "transport(steps=100,transport=dctcp,recovery=on)"),
    (CLIQUE, FLAP.format(FP, "rolling"), BIG,
     "transport(steps=100,transport=tcp,recovery=on)"),
    (CLIQUE, FLAP.format("ecmp(n=4)", "repair"), BIG, "transport(steps=100)"),
    # churn over a mid-run death: both lanes in one scan
    (CLIQUE, FLAP.format(DEATH.format(FP), "flap"), BIG,
     "transport(steps=100,transport=dctcp,recovery=on)"),
    # 65 flows: the rollback's last 65 mod 8 rows round as XLA:CPU's
    # scalar remainder does
    ("sf", f"failures(of={SF_FP},rate=0.1,down_step=10)",
     "permutation(flow_size=268435456,frac=0.37)",
     "transport(steps=60,transport=tcp,recovery=on)"),
    # the three evaluators; sf(q=5) has more than 32 flows, so the
    # goodput curve's sums run XLA:CPU's windowed order
    (CLIQUE, FLAP.format(FP, "flap"), BIG, "availability(steps=100)"),
    ("sf", f"failures(of={SF_FP},rate=0.05,down_step=20)",
     "permutation(flow_size=268435456)", "recovery(steps=100,transport=dctcp)"),
    ("sf", f"failures(of=ecmp,rate=0.05,down_step=20)",
     "permutation(flow_size=268435456)", "recovery(steps=100)"),
    ("sf", SF_FP, "permutation", "degradation(steps=100)"),
]
LANES = ("depart_step", "fct", "delivered", "retrans_bytes", "goodput_steps",
         "stalled_steps")


@contextlib.contextmanager
def _recording(catalog, sims):
    fn = catalog.simulate_seeds

    def rec(*args, **kw):
        sims.append(fn(*args, **kw))
        return sims[-1]

    catalog.simulate_seeds = rec
    try:
        yield
    finally:
        catalog.simulate_seeds = fn


@pytest.fixture(scope="module")
def sessions():
    return JSession(), Session(device="cpu")


@pytest.mark.parametrize("topo,routing,pattern,evaluator", CELLS)
def test_fault_cell_matches_reference(sessions, topo, routing, pattern,
                                      evaluator):
    js, ts = sessions
    j_sims, t_sims = [], []
    with _recording(j_catalog, j_sims):
        ref = js.run(topo, routing, pattern, evaluator)
    with _recording(t_catalog, t_sims):
        port = ts.run(topo, routing, pattern, evaluator)
    assert compare_results([ref], [port], rtol=0) == []
    assert len(t_sims) == len(j_sims) > 0
    recovery = "recovery=on" in evaluator or evaluator.startswith(
        ("recovery", "availability"))
    for js_, ts_ in zip(j_sims, t_sims):
        for j, t in zip(js_, ts_):
            for name in LANES:
                exp, got = getattr(j, name), getattr(t, name)
                assert (got is None) == (exp is None), name
                if exp is not None:
                    assert got.dtype == np.asarray(exp).dtype, name
                    np.testing.assert_array_equal(
                        np.asarray(got).view(np.uint8),
                        np.asarray(exp).view(np.uint8), err_msg=name)
            assert (t.retrans_bytes is not None) == recovery
    if "transport(" in evaluator and "down_step" in routing:
        assert port.meta["link_down_step"] == 10
    if evaluator.startswith("recovery"):
        assert port.metrics["dip_frac"] > 0
        assert len(port.meta["goodput_curve"]) > 1
