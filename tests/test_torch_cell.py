"""The whole slice: Session.run in the JAX package and in the port on the
same cells must give identical RunResults (compare_results at rtol 0),
the port's CLI must run, list and diff, and no module of the port may
import JAX or the JAX package."""

import json
import re
from pathlib import Path

import pytest
import torch

from repro.experiments import Session as JSession
from repro.experiments.results import compare_results
from repro_torch.experiments import RunResult, Session
from repro_torch.experiments import __main__ as cli
from repro_torch.experiments.results import results_from_json

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("sf", r, p, "transport(steps=400)")
         for r in ("ecmp", "letflow", "fatpaths(n_layers=9,rho=0.6)")
         for p in ("permutation", "adversarial")]
CELLS.append(("sf", "fatpaths(n_layers=9,rho=0.6)", "permutation",
              "transport(steps=400,transport=tcp)"))
CELLS.append(("sf", "fatpaths(n_layers=9,rho=0.6,scheme=ksp)", "permutation",
              "transport(steps=400)"))
CELLS.append(("sf", "fatpaths(n_layers=9,rho=0.6,scheme=pi_min)",
              "permutation", "transport(steps=400)"))
CELLS.append(("sf", "fatpaths(n_layers=9,rho=0.6)", "load(window=32)",
              "transport(steps=400)"))
# Static damage (repair) and a mid-run death under the recovery evaluator.
CELLS.append(("sf", "failures(of=fatpaths(n_layers=9,rho=0.6),rate=0.05)",
              "permutation", "transport(steps=400)"))
CELLS.append(("sf", "failures(of=fatpaths(n_layers=9,rho=0.6),rate=0.05,"
              "down_step=10)", "permutation(flow_size=4194304)",
              "recovery(steps=200,transport=dctcp)"))
# XLA contracts the reference scan's sent_acc + d * s into one FMA; these
# two cells differ at rtol 0 unless the port rounds it once too.
CELLS += [(t, "fatpaths(n_layers=9,rho=0.6,scheme=spain)", "stencil",
           "transport(steps=400)") for t in ("xp", "jfeq")]


@pytest.fixture(scope="module")
def sessions():
    return JSession(), Session(device="cpu")


@pytest.mark.parametrize("topo,routing,pattern,evaluator", CELLS)
def test_session_run_matches_reference(sessions, topo, routing, pattern,
                                       evaluator):
    js, ts = sessions
    ref = js.run(topo, routing, pattern, evaluator)
    port = ts.run(topo, routing, pattern, evaluator)
    assert compare_results([ref], [port], rtol=0) == []
    assert port.metrics["finished"] > 0


def test_cli_run_list_diff(tmp_path, capsys):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    args = ["--topos", "df", "--schemes", "ecmp", "--patterns", "shuffle",
            "--quick", "--device", "cpu"]
    assert cli.main(["sweep", *args, "--json", str(a)]) == 0
    assert cli.main(["sweep", *args, "--json", str(b)]) == 0
    assert cli.main(["diff", str(a), str(b)]) == 0
    (rr,) = results_from_json(a.read_text())
    assert rr.topo == "df" and rr.meta["n_flows"] > 0
    assert cli.main(["run", "--topo", "sf", "--scheme", "ecmp", "--pattern",
                     "collide", "--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["pattern"] == "collide"
    assert cli.main(["list"]) == 0
    listed = capsys.readouterr().out
    assert "  mat(capacity=1.0, max_hops=16)" in listed
    assert "  fabric(line_rate=12500000000.0, quanta=32)" in listed
    assert "not ported" not in listed
    assert cli.main(["sweep", *args, "--filter", "nomatch"]) == 2


def test_unported_axes_and_engines_raise(monkeypatch):
    ts = Session(device="cpu")
    # Every axis entry of the JAX package is ported, the off-scan
    # evaluators (A11) last.
    rr = ts.run("sf", "ecmp", "uniform", "mat")
    assert isinstance(rr, RunResult) and rr.meta["lp_status"] == "optimal"
    # The batched engine (A10) is ported: two CPU shards give the
    # sequential sweep's results, with mat and fabric cells (which take
    # the sequential path inside it) mixed among the transport cells.
    grid = (["sf"], ["ecmp", "fatpaths(n_layers=9,rho=0.6)"], ["uniform"],
            ["mat", "transport", "fabric"])
    seq = ts.sweep(*grid)
    assert [r.evaluator for r in seq] == ["mat", "transport", "fabric"] * 2
    assert compare_results(seq, ts.sweep(*grid, devices=2), rtol=0) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--topo", "sf", "--scheme", "ecmp", "--pattern",
                  "uniform"])


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py may import jax or the JAX
    package, not even its numpy-only modules."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert bad == []
