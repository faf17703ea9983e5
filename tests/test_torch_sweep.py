"""The batched sweep engine of the port: exact padding, the union scan
(one flow set over disjoint link ranges, one link plan laid end to end)
against each element alone, ``dist_sweep`` against the port's sequential
sweep and against the JAX package's sequential and batched engines
(called live, once per module) at rtol 0 with ``sweep_chunks`` equal,
bucketing, resumable checkpoints, quarantine, errors that propagate, and
the CLI.  The larger grids are in ``test_torch_sweep_grids.py``."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import transport as j_transport
from repro.experiments import Session as JSession
from repro.experiments import catalog as j_catalog
from repro.experiments.dist_sweep import dist_sweep as j_dist_sweep
from repro.experiments.dist_sweep import padded_signature as j_padded_sig
from repro_torch import prng
from repro_torch.ckpt import SchemaMismatch, SweepCheckpoint
from repro_torch.core import transport as T
from repro_torch.experiments import Session, compare_results
from repro_torch.experiments import __main__ as cli
from repro_torch.experiments import catalog as t_catalog
from repro_torch.experiments import dist_sweep as D
from repro_torch.experiments.results import (EXECUTION_META_KEYS,
                                             results_from_json)
from repro_torch.kernels.waterfill import link_plan

# The JAX package's own grids (tests/test_dist_sweep.py, tests/test_recovery.py).
GRID = dict(topos=["clique(k=6)", "star(n=8)"],
            routings=["ecmp(n=2)", "fatpaths(n_layers=3)"],
            patterns=["uniform"],
            evaluators=["transport(steps=40)"], seeds=[0, 1])
SEEDS_GRID = dict(topos=["clique(k=6)", "star(n=8)"],
                  routings=["fatpaths(n_layers=3)", "letflow(n=2)"],
                  patterns=["uniform"],
                  evaluators=["transport(steps=40,seeds=3)"], seeds=[0])
FAIL_GRID = dict(
    topos=["clique(k=6)"],
    routings=["failures(of=fatpaths(n_layers=3),rate=0.1)",
              "failures(of=fatpaths(n_layers=3),rate=0.3,mode=drop)",
              "failures(of=fatpaths(n_layers=3),rate=0.2,down_step=15)",
              "fatpaths(n_layers=3)"],
    patterns=["uniform"], evaluators=["transport(steps=40)"], seeds=[0])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's sweeps of the grids above, run once."""
    out = {}
    for name, grid in (("grid", GRID), ("seeds", SEEDS_GRID)):
        out[name] = JSession().sweep(**grid)
        js = JSession()
        out[name + "_dist"] = j_dist_sweep(js, js.grid(**grid), devices=1)
    return out


def _chunks(results):
    return [r.meta["sweep_chunks"] for r in results]


# ---- padding and the union --------------------------------------------------
PAD_CELLS = [
    ("clique(k=6)", "fatpaths(n_layers=3)", "uniform",
     dict(n_steps=200)),
    ("clique(k=6)", "failures(of=fatpaths(n_layers=3),rate=0.2,down_step=20)",
     "uniform(flow_size=4194304)",
     dict(n_steps=100, recovery="on", transport="dctcp")),
    ("clique(k=6)", "churn(of=fatpaths(n_layers=3),rate=0.3,mtbf=20,mttr=10)",
     "permutation(flow_size=1000000000.0)",
     dict(n_steps=100, recovery="on", transport="tcp")),
    ("clique(k=6)", "fatpaths(n_layers=3)", "load(level=0.4,window=96)",
     dict(n_steps=200)),
    ("star(n=8)", "ecmp(n=2)", "uniform", dict(n_steps=90)),
]
LANES = ("fct", "delivered", "finished", "depart_step", "retrans_bytes")


def _cell(ses, topo, routing, pattern):
    return ses.resolve(ses.grid([topo], [routing], [pattern])[0])


def _same_sims(a, b, what):
    for name in LANES:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), (what, name)
        if x is not None:
            assert x.tobytes() == y.tobytes(), (what, name)
    assert a.link_util_mean == b.link_util_mean, what


@pytest.mark.parametrize("topo,routing,pattern,kw", PAD_CELLS)
def test_pad_prepared_is_exact(topo, routing, pattern, kw):
    """A cell padded in flows, links and hop slots scans to the same
    bits as the cell alone, as a one-element union too; the padded plan
    is ``link_plan`` of the padded edges."""
    ses = Session(device="cpu")
    cell = _cell(ses, topo, routing, pattern)
    cfg = T.SimConfig(balancing=cell.bundle.balancing, **kw)
    arrs, static = T.prepare(cell.topo, cell.bundle.routing, cell.workload,
                             cfg, device="cpu")
    f = arrs["size"].shape[0]
    size, start = arrs["size"].numpy(), arrs["start"].numpy()
    base = T._to_result(size, T._run_scan(arrs, prng.PRNGKey(5, "cpu"), cfg,
                                          static), cfg, start=start)
    padded, pstatic = T.pad_prepared(
        arrs, static, n_flows=f + 13, n_edges=static[0] + 7,
        hop_slots=arrs["path_edges"].shape[2] + 2)
    plan = link_plan(padded["path_edges"], pstatic[0])
    assert torch.equal(plan.offsets, padded["plan_offsets"])
    assert torch.equal(plan.entries, padded["plan_entries"])
    final = T._run_scan(padded, prng.PRNGKey(5, "cpu"), cfg, pstatic,
                        n_real=[f])
    _same_sims(base, T.batch_result(size, final, cfg, n_flows=f,
                                    start=start), "padded")
    uarrs, ustatic = T.union_prepared([padded], pstatic)
    (one,) = T.split_union(T._run_scan(
        uarrs, prng.PRNGKey(5, "cpu")[None], cfg, ustatic, n_real=[f]), 1)
    _same_sims(base, T.batch_result(size, one, cfg, n_flows=f, start=start),
               "one-element union")


def test_pad_prepared_rejects_shrinking():
    ses = Session(device="cpu")
    cell = _cell(ses, "clique(k=6)", "ecmp(n=2)", "uniform")
    cfg = T.SimConfig(balancing="ecmp", n_steps=10)
    arrs, static = T.prepare(cell.topo, cell.bundle.routing, cell.workload,
                             cfg, device="cpu")
    with pytest.raises(ValueError, match="smaller than cell"):
        T.pad_prepared(arrs, static, n_flows=1, n_edges=static[0],
                       hop_slots=arrs["path_edges"].shape[2])


def _padded_elements(ses, cells, cfg):
    """``cells`` prepared and padded to their maxima: (padded, static,
    unpadded (arrs, static) list)."""
    prep = [T.prepare(c.topo, c.bundle.routing, c.workload, cfg,
                      device="cpu") for c in cells]
    nf = max(a["size"].shape[0] for a, _ in prep)
    ne = max(st[0] for _, st in prep)
    nh = max(a["path_edges"].shape[2] for a, _ in prep)
    padded = [T.pad_prepared(a, st, n_flows=nf, n_edges=ne, hop_slots=nh)
              for a, st in prep]
    return [p for p, _ in padded], padded[0][1], prep


def test_union_plan_is_the_link_plan_of_the_union():
    """Two elements whose E and F differ before padding (clique(k=6):
    42 flows over 127 links; star(n=8): 8 over 17): the union's plan is
    bitwise ``link_plan`` of the union's edges, each element's live links
    land in its own range and its own trash id in none."""
    ses = Session(device="cpu")
    cells = [_cell(ses, "clique(k=6)", "fatpaths(n_layers=3)", "uniform"),
             _cell(ses, "star(n=8)", "fatpaths(n_layers=3)", "uniform")]
    cfg = T.SimConfig(balancing="fatpaths", n_steps=40)
    padded, static, prep = _padded_elements(ses, cells, cfg)
    assert [st[0] for _, st in prep] == [127, 17]
    # the smaller element's own trash id would be the larger's link 16
    uarrs, ustatic = T.union_prepared(padded + padded[::-1], static)
    live = static[0] - 1
    assert ustatic[0] == 4 * live + 1
    plan = link_plan(uarrs["path_edges"], ustatic[0])
    assert torch.equal(plan.offsets, uarrs["plan_offsets"])
    assert torch.equal(plan.entries, uarrs["plan_entries"])
    fp = padded[0]["size"].shape[0]
    pe = uarrs["path_edges"]
    for b, (arrs, st) in enumerate([prep[0], prep[1], prep[1], prep[0]]):
        mine = pe[:, b * fp:(b + 1) * fp]
        used = mine[mine >= 0]
        assert bool(((used >= b * live)
                     & (used < b * live + st[0] - 1)).all())
    assert int(pe.max()) < ustatic[0] - 1


UNION_CASES = [
    # elements exit at different chunks (steps 200 > one chunk)
    (["clique(k=6)", "clique(k=6)", "clique(k=6)"], "fatpaths(n_layers=3)",
     ["uniform", "load(level=0.4,window=96)", "shuffle"], dict(n_steps=300)),
    # a death under dctcp recovery, 42, 38 and 40 flows
    (["clique(k=6)"] * 3,
     "failures(of=fatpaths(n_layers=3),rate=0.2,down_step=20)",
     [f"{p}(flow_size=4194304)" for p in ("uniform", "anycast", "shuffle")],
     dict(n_steps=100, recovery="on", transport="dctcp")),
    (["sf(q=5)"] * 3,
     "failures(of=fatpaths(n_layers=9,rho=0.6),rate=0.05,down_step=10)",
     [f"{p}(flow_size=4194304)" for p in ("uniform", "anycast", "shuffle")],
     dict(n_steps=80, recovery="on", transport="dctcp")),
    (["clique(k=6)"] * 2,
     "churn(of=fatpaths(n_layers=3),rate=0.3,mtbf=20,mttr=10)",
     ["uniform(flow_size=4194304)", "shuffle(flow_size=4194304)"],
     dict(n_steps=100, recovery="on", transport="tcp")),
    (["clique(k=6)", "clique(k=6)"], "ecmp(n=2)", ["uniform", "anycast"],
     dict(n_steps=200, transport="tcp")),
]


@pytest.mark.parametrize("topos,routing,patterns,kw", UNION_CASES)
def test_union_scan_equals_each_element_alone(topos, routing, patterns, kw):
    """The union scan of elements of different sizes and seeds gives each
    element the bits of its own scan, and its own ``horizon_chunks``;
    running exhausted elements on to the full horizon changes no result
    lane."""
    ses = Session(device="cpu")
    cells = [_cell(ses, t, routing, p) for t, p in zip(topos, patterns)]
    cfg = T.SimConfig(balancing=cells[0].bundle.balancing, **kw)
    padded, static, prep = _padded_elements(ses, cells, cfg)
    seeds = [3, 0, 1000][:len(cells)]
    keys = torch.stack([prng.PRNGKey(s, "cpu") for s in seeds])
    n_real = [a["size"].shape[0] for a, _ in prep]
    uarrs, ustatic = T.union_prepared(padded, static)
    full = dataclasses.replace(cfg, adaptive_horizon=False)
    finals = [T.split_union(T._run_scan(uarrs, keys, c, ustatic,
                                        n_real=n_real), len(cells))
              for c in (cfg, full)]
    horizons = []
    for b, ((arrs, st), s) in enumerate(zip(prep, seeds)):
        alone = T._run_scan(arrs, prng.PRNGKey(s, "cpu"), cfg, st)
        horizons.append(alone["horizon_chunks"])
        size, start = arrs["size"].numpy(), arrs["start"].numpy()
        exp = T._to_result(size, alone, cfg, start=start)
        for final in finals:
            _same_sims(exp, T.batch_result(size, final[b], cfg,
                                           n_flows=n_real[b], start=start),
                       f"element {b}")
        assert finals[0][b]["horizon_chunks"] == alone["horizon_chunks"]
    if kw["n_steps"] >= 200 and "load" in patterns[1]:
        assert len(set(horizons)) > 1, horizons


def test_record_takes_one_element():
    ses = Session(device="cpu")
    cell = _cell(ses, "clique(k=6)", "fatpaths(n_layers=3)", "uniform")
    cfg = T.SimConfig(balancing="fatpaths", n_steps=20, record=1)
    padded, static, _ = _padded_elements(ses, [cell, cell], cfg)
    uarrs, ustatic = T.union_prepared(padded, static)
    keys = torch.stack([prng.PRNGKey(s, "cpu") for s in (0, 1)])
    with pytest.raises(ValueError, match="record=1 takes one element"):
        T._run_scan(uarrs, keys, cfg, ustatic)


# ---- bucketing --------------------------------------------------------------
def test_padded_signature_partitions_like_the_reference():
    """The port's buckets are the reference's, cell for cell, on a grid
    of static, dynamic, degraded, churn and recovery cells."""
    grid = dict(topos=["clique(k=6)", "star(n=8)"],
                routings=["ecmp(n=2)", "fatpaths(n_layers=3)",
                          "failures(of=fatpaths(n_layers=3),rate=0.2,"
                          "down_step=60)",
                          "churn(of=fatpaths(n_layers=3),rate=0.3,mtbf=20,"
                          "mttr=10)"],
                patterns=["uniform", "load(level=0.4,window=96)", "anycast"],
                evaluators=["transport(steps=200)",
                            "transport(steps=80,recovery=on)"], seeds=[0])
    parts = []
    for ses, sig, pkg, cat in (
            (Session(device="cpu"), D.padded_signature, T, t_catalog),
            (JSession(), j_padded_sig, j_transport, j_catalog)):
        buckets = {}
        for spec in ses.grid(**grid):
            cell = ses.resolve(spec)
            _, kw = cat.EVALUATORS.resolve(spec.evaluator)
            cfg, _ = cat.transport_plan(cell, **kw)
            nf, et, nl = pkg.shape_signature(cell.topo, cell.bundle.routing,
                                             cell.workload)
            lr = cell.bundle.routing
            lc = getattr(lr, "link_churn", None)
            key = sig(cfg, nl, nf, et,
                      link_down=getattr(lr, "link_down_step", None)
                      is not None,
                      churn_k=0 if lc is None else int(lc.shape[2]))
            buckets.setdefault(key, []).append(spec.cell_id)
        parts.append(sorted(buckets.values()))
    assert parts[0] == parts[1]
    assert len(parts[0]) > 4


def test_bucket_signature_keys_config_and_layers():
    a = T.SimConfig(balancing="fatpaths", n_steps=40, seed=3)
    b = T.SimConfig(balancing="fatpaths", n_steps=40, seed=9)
    c = T.SimConfig(balancing="ecmp", n_steps=40, seed=3)
    assert D.bucket_signature(a, (10, 5, 40)) == \
        D.bucket_signature(b, (99, 5, 40))
    assert D.bucket_signature(a, (10, 5, 40)) != \
        D.bucket_signature(c, (10, 5, 40))
    assert D.bucket_signature(a, (10, 5, 40)) != \
        D.bucket_signature(b, (10, 6, 40))


# ---- engine identity ----------------------------------------------------------
@pytest.mark.parametrize("name,grid", [("grid", GRID),
                                       ("seeds", SEEDS_GRID)])
def test_dist_sweep_matches_sequential_and_reference(ref, name, grid):
    seq = Session(device="cpu").sweep(**grid)
    ses = Session(device="cpu")
    cells = ses.grid(**grid)
    dist = D.dist_sweep(ses, cells, devices=1)
    assert [r.cell_id for r in dist] == [c.cell_id for c in cells]
    assert compare_results(seq, dist) == []
    assert compare_results(ref[name], dist) == []
    assert compare_results(ref[name + "_dist"], dist) == []
    assert _chunks(dist) == _chunks(ref[name + "_dist"])


def test_mixed_evaluators_fall_back_in_canonical_order():
    grid = dict(topos=["clique(k=6)"], routings=["fatpaths(n_layers=3)"],
                patterns=["uniform"],
                evaluators=["transport(steps=40)", "recovery(steps=60)",
                            "outcast(steps=40)", "transport(steps=60)"],
                seeds=[0])
    seq = Session(device="cpu").sweep(**grid)
    dist = Session(device="cpu").sweep(devices=2, **grid)
    assert compare_results(seq, dist) == []
    assert [r.evaluator for r in dist] == [r.evaluator for r in seq]
    assert "sweep_bucket" not in dist[1].meta


# ---- errors -------------------------------------------------------------------
def test_a_failing_bucket_raises_without_retry(monkeypatch):
    calls = []

    def boom(*args, **kw):
        calls.append(1)
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(T, "_run_scan", boom)
    ses = Session(device="cpu")
    with pytest.raises(RuntimeError, match="kernel failed"):
        D.dist_sweep(ses, ses.grid(**GRID), devices=1)
    assert len(calls) == 1


def test_devices_are_checked(monkeypatch):
    ses = Session(device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        D.dist_sweep(ses, ses.grid(**GRID), devices=0)
    assert D._devices(ses, 3) == [torch.device("cpu")] * 3
    ses.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        D._devices(ses, 2)
    assert D._devices(ses, 1) == [torch.device("cuda")]


def test_placement_follows_the_reference_policy():
    devs = [torch.device("cpu")] * 4
    assert D._placement(5, devs[:1], 3) == ("union", [(devs[0],
                                                       [0, 1, 2, 3, 4])])
    mode, shards = D._placement(10, devs, 0)
    assert mode == "shard[4]"
    assert [i for _, idx in shards for i in idx] == list(range(10))
    assert [len(idx) for _, idx in shards] == [3, 3, 3, 1]
    assert D._placement(3, devs, 6)[0] == "device[2]"


# ---- resumable sweeps ---------------------------------------------------------
def test_checkpoint_resume_skips_completed_cells(tmp_path):
    ckdir = str(tmp_path / "ck")
    s1 = Session(device="cpu")
    cells = s1.grid(**GRID)
    part = D.dist_sweep(s1, cells[:3], devices=1, checkpoint_dir=ckdir)
    assert len(part) == 3
    assert len([f for f in os.listdir(ckdir) if f.endswith(".json")]) == 3
    streamed = []
    s2 = Session(device="cpu")
    full = D.dist_sweep(s2, cells, devices=1, checkpoint_dir=ckdir,
                        callback=lambda rr: streamed.append(rr.cell_id))
    assert len(full) == len(cells) == len(streamed)
    assert len([r for r in full if r.meta.get("sweep_resumed")]) == 3
    assert compare_results(Session(device="cpu").sweep(**GRID), full) == []
    assert [r.cell_id for r in full] == [c.cell_id for c in cells]


def _artifact_bytes(results):
    dicts = []
    for r in results:
        d = r.to_dict()
        d.pop("wall_s")
        for k in EXECUTION_META_KEYS:
            d["meta"].pop(k, None)
        dicts.append(d)
    return json.dumps(dicts, indent=1, sort_keys=True).encode()


def test_checkpoint_resume_failure_grid_byte_identical(tmp_path):
    ckdir = str(tmp_path / "ck")
    s1 = Session(device="cpu")
    cells = s1.grid(**FAIL_GRID)
    D.dist_sweep(s1, cells[:2], devices=1, checkpoint_dir=ckdir)
    full = D.dist_sweep(Session(device="cpu"), cells, devices=2,
                        checkpoint_dir=ckdir)
    assert len([r for r in full if r.meta.get("sweep_resumed")]) == 2
    s3 = Session(device="cpu")
    whole = D.dist_sweep(s3, s3.grid(**FAIL_GRID), devices=1)
    assert compare_results(whole, full) == []
    assert _artifact_bytes(full) == _artifact_bytes(whole)
    for r in full:
        if r.routing.startswith("failures"):
            assert "disconnected_pairs" in r.meta


def test_checkpoint_ignores_torn_files_and_rejects_stale_schema(tmp_path):
    ck = SweepCheckpoint(str(tmp_path))
    ck.put("a/b/c@s0", {"topo": "a"})
    with open(os.path.join(str(tmp_path), "cell_deadbeef.json"), "w") as f:
        f.write('{"cell_id": "x"')          # torn write, no rename
    assert ck.load() == {"a/b/c@s0": {"topo": "a"}}
    assert "a/b/c@s0" in ck and len(ck) == 1
    assert ck.get("missing") is None
    with open(os.path.join(str(tmp_path), "cell_0123.json"), "w") as f:
        json.dump({"cell_id": "y", "schema": 0, "result": {}}, f)
    with pytest.raises(SchemaMismatch, match="schema 0"):
        SweepCheckpoint(str(tmp_path)).load()
    ses = Session(device="cpu")
    with pytest.raises(SchemaMismatch):
        D.dist_sweep(ses, ses.grid(**GRID), checkpoint_dir=str(tmp_path))


def test_nonfinite_cells_are_quarantined_not_checkpointed(tmp_path,
                                                          monkeypatch):
    real = T.batch_result
    poisoned = []

    def poison(size, final, cfg, n_flows=None, start=None):
        r = real(size, final, cfg, n_flows=n_flows, start=start)
        if not poisoned and n_flows == 42:
            r.delivered = r.delivered.copy()
            r.delivered[0] = np.nan
            poisoned.append(cfg)
        return r
    monkeypatch.setattr(T, "batch_result", poison)
    ckdir = str(tmp_path / "ck")
    ses = Session(device="cpu")
    out = D.dist_sweep(ses, ses.grid(**GRID), devices=1,
                       checkpoint_dir=ckdir)
    bad = [r for r in out if "error" in r.meta]
    assert len(bad) == 1 and bad[0].metrics == {}
    assert bad[0].meta["error"] == {"type": "nonfinite", "seeds_bad": 1}
    stored = SweepCheckpoint(ckdir)
    assert bad[0].cell_id not in stored and len(stored) == len(out) - 1


# ---- the CLI --------------------------------------------------------------------
def test_cli_devices_and_checkpoint(tmp_path, capsys):
    a, b, ck = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "ck"
    args = ["--topos", "clique(k=6),star(n=8)", "--schemes",
            "ecmp(n=2),fatpaths(n_layers=3)", "--patterns", "uniform",
            "--evaluators", "transport(steps=40)", "--seeds", "0,1",
            "--device", "cpu"]
    assert cli.main(["sweep", *args, "--json", str(a)]) == 0
    assert cli.main(["sweep", *args, "--devices", "1", "--checkpoint",
                     str(ck), "--json", str(b)]) == 0
    assert "elements as union" in capsys.readouterr().out
    assert cli.main(["diff", str(a), str(b)]) == 0
    assert len(results_from_json(b.read_text())) == 8
    assert cli.main(["sweep", *args, "--devices", "2", "--checkpoint",
                     str(ck), "--json", str(b)]) == 0
    assert "resumed 8 completed cell(s)" in capsys.readouterr().out
    assert cli.main(["diff", str(a), str(b)]) == 0
    assert cli.main(["sweep", *args, "--devices", "2",
                     "--cell-timeout-s", "5"]) == 2
    assert "drop --devices" in capsys.readouterr().err
    assert cli.main(["sweep", *args, "--cell-timeout-s", "600",
                     "--json", str(b)]) == 0
    assert cli.main(["diff", str(a), str(b)]) == 0


def test_cli_watchdog_marks_timeouts_and_resume_retries_them(tmp_path,
                                                             capsys):
    """--cell-timeout-s: a cell over its budget is recorded failed with a
    timeout (rc 1 when no cell succeeded) and is not checkpointed, so a
    resume with a budget it fits runs it."""
    out, ck = tmp_path / "wd.json", tmp_path / "ck"
    args = ["sweep", "--topos", "clique(k=6)", "--schemes",
            "fatpaths(n_layers=3)", "--patterns", "uniform", "--evaluators",
            "transport(steps=40)", "--device", "cpu", "--checkpoint",
            str(ck), "--json", str(out)]
    assert cli.main([*args, "--cell-timeout-s", "0.001"]) == 1
    assert "failed-with-timeout" in capsys.readouterr().out
    (rr,) = results_from_json(out.read_text())
    assert rr.metrics == {}
    assert rr.meta["error"] == {"type": "timeout", "timeout_s": 0.001}
    assert len(SweepCheckpoint(str(ck))) == 0
    assert cli.main([*args, "--cell-timeout-s", "600"]) == 0
    assert "1 succeeded, 0 timed out" in capsys.readouterr().out
    (rr,) = results_from_json(out.read_text())
    assert rr.metrics["finished"] > 0 and "error" not in rr.meta
    assert len(SweepCheckpoint(str(ck))) == 1
