"""The batched sweep engine of the port on the JAX package's larger
grids: static, dynamic and degraded cells over 1, 2 and 8 CPU shards,
recovery with a mid-run death, and one padded bucket where the
rollback's rounding rule is taken per element; each held at rtol 0 to
the JAX package's sequential engine, called live once per module, with
its batched engine's ``sweep_chunks``."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core import transport as j_transport
from repro.dist.sharding import host_device_runtime
from repro.experiments import Session as JSession
from repro.experiments import catalog as j_catalog
from repro.experiments import dist_sweep as j_dist
from repro_torch.core import transport as T
from repro_torch.experiments import Session, compare_results
from repro_torch.experiments import dist_sweep as D

# The JAX package's grids (tests/test_dist_sweep.py, tests/test_recovery.py).
# A static, a dynamic (load) and a degraded (failures) cell per topology;
# steps=200 > one chunk, and the elements exit at different chunks.
GRID8 = dict(topos=["clique(k=6)", "star(n=8)"],
             routings=["ecmp(n=2)", "fatpaths(n_layers=3)",
                       "failures(of=fatpaths(n_layers=3),rate=0.2,"
                       "down_step=60)"],
             patterns=["uniform", "load(level=0.4,window=96)"],
             evaluators=["transport(steps=200)"], seeds=[0])
# Recovery lanes with a mid-run death, 42 flows (42 mod 8 = 2).
RECOV_GRID = dict(topos=["clique(k=6)"],
                  routings=["fatpaths(n_layers=3)",
                            "failures(of=fatpaths(n_layers=3),rate=0.2,"
                            "down_step=20)"],
                  patterns=["uniform"],
                  evaluators=["transport(steps=80,recovery=on)",
                              "transport(steps=80,recovery=on,"
                              "transport=dctcp)",
                              "transport(steps=80)"],
                  seeds=[0, 1])
# One bucket of 200, 196 and 198 flows padded to 200 under a death and
# dctcp recovery: the rollback's rounding rule is taken per element on its
# own flow count.  Taking it on the padded count, as the reference's
# batched engine does, changes row 192 of the shuffle cell's remaining
# bytes (which its float32 delivered bytes do not show).
ROUNDING_GRID = dict(
    topos=["sf(q=5)"],
    routings=["failures(of=fatpaths(n_layers=9,rho=0.6),rate=0.05,"
              "down_step=10)"],
    patterns=[f"{p}(flow_size=4194304)"
              for p in ("uniform", "anycast", "shuffle")],
    evaluators=["transport(steps=80,recovery=on,transport=dctcp)"],
    seeds=[0])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's sweeps of the grids above, run once, and the
    port's sequential sweep of the recovery grid."""
    js = JSession()
    return {"grid8": JSession().sweep(**GRID8),
            "grid8_dist": j_dist.dist_sweep(js, js.grid(**GRID8), devices=1),
            "recov": JSession().sweep(**RECOV_GRID),
            # the port's sequential sweep, held to both device counts
            "recov_port": Session(device="cpu").sweep(**RECOV_GRID)}


def _chunks(results):
    return [r.meta["sweep_chunks"] for r in results]


@pytest.mark.parametrize("devices", [1, 2, 8])
def test_devices_on_the_reference_8_device_grid(ref, devices):
    """Static, dynamic and degraded cells whose elements exit at
    different chunks: equal to the reference's sequential engine for
    every device count, with the reference's ``sweep_chunks``."""
    ses = Session(device="cpu")
    logs = []
    dist = D.dist_sweep(ses, ses.grid(**GRID8), devices=devices,
                        log=logs.append)
    assert compare_results(ref["grid8"], dist) == []
    assert _chunks(dist) == _chunks(ref["grid8_dist"])
    assert len(set(_chunks(dist))) > 1
    assert any("offered_gbs" in r.meta for r in dist)
    assert any("failed_links" in r.meta for r in dist)
    if devices > 1:
        assert any(f"shard[{devices}]" in m or "device[" in m for m in logs)


@pytest.mark.parametrize("devices", [1, 8])
def test_recovery_grid_with_a_death(ref, devices):
    dist = Session(device="cpu").sweep(devices=devices, **RECOV_GRID)
    assert compare_results(ref["recov_port"], dist) == []
    assert compare_results(ref["recov"], dist) == []
    rec = [r for r in dist if "recovery=on" in r.evaluator]
    assert len(rec) == 8 and all("retrans_mb" in r.metrics for r in rec)


def test_rounding_rule_per_element_matches_reference(monkeypatch):
    """One padded bucket (200, 196, 198 flows) under a death and dctcp
    recovery: every element's final remaining bytes, departures and
    retransmissions bitwise the reference's sequential engine's, where
    the reference's batched engine rounds a shuffle flow otherwise."""
    finals = []

    def rec(final, n_elem):
        finals.extend(real(final, n_elem))
        return finals[-n_elem:]
    real = T.split_union
    monkeypatch.setattr(T, "split_union", rec)
    ses = Session(device="cpu")
    logs = []
    dist = D.dist_sweep(ses, ses.grid(**ROUNDING_GRID), devices=1,
                        log=logs.append)
    assert sum("bucket" in m and "padded to F=200" in m for m in logs) == 1
    n_real = [r.meta["n_flows"] for r in dist]
    assert n_real == [200, 196, 198]
    js = JSession()
    works = []
    for spec in js.grid(**ROUNDING_GRID):
        cell = js.resolve(spec)
        cfg, seeds = j_catalog.transport_plan(
            cell, **j_catalog.EVALUATORS.resolve(spec.evaluator)[1])
        nf, et, nl = j_transport.shape_signature(
            cell.topo, cell.bundle.routing, cell.workload)
        works.append(j_dist._Work(
            spec=spec, cell=cell, cfg=cfg, sim_seeds=seeds, n_flows=nf,
            e_tot=et, n_layers=nl, ev_meta={}, pre={}, post={},
            resolve_s=0.0))
    j_batched, _, _, _ = j_dist._dispatch_bucket(
        works, host_device_runtime(1), 0)
    j_rem = np.asarray(j_batched["remaining"])
    lanes = ("remaining", "depart_step", "retrans_acc", "sent_acc")
    deviates = []
    for b, (w, got, n) in enumerate(zip(works, finals, n_real)):
        arrs, static = j_transport.prepare(
            w.cell.topo, w.cell.bundle.routing, w.cell.workload, w.cfg)
        exp = j_transport._run_scan(arrs, jax.random.PRNGKey(0),
                                    dataclasses.replace(w.cfg, seed=0),
                                    static)
        for name in lanes:
            assert np.asarray(exp[name]).tobytes() == \
                got[name][:n].tobytes(), (w.spec.cell_id, name)
        deviates.append(np.nonzero(j_rem[b][:n]
                                   != np.asarray(exp["remaining"]))[0])
    # the reference's batched engine (ROADMAP §C)
    assert [d.tolist() for d in deviates] == [[], [], [192]]
