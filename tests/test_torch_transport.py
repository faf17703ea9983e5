"""The port's flow scan against the JAX package's, on the JAX package's
own tables and workload carried across as numpy (repro_torch.interop):
per-flow departures, hops, remaining bytes and accumulators must be
bitwise equal for every transport x balancing mode."""

import dataclasses

import numpy as np
import pytest
import jax

from repro.core import layers as j_layers
from repro.core import topology as j_topo
from repro.core import traffic as j_traffic
from repro.core import transport as j_transport
from repro_torch import interop, prng
from repro_torch.core import transport

LANES = ("remaining", "hops", "depart_step", "sent_acc", "w_acc", "layer")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def cell():
    topo = j_topo.slim_fly(5)
    wl = j_traffic.make_workload(topo, "adversarial", n_rounds=2,
                                 randomize=False, seed=1)
    routings = {"fatpaths": j_layers.build_layers(topo, 4, 0.6, seed=2),
                "ecmp": j_transport.ecmp_routing(topo, n_tables=4, seed=2)}
    routings["letflow"] = routings["ecmp"]
    t_topo = interop.topology_from_arrays(_fields(topo))
    t_wl = interop.workload_from_arrays(_fields(wl))
    t_routings = {k: interop.routing_from_arrays(t_topo, _fields(v), "cpu")
                  for k, v in routings.items()}
    return topo, wl, routings, t_topo, t_wl, t_routings


def _both(cell, transport_name, balancing, **kw):
    topo, wl, routings, t_topo, t_wl, t_routings = cell
    cfg = j_transport.SimConfig(transport=transport_name, balancing=balancing,
                                n_steps=200, horizon_chunk=32, **kw)
    jarrs, static = j_transport.prepare(topo, routings[balancing], wl, cfg)
    ref = jax.device_get(j_transport._run_scan(
        jarrs, jax.random.PRNGKey(7), cfg, static))
    t_cfg = interop.config_from_dict(dataclasses.asdict(cfg))
    arrs, t_static = transport.prepare(t_topo, t_routings[balancing], t_wl,
                                       t_cfg, device="cpu")
    assert t_static == static
    assert transport.shape_signature(t_topo, t_routings[balancing], t_wl) \
        == j_transport.shape_signature(topo, routings[balancing], wl)
    for k in ("path_edges", "routed", "path_hops", "usable", "size"):
        np.testing.assert_array_equal(np.asarray(jarrs[k]), arrs[k].numpy(),
                                      err_msg=k)
    out = transport._run_scan(arrs, prng.PRNGKey(7, "cpu"), t_cfg, t_static)
    return ref, {k: (v.numpy() if hasattr(v, "numpy") else v)
                 for k, v in out.items()}, t_cfg, arrs, t_static


@pytest.mark.parametrize("transport_name", ["ndp", "tcp", "dctcp"])
@pytest.mark.parametrize("balancing", ["ecmp", "letflow", "fatpaths"])
def test_scan_bitwise_on_reference_tables(cell, transport_name, balancing):
    ref, out, *_ = _both(cell, transport_name, balancing)
    for k in LANES:
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k], err_msg=k)
    # sent_acc to the bit: the reference's update is one FMA (XLA
    # contracts sent_acc + d * s), and so is the port's.
    np.testing.assert_array_equal(np.asarray(ref["sent_acc"]).view(np.int32),
                                  out["sent_acc"].view(np.int32))
    assert int(ref["horizon_chunks"]) == out["horizon_chunks"]
    size = np.asarray(cell[1].size, np.float32)
    res_j = j_transport._to_result(size, ref, j_transport.SimConfig())
    res_t = transport._to_result(size, out, transport.SimConfig())
    np.testing.assert_array_equal(res_j.finished, res_t.finished)
    np.testing.assert_array_equal(res_j.fct, res_t.fct)
    assert res_j.link_util_mean == res_t.link_util_mean


@pytest.mark.parametrize("fair_iters", [0, 1, 3])
def test_scan_sent_acc_bitwise_for_any_fair_iters(cell, fair_iters):
    """The accumulator is rounded once at every refinement depth (plain
    f32 add at 0 rounds, one FMA after the last round otherwise)."""
    ref, out, *_ = _both(cell, "tcp", "fatpaths", fair_iters=fair_iters)
    for k in LANES:
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(ref["sent_acc"]).view(np.int32),
                                  out["sent_acc"].view(np.int32))


@pytest.mark.parametrize("balancing", ["ecmp", "fatpaths"])
def test_adaptive_horizon_equals_full_horizon(cell, balancing):
    ref, out, cfg, arrs, static = _both(cell, "ndp", balancing)
    full = transport._run_scan(
        arrs, prng.PRNGKey(7, "cpu"),
        dataclasses.replace(cfg, adaptive_horizon=False), static)
    assert out["horizon_chunks"] < full["horizon_chunks"]
    for k in ("remaining", "hops", "depart_step", "sent_acc", "w_acc"):
        np.testing.assert_array_equal(out[k], full[k].numpy(), err_msg=k)


def test_unported_lanes_raise(cell):
    with pytest.raises(ValueError, match="kernel_backend"):
        transport.SimConfig(kernel_backend="pallas")


def test_simulate_seeds_equals_simulate(cell):
    _, _, _, t_topo, t_wl, t_routings = cell
    cfg = transport.SimConfig(balancing="fatpaths", n_steps=96,
                              horizon_chunk=32)
    many = transport.simulate_seeds(t_topo, t_routings["fatpaths"], t_wl, cfg,
                                    [0, 1000], device="cpu")
    one = transport.simulate(t_topo, t_routings["fatpaths"], t_wl,
                             dataclasses.replace(cfg, seed=1000),
                             device="cpu")
    np.testing.assert_array_equal(many[1].fct, one.fct)
    np.testing.assert_array_equal(many[1].depart_step, one.depart_step)
    assert many[1].config.seed == 1000
