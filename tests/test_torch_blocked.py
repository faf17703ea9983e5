"""The blocked path engine and compressed tables: the port against the JAX
package on the same inputs, bitwise.  The JAX side runs as
``tests/test_sparse.py`` runs it, with the engine forced through
``engine=`` or ``REPRO_PATH_ENGINE``.  sf(q=5) (50 routers) is one
destination chunk; sf(q=13) (338 routers) takes two, so its cases reach
the short last chunk and the padded row block of the walk counts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import failures as JF
from repro.core import layers as j_layers
from repro.core import paths as j_paths
from repro.core import topology as j_topo
from repro.core import traffic as j_traffic
from repro.core import transport as j_transport
from repro.experiments import Session as JSession
from repro.experiments.results import compare_results
from repro_torch import interop, prng
from repro_torch.core import failures as TF
from repro_torch.core import layers, paths, topology, transport
from repro_torch.experiments import Session

SCHEMES = ["rand", "undir", "pi_min", "spain", "past", "ksp"]
TABLES = ("nh", "reach", "pathlen", "layer_adj")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _routing(t_topo, lr):
    """The JAX package's stack in the port, its compressed tables too."""
    d = _fields(lr)
    if lr.compressed is not None:
        d["compressed"] = _fields(lr.compressed)
    return interop.routing_from_arrays(t_topo, d, "cpu")


def _same_tables(got, exp):
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(exp, name)),
                                      err_msg=name)


def _same_compressed(got, exp):
    assert (got.block, got.n) == (exp.block, exp.n)
    assert got.nh_sets.dtype == torch.int32 and got.sel.dtype == torch.uint8
    np.testing.assert_array_equal(got.nh_sets.numpy(), exp.nh_sets)
    np.testing.assert_array_equal(got.sel.numpy(), exp.sel)
    assert got.nbytes == exp.nbytes


@pytest.fixture(scope="module")
def sf5():
    return j_topo.slim_fly(5), topology.slim_fly(5)


@pytest.fixture(scope="module")
def sf13():
    return j_topo.slim_fly(13), topology.slim_fly(13)


@pytest.mark.parametrize("env", [None, "dense", "blocked", "auto"])
@pytest.mark.parametrize("n", [50, 511, 512, 722])
def test_engine_and_representation_resolve_as_reference(monkeypatch, n, env):
    if env is None:
        monkeypatch.delenv("REPRO_PATH_ENGINE", raising=False)
    else:
        monkeypatch.setenv("REPRO_PATH_ENGINE", env)
    exp = ("blocked" if env == "blocked" or (env != "dense" and n >= 512)
           else "dense")
    assert paths.path_engine(n) == j_paths.path_engine(n) == exp
    assert paths.path_engine() == j_paths.path_engine()
    for override in ("dense", "blocked"):
        assert paths.path_engine(n, override) == override
    assert paths.representation_for(n) == j_paths.representation_for(n) \
        == ("compressed" if exp == "blocked" else "dense")
    for rep in ("dense", "compressed"):
        assert paths.representation_for(n, rep) == rep


def test_unknown_engine_and_representation_raise(monkeypatch):
    monkeypatch.setenv("REPRO_PATH_ENGINE", "sparse")
    with pytest.raises(ValueError, match="unknown path engine"):
        paths.path_engine(722)
    monkeypatch.delenv("REPRO_PATH_ENGINE")
    with pytest.raises(ValueError, match="unknown table representation"):
        paths.representation_for(722, "bits")
    with pytest.raises(ValueError, match="unknown representation"):
        layers.build_layers(topology.slim_fly(5), 2, 0.6,
                            representation="bits", device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_blocked_stack_all_schemes_bitwise(sf5, scheme):
    jt, tt = sf5
    exp = j_layers.build_layers(jt, 4, 0.6, scheme=scheme, seed=2,
                                engine="blocked")
    dense = layers.build_layers(tt, 4, 0.6, scheme=scheme, seed=2,
                                engine="dense", device="cpu")
    got = layers.build_layers(tt, 4, 0.6, scheme=scheme, seed=2,
                              engine="blocked", device="cpu")
    assert dense.compressed is None
    _same_tables(got, exp)
    _same_tables(dense, exp)
    _same_compressed(got.compressed, exp.compressed)
    assert torch.equal(got.compressed.dense(), got.nh)
    assert set(got.build_stats) == set(exp.build_stats)


@pytest.mark.parametrize("what", ["rand", "ecmp", "min_path_stats"])
def test_blocked_two_chunks_bitwise(sf13, monkeypatch, what):
    jt, tt = sf13
    assert tt.n_routers > paths._CHUNK
    monkeypatch.setenv("REPRO_PATH_ENGINE", "blocked")
    if what == "min_path_stats":
        adj = np.asarray(jt.adj, bool)
        d_j, c_j = j_paths.min_path_stats(adj, max_l=8)
        d_t, c_t = paths.min_path_stats(tt.adj, max_l=8, device="cpu")
        assert (d_t.dtype, c_t.dtype) == (d_j.dtype, c_j.dtype)
        np.testing.assert_array_equal(d_t, d_j)
        np.testing.assert_array_equal(c_t, c_j)
        d_d, c_d = paths.min_path_stats(tt.adj, max_l=8, engine="dense",
                                        device="cpu")
        np.testing.assert_array_equal(d_d, d_t)
        np.testing.assert_array_equal(c_d, c_t)
        return
    if what == "rand":
        exp = j_layers.build_layers(jt, 5, 0.6, seed=1)
        got = layers.build_layers(tt, 5, 0.6, seed=1, device="cpu")
    else:
        exp = j_transport.ecmp_routing(jt, n_tables=3, seed=1)
        got = transport.ecmp_routing(tt, n_tables=3, seed=1, device="cpu")
    _same_tables(got, exp)
    _same_compressed(got.compressed, exp.compressed)
    assert torch.equal(got.compressed.dense(), got.nh)


@pytest.mark.parametrize("q", [5, 13])
def test_blocked_apsp_on_asymmetric_masked_stack(q):
    """Oriented layers and one-way dead links make the stack asymmetric:
    the frontier APSP must relax over in-neighbors."""
    jt, tt = j_topo.slim_fly(q), topology.slim_fly(q)
    lr = layers.build_layers(tt, 5, 0.6, seed=0, engine="dense",
                             device="cpu")
    adj = lr.layer_adj.numpy().copy()
    rng = np.random.default_rng(q)
    adj &= ~(rng.random(adj.shape[1:]) < 0.1)[None]
    assert not np.array_equal(adj[0], adj[0].T)
    exp = np.asarray(j_paths.apsp_batched(jnp.asarray(adj), max_l=16,
                                          engine="blocked"))
    got = paths.apsp_batched(adj, max_l=16, device="cpu", engine="blocked")
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(
        paths.apsp_batched(adj, max_l=16, device="cpu",
                           engine="dense").numpy(), exp)
    nh_j = np.asarray(j_paths.forwarding_batched(
        jnp.asarray(adj), jnp.asarray(exp), jax.random.PRNGKey(q),
        engine="blocked"))
    nh_t = paths.forwarding_batched(adj, exp, prng.PRNGKey(q, "cpu"),
                                    device="cpu", engine="blocked")
    np.testing.assert_array_equal(nh_t.numpy(), nh_j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compressed_lookup_matches_dense_gather(seed):
    jt = j_topo.jellyfish(40 + 8 * seed, 5, 2, seed=seed)
    tt = topology.jellyfish(40 + 8 * seed, 5, 2, seed=seed)
    exp = j_layers.build_layers(jt, 3, 0.7, seed=seed,
                                representation="compressed")
    lr = layers.build_layers(tt, 3, 0.7, seed=seed,
                             representation="compressed", device="cpu")
    ct = lr.compressed
    _same_tables(lr, exp)
    _same_compressed(ct, exp.compressed)
    rng = np.random.default_rng(seed)
    li, s, t = (torch.as_tensor(rng.integers(hi, size=500))
                for hi in (lr.n_layers, tt.n_routers, tt.n_routers))
    assert torch.equal(ct.lookup(li, s, t), lr.nh[li, s, t])
    np.testing.assert_array_equal(
        ct.lookup(li, s, t).numpy(),
        exp.compressed.lookup(li.numpy(), s.numpy(), t.numpy()))
    assert ct.nbytes < lr.nh.numel() * 4


def test_compressed_auto_block_halves_for_ft2_spine():
    jt = j_topo.two_layer_fat_tree(300, 4, 2)
    tt = topology.two_layer_fat_tree(300, 4, 2)
    ec_j = j_transport.ecmp_routing(jt, n_tables=2, seed=0)
    ec_t = transport.ecmp_routing(tt, n_tables=2, seed=0, device="cpu")
    np.testing.assert_array_equal(ec_t.nh.numpy(), ec_j.nh)
    ct = paths.CompressedTables.from_dense(ec_t.nh)
    exp = j_paths.CompressedTables.from_dense(ec_j.nh)
    assert ct.block < 512
    _same_compressed(ct, exp)
    assert torch.equal(ct.dense(), ec_t.nh)
    with pytest.raises(ValueError, match="uint8"):
        paths.CompressedTables.from_dense(ec_t.nh, block=512)


def test_walk_and_prepare_off_compressed_tables(sf5):
    jt, tt = sf5
    exp = j_layers.build_layers(jt, 4, 0.6, seed=1,
                                representation="compressed")
    lr_c = _routing(tt, exp)
    lr_d = dataclasses.replace(lr_c, compressed=None)
    rng = np.random.default_rng(7)
    li, s, t = (rng.integers(hi, size=200)
                for hi in (lr_c.n_layers, tt.n_routers, tt.n_routers))
    w_c = paths.walk_paths_layers(lr_c.compressed, li, s, t, 16)
    np.testing.assert_array_equal(w_c, paths.walk_paths_layers(lr_d.nh, li,
                                                               s, t, 16))
    np.testing.assert_array_equal(
        w_c, j_paths.walk_paths_layers(exp.compressed, li, s, t, 16))
    wl = j_traffic.make_workload(jt, "permutation", seed=3)
    cfg = j_transport.SimConfig()
    jarrs, static = j_transport.prepare(jt, exp, wl, cfg)
    t_wl = interop.workload_from_arrays(_fields(wl))
    t_cfg = interop.config_from_dict(dataclasses.asdict(cfg))
    arrs_c, stat_c = transport.prepare(tt, lr_c, t_wl, t_cfg, device="cpu")
    arrs_d, stat_d = transport.prepare(tt, lr_d, t_wl, t_cfg, device="cpu")
    assert stat_c == stat_d == static
    for k in ("path_edges", "routed", "path_hops", "usable", "plan_offsets",
              "plan_entries"):
        assert torch.equal(arrs_c[k], arrs_d[k]), k
    for k in ("path_edges", "routed"):
        np.testing.assert_array_equal(arrs_c[k].numpy(), np.asarray(jarrs[k]))


@pytest.mark.parametrize("mode", ["repair", "drop"])
def test_apply_failures_on_compressed_stack(sf5, monkeypatch, mode):
    jt, tt = sf5
    monkeypatch.setenv("REPRO_PATH_ENGINE", "blocked")
    lr = j_layers.build_layers(jt, 4, 0.6, seed=3)
    t_lr = _routing(tt, lr)
    assert t_lr.compressed is not None
    adj = np.asarray(jt.adj, bool)
    # The seeded masks kill both directions of a link; the third kills
    # single directions, so the masked union is asymmetric and the
    # repair's frontier APSP must relax over its in-neighbors.
    one_way = adj & (np.random.default_rng(5).random(adj.shape) < 0.15)
    for seed, rate, pattern in ((3, 0.1, "bernoulli"), (1, 0.2, "switch"),
                                (2, 0.15, "one-way")):
        dead = (one_way if pattern == "one-way" else
                JF.failure_mask(JF.scenario_key(seed, 0), adj, rate, pattern))
        exp_lr, exp_rep = JF.apply_failures(lr, dead, mode=mode, seed=seed,
                                            rate=rate, pattern=pattern)
        got_lr, got_rep = TF.apply_failures(t_lr, dead, mode=mode, seed=seed,
                                            rate=rate, pattern=pattern)
        assert got_rep == TF.FailureReport(**dataclasses.asdict(exp_rep))
        _same_tables(got_lr, exp_lr)
        _same_compressed(got_lr.compressed, exp_lr.compressed)
        assert torch.equal(got_lr.compressed.dense(), got_lr.nh)
        chk = got_lr.validate_loop_free(n_samples=10 ** 9,
                                        raise_on_fail=False)
        assert dataclasses.astuple(chk) == dataclasses.astuple(
            exp_lr.validate_loop_free(n_samples=10 ** 9,
                                      raise_on_fail=False))
        assert chk.exhaustive
        plain, _ = TF.apply_failures(dataclasses.replace(t_lr,
                                                         compressed=None),
                                     dead, mode=mode, seed=seed)
        assert plain.compressed is None


def test_layer_disjoint_paths_off_compressed_tables(sf5):
    jt, tt = sf5
    exp = j_layers.build_layers(jt, 9, 0.6, seed=4,
                                representation="compressed")
    lr = _routing(tt, exp)
    rng = np.random.default_rng(4)
    s = rng.integers(tt.n_routers, size=40)
    t = (s + 1 + rng.integers(tt.n_routers - 1, size=40)) % tt.n_routers
    got = layers.layer_disjoint_paths_batch(lr, s, t)
    np.testing.assert_array_equal(got,
                                  j_layers.layer_disjoint_paths_batch(exp, s,
                                                                      t))
    np.testing.assert_array_equal(
        got, layers.layer_disjoint_paths_batch(
            dataclasses.replace(lr, compressed=None), s, t))


@pytest.mark.parametrize("routing", ["fatpaths(n_layers=9,rho=0.6)", "ecmp"])
def test_session_cell_under_blocked_engine(monkeypatch, routing):
    monkeypatch.setenv("REPRO_PATH_ENGINE", "blocked")
    ts = Session(device="cpu")
    ref = JSession().run("sf(q=5)", routing, "permutation",
                         "transport(steps=400)")
    port = ts.run("sf(q=5)", routing, "permutation", "transport(steps=400)")
    assert compare_results([ref], [port], rtol=0) == []
    assert ts.routing("sf(q=5)", routing).routing.compressed is not None
    # The same session under the dense engine builds its own stack.
    monkeypatch.setenv("REPRO_PATH_ENGINE", "dense")
    assert ts.routing("sf(q=5)", routing).routing.compressed is None
