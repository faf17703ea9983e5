"""The port's tables against the JAX package's: distances, next hops,
reach and the whole layer stacks must be bitwise equal (integer outputs,
with tie-breaks from the same threefry stream)."""

import numpy as np
import pytest
import jax
import torch

from repro.core import layers as j_layers
from repro.core import paths as j_paths
from repro.core import topology as j_topo
from repro.core import transport as j_transport
from repro_torch import prng
from repro_torch.core import layers, paths, topology, transport

TOPOS = {"sf5": lambda m: m.slim_fly(5), "df3": lambda m: m.dragonfly(3)}


@pytest.fixture(scope="module", params=sorted(TOPOS))
def topo_pair(request):
    build = TOPOS[request.param]
    return build(j_topo), build(topology)


def test_topology_copy_is_identical(topo_pair):
    jt, tt = topo_pair
    np.testing.assert_array_equal(jt.adj, tt.adj)
    np.testing.assert_array_equal(jt.concentration, tt.concentration)
    assert (jt.name, jt.diameter_nominal) == (tt.name, tt.diameter_nominal)
    np.testing.assert_array_equal(jt.edge_index_matrix(),
                                  tt.edge_index_matrix())


def test_shortest_paths_and_neighbor_table(topo_pair):
    jt, tt = topo_pair
    np.testing.assert_array_equal(
        np.asarray(j_paths.shortest_path_lengths(jax.numpy.asarray(jt.adj))),
        paths.shortest_path_lengths(tt.adj, device="cpu").numpy())
    np.testing.assert_array_equal(j_paths.neighbor_table(jt.adj),
                                  paths.neighbor_table(tt.adj))


@pytest.mark.parametrize("seed", [0, 5])
def test_layer_tables_batched(topo_pair, seed):
    """A random stack of sparsified directed layers: dist, nh and reach
    from one batched pass, bitwise."""
    jt, _ = topo_pair
    rng = np.random.default_rng(seed)
    adj = np.asarray(jt.adj, bool)
    stack = np.stack([adj] + [adj & (rng.random(adj.shape) < 0.6)
                              for _ in range(3)])
    nh_j, reach_j, dist_j = j_paths.layer_tables_batched(
        stack, jax.random.PRNGKey(seed), max_l=8)
    nh_t, reach_t, dist_t = paths.layer_tables_batched(
        stack, prng.PRNGKey(seed, "cpu"), max_l=8, device="cpu")
    for a, b in ((nh_j, nh_t), (reach_j, reach_t), (dist_j, dist_t)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    d_j = j_paths.apsp_batched(stack, max_l=8)
    d_t = paths.apsp_batched(stack, max_l=8, device="cpu")
    np.testing.assert_array_equal(np.asarray(d_j), d_t.numpy())
    f_j = j_paths.forwarding_batched(stack, d_j, jax.random.PRNGKey(seed + 1))
    f_t = paths.forwarding_batched(stack, d_t, prng.PRNGKey(seed + 1, "cpu"),
                                   device="cpu")
    np.testing.assert_array_equal(np.asarray(f_j), f_t.numpy())


@pytest.mark.parametrize("scheme", ["rand", "undir", "spain", "past", "ksp",
                                    "pi_min"])
def test_build_layers_bitwise(topo_pair, scheme):
    jt, tt = topo_pair
    a = j_layers.build_layers(jt, 5, 0.6, scheme=scheme, seed=3)
    b = layers.build_layers(tt, 5, 0.6, scheme=scheme, seed=3, device="cpu")
    for f in ("nh", "reach", "pathlen", "layer_adj"):
        x, y = getattr(a, f), getattr(b, f).numpy()
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert b.n_layers == a.n_layers == 5
    np.testing.assert_array_equal(a.usable_layers(0, 7),
                                  b.usable_layers(0, 7))


@pytest.mark.parametrize("n_tables,seed", [(8, 0), (3, 11)])
def test_ecmp_routing_bitwise(topo_pair, n_tables, seed):
    jt, tt = topo_pair
    a = j_transport.ecmp_routing(jt, n_tables=n_tables, seed=seed)
    b = transport.ecmp_routing(tt, n_tables=n_tables, seed=seed,
                               device="cpu")
    for f in ("nh", "reach", "pathlen", "layer_adj"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("n_layers,seed", [(1, 0), (4, 7)])
def test_minplus_apsp_batched_bitwise(topo_pair, n_layers, seed):
    """Perturbed unit weights, as the ksp scheme draws them, through the
    (min, +) squarings; and a one-layer ksp stack (zero weight layers)."""
    jt, tt = topo_pair
    adj = np.asarray(jt.adj, bool)
    rng = np.random.default_rng(seed)
    w = np.where(adj[None], 1.0 + 0.25 * rng.random((n_layers,) + adj.shape),
                 np.inf).astype(np.float32)
    w = np.minimum(w, w.transpose(0, 2, 1))
    w[:, np.arange(adj.shape[0]), np.arange(adj.shape[0])] = 0.0
    exp = np.asarray(j_paths.minplus_apsp_batched(jax.numpy.asarray(w),
                                                  max_l=6))
    got = paths.minplus_apsp_batched(w, max_l=6, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)
    a = j_layers.build_layers(jt, 1, 0.6, scheme="ksp", seed=seed)
    b = layers.build_layers(tt, 1, 0.6, scheme="ksp", seed=seed,
                            device="cpu")
    np.testing.assert_array_equal(a.nh, b.nh.numpy())


@pytest.mark.parametrize("l", [1, 2, 4])
def test_path_counts_exact_length_bitwise(topo_pair, l):
    jt, tt = topo_pair
    exp = np.asarray(j_paths.path_counts_exact_length(
        jax.numpy.asarray(jt.adj), l))
    got = paths.path_counts_exact_length(tt.adj, l, device="cpu")
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("max_l", [4, 8])
def test_min_path_stats_bitwise(topo_pair, max_l):
    jt, tt = topo_pair
    d_j, c_j = j_paths.min_path_stats(np.asarray(jt.adj), max_l=max_l,
                                      engine="dense")
    d_t, c_t = paths.min_path_stats(tt.adj, max_l=max_l, device="cpu")
    assert (d_t.dtype, c_t.dtype) == (d_j.dtype, c_j.dtype)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(c_t, c_j)


def test_unported_engines_and_schemes_raise(monkeypatch):
    """Both engines are ported: only an unknown engine raises, ``auto``
    resolves by size as the JAX package's does, and ``blocked`` builds
    what ``dense`` builds, with compressed tables attached."""
    tt = topology.slim_fly(5)
    monkeypatch.setenv("REPRO_PATH_ENGINE", "auto")
    assert paths.path_engine() == "dense"
    assert paths.path_engine(tt.n_routers) == j_paths.path_engine(
        tt.n_routers) == "dense"
    assert paths.path_engine(512) == j_paths.path_engine(512) == "blocked"
    dense = layers.build_layers(tt, 3, 0.6, device="cpu")
    d_d, c_d = paths.min_path_stats(tt.adj, 4, device="cpu")
    monkeypatch.setenv("REPRO_PATH_ENGINE", "blocked")
    blocked = layers.build_layers(tt, 3, 0.6, device="cpu")
    assert dense.compressed is None and blocked.compressed is not None
    assert torch.equal(blocked.nh, dense.nh)
    d_b, c_b = paths.min_path_stats(tt.adj, 4, device="cpu")
    np.testing.assert_array_equal(d_b, d_d)
    np.testing.assert_array_equal(c_b, c_d)
    monkeypatch.setenv("REPRO_PATH_ENGINE", "sparse")
    with pytest.raises(ValueError, match="unknown path engine"):
        paths.path_engine()


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt = topology.slim_fly(5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layers.build_layers(tt, 3, 0.6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transport.ecmp_routing(tt, n_tables=2)
