"""The pi_min layer scheme and the rest of the routing layer against the
JAX package: the permutation and the probabilities' sum it needs, the
edge-usage fixpoint, the pi_min stacks (bitwise), and the loop check,
disjoint paths, forwarding functions and path helpers on every scheme."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import layers as j_layers
from repro.core import paths as j_paths
from repro.core import routing as j_routing
from repro.core import topology as j_topo
from repro.experiments import Session as JSession
from repro.experiments.results import compare_results
from repro_torch import prng
from repro_torch.core import layers, paths, routing, topology
from repro_torch.experiments import Session

SCHEMES = ("rand", "undir", "spain", "past", "ksp", "pi_min")
TOPOS = {"sf5": lambda m: m.slim_fly(5),
         "jf": lambda m: m.jellyfish(50, 6, 3, seed=0),
         "xp": lambda m: m.xpander(8, seed=0),
         "df": lambda m: m.dragonfly(3)}
TABLES = ("layer_adj", "nh", "reach", "pathlen")


@pytest.mark.parametrize("n", [1, 2, 50, 722, 2000, 5000])
@pytest.mark.parametrize("seed", range(20))
def test_permutation_bits_equal_jax(seed, n):
    """One sort round up to n = 1625, two above (2000, 5000)."""
    exp = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = prng.permutation(prng.PRNGKey(seed, "cpu"), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), exp)


_SUM_LENGTHS = [1, 2, 31, 32, 33, 64, 65, 1023, 1024, 1025, 1056, 1057,
                10509, 20000]
_SUM_LENGTHS += [int(x) for x in
                 np.random.default_rng(0).integers(3, 20000, 50 - 14)]


@pytest.mark.parametrize("i", range(50))
def test_xla_sum_is_xla_cpu_order(i):
    """``layers.xla_sum`` equals ``jax.jit(jnp.sum)`` bitwise on f32
    vectors of lengths 1-20 000, integer-like and wide-ranged alike;
    ``torch.sum`` does not on many of them."""
    n = _SUM_LENGTHS[i]
    rng = np.random.default_rng(100 + i)
    x = (rng.random(n) * 10.0 ** rng.integers(-3, 5, n)).astype(np.float32)
    if i % 3 == 0:                      # the keep-probabilities' shape
        x = (1.0 - 0.75 * np.floor(rng.random(n) * 50) / 49).astype(
            np.float32)
    exp = np.float32(jax.jit(jnp.sum)(x))
    got = layers.xla_sum(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == exp.tobytes()


@pytest.fixture(scope="module")
def stacks():
    """sf(q=5) stacks of every scheme, from both packages."""
    jt, tt = j_topo.slim_fly(5), topology.slim_fly(5)
    out = {}
    for scheme in SCHEMES:
        out[scheme] = (j_layers.build_layers(jt, 5, 0.6, scheme=scheme,
                                             seed=3),
                       layers.build_layers(tt, 5, 0.6, scheme=scheme, seed=3,
                                           device="cpu"))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_stacks_equal_and_edge_usage_bitwise(stacks, scheme):
    jr, tr = stacks[scheme]
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    for max_hops in (3, 8):
        exp = np.asarray(j_paths.edge_usage_batched(
            jnp.asarray(jr.nh), jnp.asarray(jr.reach), max_hops))
        got = paths.edge_usage_batched(jr.nh, jr.reach, max_hops,
                                       device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_pi_min_stack_bitwise(topo, seed):
    jt, tt = TOPOS[topo](j_topo), TOPOS[topo](topology)
    exp = j_layers.build_layers(jt, 9, 0.6, scheme="pi_min", seed=seed)
    got = layers.build_layers(tt, 9, 0.6, scheme="pi_min", seed=seed,
                              device="cpu")
    assert got.scheme == "pi_min" and got.n_layers == 9
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(exp, name)),
                                      err_msg=name)
    assert int(got.layer_adj[1:].sum()) < int(got.layer_adj[0].sum()) * 8


def test_pi_min_keep_margin_printed():
    """Replays the sf(q=5) build's keep decisions and prints the smallest
    margin |u - prob| over all edges and layers: a one-ulp difference in
    ``prob`` would flip a decision only inside that margin."""
    tt = topology.slim_fly(5)
    lr = layers.build_layers(tt, 9, 0.6, scheme="pi_min", seed=0,
                             device="cpu")
    iu, ju = (torch.as_tensor(x) for x in np.nonzero(np.triu(tt.adj, 1)))
    e = len(iu)
    _, krest = prng.split(prng.PRNGKey(0, "cpu"))
    usage = paths.edge_usage_batched(lr.nh[:1], lr.reach[:1], 6,
                                     device="cpu")[0]
    margin = np.inf
    for li, k in enumerate(prng.split(krest, 8), start=1):
        _, k_keep, _ = prng.split(k, 3)
        u_sym = usage + usage.T
        norm = u_sym / u_sym.max()
        raw = (1.0 - 0.75 * norm[iu, ju].double()).float()
        prob = raw * (float(np.float32(0.6) * np.float32(e))
                      / layers.xla_sum(raw))
        u = prng.uniform(k_keep, (e,))
        keep = u < prob.clamp(0, 1)
        kept = lr.layer_adj[li][iu, ju] | lr.layer_adj[li][ju, iu]
        assert torch.equal(keep, kept)
        margin = min(margin, float((u - prob).abs().min()))
        usage = usage + paths.edge_usage_batched(
            lr.nh[li:li + 1], lr.reach[li:li + 1], 6, device="cpu")[0]
    print(f"smallest |u - prob| over 8 layers x {e} edges: {margin:.3g}")
    assert margin > 0


def test_pi_min_cell_tcp_adversarial():
    cell = ("sf", "fatpaths(n_layers=9,rho=0.6,scheme=pi_min)", "adversarial",
            "transport(steps=400,transport=tcp)")
    ref = JSession().run(*cell)
    got = Session(device="cpu").run(*cell)
    assert compare_results([ref], [got], rtol=0) == []


def _report(r):
    return (r.ok, r.n_checked, r.exhaustive, r.witnesses, r.kinds,
            r.describe())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_loop_check_disjoint_paths_and_forwarding(stacks, scheme):
    jr, tr = stacks[scheme]
    for kw in ({}, {"n_samples": 10 ** 6}, {"n_samples": 500, "seed": 4,
                                            "max_hops": 3,
                                            "raise_on_fail": False}):
        assert _report(tr.validate_loop_free(**kw)) == \
            _report(jr.validate_loop_free(**kw))
    rng = np.random.default_rng(1)
    s, t = rng.integers(50, size=60), rng.integers(50, size=60)
    np.testing.assert_array_equal(
        layers.layer_disjoint_paths_batch(tr, s, t),
        j_layers.layer_disjoint_paths_batch(jr, s, t))
    assert layers.layer_disjoint_paths(tr, 3, 41, 4) == \
        j_layers.layer_disjoint_paths(jr, 3, 41, 4)
    assert routing.vlan_layers_required(tr) == \
        j_routing.vlan_layers_required(jr) == 5
    for li in range(tr.n_layers):
        fj = j_routing.ForwardingFunction(jr, li)
        ft = routing.ForwardingFunction(tr, li)
        for a, b in zip(s[:12], t[:12]):
            a, b = int(a), int(b)
            assert ft(a, b) == fj(a, b)
            try:
                exp = fj.route(a, b)
            except (LookupError, RuntimeError) as err:
                with pytest.raises(type(err)):
                    ft.route(a, b)
            else:
                assert ft.route(a, b) == exp


def test_loop_check_names_the_same_bad_entries(stacks):
    jr, tr = stacks["pi_min"]
    nh = np.array(jr.nh)
    reach = np.asarray(jr.reach)
    hole = next((s, t) for s in range(50) for t in range(50)
                if s != t and reach[1, s, t] and nh[1, s, t] != t)
    nh[(1,) + hole] = -1
    # Two routers that forward to each other: a loop.
    s, t = next((s, t) for s in range(50) for t in range(50)
                if reach[2, s, t] and nh[2, s, t] not in (-1, s, t))
    nh[2, nh[2, s, t], t] = s
    exp = dataclasses.replace(jr, nh=nh).validate_loop_free(
        n_samples=10 ** 6, raise_on_fail=False)
    bad = dataclasses.replace(tr, nh=torch.as_tensor(nh))
    got = bad.validate_loop_free(n_samples=10 ** 6, raise_on_fail=False)
    assert not got.ok and _report(got) == _report(exp)
    assert set(got.kinds) == {"hole", "loop"}
    with pytest.raises(AssertionError, match="bad forwarding"):
        bad.validate_loop_free(n_samples=10 ** 6)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_path_helpers_on_layer_graphs(stacks, scheme):
    """next_hop_options, build_forwarding, diameter and
    average_path_length on the whole graph and on layer 1 of each
    scheme (a directed DAG for rand and pi_min)."""
    jr, _ = stacks[scheme]
    for adj in (np.asarray(jr.layer_adj[0]), np.asarray(jr.layer_adj[1])):
        for max_l in (4, 64):
            np.testing.assert_array_equal(
                paths.next_hop_options(adj, max_l=max_l, device="cpu"),
                j_paths.next_hop_options(adj, max_l=max_l))
            assert paths.diameter(adj, max_l, device="cpu") == \
                j_paths.diameter(adj, max_l)
            assert paths.average_path_length(adj, max_l, device="cpu") == \
                j_paths.average_path_length(adj, max_l)
        for seed in (0, 7):
            got = paths.build_forwarding(adj, seed=seed, max_l=6,
                                         device="cpu")
            exp = j_paths.build_forwarding(adj, seed=seed, max_l=6)
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)
        dist = np.asarray(j_paths.shortest_path_lengths(jnp.asarray(adj)))
        np.testing.assert_array_equal(
            paths.build_forwarding(adj, dist, seed=2, device="cpu"),
            j_paths.build_forwarding(adj, dist, seed=2))
        s = np.arange(50)
        t = (s * 7 + 3) % 50
        np.testing.assert_array_equal(
            paths.walk_paths(jr.nh[1], s, t, 9, device="cpu"),
            j_paths.walk_paths(jr.nh[1], s, t, 9))
