"""Path-diversity metrics (§4.2, Appendix B): the port against the JAX
package, exactly.  CDP peeling, PI and TNL are host code fed by the same
seeded draws; the Cheung GF(p) matrix ``M`` is a float64 product whose
partial sums are exact integers, so it must be bitwise the reference's;
``diversity_report`` must agree field by field."""

import dataclasses

import numpy as np
import pytest

from repro.core import diversity as JD
from repro.experiments import Session as JSession
from repro_torch.core import diversity
from repro_torch.experiments import Session


@pytest.fixture(scope="module")
def topos():
    js, ts = JSession(), Session(device="cpu")
    return {k: (js.topology(k), ts.topology(k))
            for k in ("sf", "df", "sf(q=7)")}


@pytest.mark.parametrize("name", ["sf", "df"])
@pytest.mark.parametrize("l", [1, 2, 3, 5])
def test_cdp_peel_equal(topos, name, l):
    jt, tt = topos[name]
    rng = np.random.default_rng(l)
    n = tt.n_routers
    for _ in range(6):
        k = int(rng.integers(1, 4))
        nodes = rng.choice(n, size=2 * k, replace=False)
        a, b = nodes[:k], nodes[k:]
        got = diversity.cdp_peel(tt.adj, a, b, l, return_paths=True)
        assert got == JD.cdp_peel(jt.adj, a, b, l, return_paths=True)
    with pytest.raises(ValueError, match="disjoint"):
        diversity.cdp_peel(tt.adj, [0, 1], [1], l)


@pytest.mark.parametrize("name", ["sf", "df"])
def test_sampled_cdp_pi_and_tnl_equal(topos, name):
    jt, tt = topos[name]
    for l, seed in ((2, 0), (3, 5)):
        np.testing.assert_array_equal(
            diversity.cdp_pairs_sampled(tt, l, n_samples=20, seed=seed),
            JD.cdp_pairs_sampled(jt, l, n_samples=20, seed=seed))
        np.testing.assert_array_equal(
            diversity.pi_samples(tt, l, n_samples=12, seed=seed),
            JD.pi_samples(jt, l, n_samples=12, seed=seed))
    assert diversity.path_interference(tt.adj, 0, 9, 3, 17, 3) == \
        JD.path_interference(jt.adj, 0, 9, 3, 17, 3)
    assert diversity.total_network_load(tt, device="cpu") == \
        JD.total_network_load(jt)
    assert diversity.total_network_load(tt, 2.5) == \
        JD.total_network_load(jt, 2.5)


def test_rank_gf_equal():
    rng = np.random.default_rng(0)
    for p in (2, 7, diversity.GF_PRIME):
        for shape in ((1, 1), (3, 5), (6, 4), (7, 7)):
            m = rng.integers(0, p, size=shape).astype(np.float64)
            m[rng.random(shape) < 0.3] = 0
            assert diversity._rank_gf(m, p) == JD._rank_gf(m, p)


@pytest.mark.parametrize("name,max_len", [("sf", 1), ("sf", 3), ("sf(q=7)", 3)])
def test_gf_connectivity_bitwise(topos, name, max_len):
    jt, tt = topos[name]
    exp = JD.GFConnectivity.build(jt.adj, max_len=max_len)
    got = diversity.GFConnectivity.build(tt.adj, max_len=max_len,
                                         device="cpu")
    assert got.M.dtype == exp.M.dtype == np.float64
    np.testing.assert_array_equal(got.M.view(np.int64), exp.M.view(np.int64))
    np.testing.assert_array_equal(got.edges, exp.edges)
    assert (got.p, got.max_len) == (exp.p, exp.max_len)
    for a, b in ((got.out_edges, exp.out_edges), (got.in_edges, exp.in_edges)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    rng = np.random.default_rng(0)
    pairs = [tuple(int(v) for v in rng.choice(tt.n_routers, 2, replace=False))
             for _ in range(64)]
    np.testing.assert_array_equal(got.query_pairs(pairs),
                                  exp.query_pairs(pairs))


def test_gf_connectivity_raises_above_4096_edges():
    js, ts = JSession(), Session(device="cpu")
    jt, tt = js.topology("sf(q=11)"), ts.topology("sf(q=11)")
    assert int(tt.adj.sum()) == 4114
    with pytest.raises(ValueError, match="E_dir=4114"):
        JD.GFConnectivity.build(jt.adj, max_len=3)
    with pytest.raises(ValueError, match="E_dir=4114"):
        diversity.GFConnectivity.build(tt.adj, max_len=3, device="cpu")


@pytest.mark.parametrize("name", ["sf", "df"])
def test_diversity_report_field_by_field(topos, name):
    jt, tt = topos[name]
    exp = dataclasses.asdict(JD.diversity_report(jt))
    got = dataclasses.asdict(diversity.diversity_report(tt, device="cpu"))
    assert list(got) == list(exp)
    for k in exp:
        assert got[k] == exp[k] and type(got[k]) is type(exp[k]), k


def test_diversity_report_given_d_prime_equal(topos):
    jt, tt = topos["sf"]
    kw = dict(n_cdp=30, n_pi=20, seed=3, d_prime=3)
    assert dataclasses.asdict(diversity.diversity_report(tt, device="cpu",
                                                         **kw)) == \
        dataclasses.asdict(JD.diversity_report(jt, **kw))
