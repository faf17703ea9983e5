"""Fault injection against the JAX package, called live on the same
inputs: failure masks (equal and nested in rate), the per-id uniforms,
churn schedules and their summaries, the scan's pure fault and recovery
helpers, the table-validity fixpoint, and degraded stacks in both modes,
bitwise."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import failures as JF
from repro.core import layers as j_layers
from repro.core import paths as j_paths
from repro.core import topology as j_topo
from repro.core import transport as j_transport
from repro_torch import interop
from repro_torch.core import failures as TF
from repro_torch.core import paths, transport

TOPOS = {"sf5": lambda: j_topo.slim_fly(5),
         "jf": lambda: j_topo.jellyfish(50, 6, 3, seed=0),
         "xp": lambda: j_topo.xpander(8, seed=0)}
RATES = (0.0, 0.05, 0.3, 1.0)
TABLES = ("nh", "reach", "pathlen", "layer_adj")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _keys(seed, fseed):
    return JF.scenario_key(seed, fseed), TF.scenario_key(seed, fseed, "cpu")


@pytest.fixture(scope="module")
def adjs():
    return {name: np.asarray(make().adj, bool) for name, make in TOPOS.items()}


@pytest.mark.parametrize("pattern", JF.PATTERNS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_failure_masks_equal_and_nested(adjs, topo, pattern):
    adj = adjs[topo]
    for seed in (0, 1):
        for fseed in (0, 3):
            jk, tk = _keys(seed, fseed)
            np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                          tk.numpy())
            prev = np.zeros_like(adj)
            for rate in RATES:
                exp = JF.failure_mask(jk, adj, rate, pattern)
                got = TF.failure_mask(tk, adj, rate, pattern)
                np.testing.assert_array_equal(got, exp,
                                              err_msg=f"{seed} {fseed} {rate}")
                assert (prev <= got).all() and (got == got.T).all()
                assert not (got & ~adj).any()
                prev = got
            assert prev.any() and not TF.failure_mask(tk, adj, 0.0,
                                                      pattern).any()


@pytest.mark.parametrize("m", [None, 1, 8])
def test_link_uniforms_bits_equal(m):
    ids = np.array([0, 1, 7, 2 ** 20 + 3, 2 ** 32 - 1, 123456789],
                   dtype=np.int64)
    jk, tk = _keys(2, 5)
    if m is None:
        exp, got = JF.link_uniforms(jk, ids), TF.link_uniforms(tk, ids)
    else:
        exp = JF.link_uniforms_m(jk, ids, m)
        got = TF.link_uniforms_m(tk, ids, m)
    assert got.dtype == np.float64 and got.shape == exp.shape
    np.testing.assert_array_equal(got.view(np.int64), exp.view(np.int64))
    empty = TF.link_uniforms(tk, []) if m is None \
        else TF.link_uniforms_m(tk, [], m)
    assert empty.shape == ((0,) if m is None else (0, m))


@pytest.mark.parametrize("proc", ["exp", "pareto"])
@pytest.mark.parametrize("pattern", JF.CHURN_PATTERNS)
def test_churn_schedule_and_summary_equal(adjs, pattern, proc):
    adj = adjs["sf5"]
    for seed, rate in ((0, 0.1), (1, 0.3), (0, 0.0)):
        jk, tk = _keys(seed, 0)
        kw = dict(pattern=pattern, mtbf=30.0, mttr=12.0, events=3, proc=proc)
        exp = JF.churn_schedule(jk, adj, rate, **kw)
        got = TF.churn_schedule(tk, adj, rate, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, exp)
        assert TF.churn_summary(got) == JF.churn_summary(exp)
    assert TF.churn_summary(got)["churn_first_down"] == -1


def test_link_down_schedule_and_churn_state_equal():
    rng = np.random.default_rng(0)
    dead = rng.random((12, 12)) < 0.2
    np.testing.assert_array_equal(TF.link_down_schedule(dead, 17),
                                  JF.link_down_schedule(dead, 17))
    imax = np.iinfo(np.int32).max
    sched = np.sort(rng.integers(1, 60, size=(40, 3, 2)), axis=1)
    sched = np.sort(sched.reshape(40, 6), axis=1).reshape(40, 3, 2)
    sched[rng.random((40, 3)) < 0.3] = imax
    sched = sched.astype(np.int32)
    pick_at = np.minimum(sched[..., 1].astype(np.int64) + 5,
                         imax).astype(np.int32)
    for i in (0, 1, 7, 30, 59, 70):
        exp = j_transport._churn_state(i, jnp.asarray(sched),
                                       jnp.asarray(pick_at))
        got = transport._churn_state(i, torch.as_tensor(sched),
                                     torch.as_tensor(pick_at))
        for e, g in zip(exp, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("seed", range(4))
def test_rto_next_and_escape_layers_equal(seed):
    rng = np.random.default_rng(seed)
    f, n_layers = 64, 1 + seed * 3
    rto = rng.choice([16, 32, 64, 128, 256], size=f).astype(np.int32)
    delivered = rng.random(f) < 0.4
    backoff = rng.random(f) < 0.5
    exp = j_transport._rto_next(jnp.asarray(rto), jnp.asarray(delivered),
                                jnp.asarray(backoff), 16, 256)
    got = transport._rto_next(torch.as_tensor(rto),
                              torch.as_tensor(delivered),
                              torch.as_tensor(backoff), 16, 256)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    layer = rng.integers(n_layers, size=f).astype(np.int32)
    esc_ok = rng.random((f, n_layers)) < 0.3
    esc_ok[:4] = False
    exp = j_transport._escape_layers(jnp.asarray(layer), jnp.asarray(esc_ok))
    got = transport._escape_layers(torch.as_tensor(layer),
                                   torch.as_tensor(esc_ok))
    assert got[0].dtype == torch.int32
    for e, g in zip(exp, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.fixture(scope="module")
def stacks():
    topo = j_topo.slim_fly(5)
    t_topo = interop.topology_from_arrays(_fields(topo))
    out = {}
    for scheme in ("rand", "ksp", "pi_min"):
        lr = j_layers.build_layers(topo, 9, 0.6, scheme=scheme, seed=0)
        out[scheme] = (lr, interop.routing_from_arrays(t_topo, _fields(lr),
                                                       "cpu"))
    return topo, out


def test_table_validity_batched_bitwise(stacks):
    topo, out = stacks
    lr, t_lr = out["rand"]
    rng = np.random.default_rng(3)
    adj = np.asarray(topo.adj, bool)
    for frac, hops in ((0.0, 8), (0.1, 8), (0.3, 3), (0.3, 1)):
        alive = ~(rng.random(adj.shape) < frac)
        exp = np.asarray(j_paths.table_validity_batched(
            jnp.asarray(lr.nh), jnp.asarray(alive), hops))
        got = paths.table_validity_batched(t_lr.nh, alive, hops)
        np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("mode", ["repair", "drop"])
@pytest.mark.parametrize("scheme", ["rand", "ksp", "pi_min"])
def test_apply_failures_bitwise(stacks, scheme, mode):
    topo, out = stacks
    lr, t_lr = out[scheme]
    adj = np.asarray(topo.adj, bool)
    for seed, rate, pattern in ((0, 0.1, "bernoulli"), (1, 0.2, "switch"),
                                (0, 0.3, "blast")):
        jk, tk = _keys(seed, 0)
        dead = JF.failure_mask(jk, adj, rate, pattern)
        exp_lr, exp_rep = JF.apply_failures(lr, dead, mode=mode, seed=seed,
                                            rate=rate, pattern=pattern)
        got_lr, got_rep = TF.apply_failures(t_lr, dead, mode=mode, seed=seed,
                                            rate=rate, pattern=pattern)
        assert got_rep == TF.FailureReport(**dataclasses.asdict(exp_rep))
        assert got_rep.as_meta() == exp_rep.as_meta()
        for name in TABLES:
            np.testing.assert_array_equal(
                getattr(got_lr, name).numpy(), np.asarray(getattr(exp_lr,
                                                                  name)),
                err_msg=f"{name} {pattern}")
        assert got_lr.compressed is None and got_lr.build_stats is None
        if mode == "repair":
            got_lr.validate_loop_free(n_samples=2000)


def test_rate_zero_returns_the_same_stack(stacks):
    topo, out = stacks
    _, t_lr = out["rand"]
    dead = np.zeros_like(np.asarray(topo.adj, bool))
    for mode in ("repair", "drop"):
        got, rep = TF.apply_failures(t_lr, dead, mode=mode)
        assert got is t_lr
        assert rep.failed_links == 0 and rep.disconnected_pairs == 0
    with pytest.raises(ValueError, match="failure pattern"):
        TF.failure_mask(TF.scenario_key(0, 0, "cpu"), dead, 0.1, "nope")
