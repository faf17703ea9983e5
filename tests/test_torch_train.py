"""The port's optimizer and gradients (``repro_torch.train.optimizer``,
``train_step.loss_and_grads``, ``models.model.loss_fn``, remat and
``cast_cotangent_bf16``) against the JAX package's, on the CPU.

Both sides start from the JAX package's parameters (carried across by
``repro_torch.interop``) and take the same numpy tokens.  Tolerances:

* the schedule within 4 f32 ulps (torch's and XLA's ``cos`` may differ
  in the last bit, which ``0.5 (1 + cos)`` magnifies near the end of the
  decay), bitwise through the warmup; ``global_norm`` and the clip at
  rtol 1e-6 (the sums run in another order);
* ``adamw_update`` on a mixed tree with bf16 gradients: parameters within
  1 f32 ulp, moments within 1e-6 of their leaf's largest value (a 1-ulp
  difference in the global norm reaches every clipped gradient);
* f32 compute: loss rtol 1e-5, f32 gradients within 1e-5 of each leaf's
  largest, the bf16 wire gradients within one bf16 ulp (2^-7 relative)
  of the JAX package's;
* bf16 compute (yi-9b smoke, ``remat="full"``): loss within 2e-2 and
  grad norm within 5e-2 after each of two steps (bf16 rounds at other
  places in the two frameworks).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import Runtime as JRuntime
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.dist.sharding import Runtime
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

JRT, TRT = JRuntime(mesh=None), Runtime()
ARCHS = ["yi-9b", "gemma2-27b", "glm4-9b"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)


def jparams(cfg, seed=0):
    return jax.jit(lambda key: jmodel.init_params(cfg, JRT, key))(
        jax.random.PRNGKey(seed))


def port_params(cfg, jp):
    return interop.model_params_from_arrays(
        cfg, jax.tree.map(np.asarray, jp), "cpu")


def jflat(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def tflat(tree):
    return [x.detach().float().numpy() for x in topt.tree_leaves(tree)]


def tokens(vocab, b, s, seed):
    """The same numpy tokens as the JAX package's batch and the port's."""
    t = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    tt = torch.from_numpy(t.astype(np.int64))
    return {"tokens": jnp.asarray(t), "labels": jnp.asarray(t)}, \
        {"tokens": tt, "labels": tt}


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


# ---- the optimizer -----------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(lr=1e-3, warmup_steps=3, total_steps=20),
                                dict(lr=3e-4, warmup_steps=100,
                                     total_steps=10_000, min_lr_frac=0.05),
                                dict(warmup_steps=0, total_steps=5)])
def test_schedule_matches_reference(kw):
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    for step in list(range(0, 30)) + [99, 100, 101, 5000, 10_000, 12_000]:
        got = topt.schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        n = ulps(got.numpy(), jopt.schedule(jc, jnp.asarray(step)))
        assert n <= (0 if step <= kw["warmup_steps"] else 4), (step, n)


def mixed_tree(rng):
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"blocks": {"0": {"ln1": {"scale": a(2, 8)},
                             "attn": {"wq": a(2, 8, 4), "bq": a(2, 4)},
                             "mlp": {"wo": a(2, 6, 8)}}},
            "embed": {"tok": a(16, 8)}, "final_norm": {"scale": a(8)},
            "lm_head": {"w": a(8, 16)}}


def as_torch(tree):
    def t(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(t, tree)


def test_global_norm_and_clip():
    tree = mixed_tree(np.random.default_rng(0))
    wq = tree["blocks"]["0"]["attn"]
    wq["wq"] = wq["wq"].astype(ml_dtypes.bfloat16)
    jt, tt = jax.tree.map(jnp.asarray, tree), as_torch(tree)
    np.testing.assert_allclose(float(topt.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        jc, jn = jopt.clip_by_global_norm(jt, max_norm)
        tcl, tn = topt.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for got, exp in zip(tflat(tcl), jflat(jc)):
            np.testing.assert_allclose(got, exp, rtol=2e-6, atol=0)
        assert tcl["blocks"]["0"]["attn"]["wq"].dtype == torch.bfloat16


def test_decay_mask():
    assert topt._decay_mask(("blocks", "0", "attn", "wq"))
    assert topt._decay_mask(("blocks", "0", "attn", "bq"))   # as the JAX one
    for path in (("blocks", "0", "ln1", "scale"), ("final_norm", "scale"),
                 ("blocks", "0", "ln2_post", "scale"), ("x", "bias")):
        assert not topt._decay_mask(path)


def test_adamw_update_matches_reference():
    """Four steps on a mixed tree (decayed matrices, undecayed norms),
    with bf16 gradients as the wire delivers them."""
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=20)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    p = mixed_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p), as_torch(p)
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    for _ in range(4):
        g = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16),
                         mixed_tree(rng))
        jp, jst, jm = jopt.adamw_update(jc, jp, jax.tree.map(jnp.asarray, g),
                                        jst)
        tp, tst, tm = topt.adamw_update(tc, tp, as_torch(g), tst)
        assert int(tst["step"]) == int(jst["step"])
        assert ulps(tm["lr"].numpy(), jm["lr"]) == 0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, exp in zip(tflat(tp), jflat(jp)):
            assert ulps(got, exp) <= 1
        for name in ("m", "v"):
            for got, exp in zip(tflat(tst[name]), jflat(jst[name])):
                np.testing.assert_allclose(
                    got, exp, rtol=0, atol=1e-6 * np.abs(exp).max())


def test_optimizer_state_carried_across_from_reference():
    """The JAX package's state after two steps, carried into the port by
    ``interop.opt_state_from_arrays`` (the error-feedback residual too),
    continues as the JAX package's does."""
    rng = np.random.default_rng(2)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, mixed_tree(rng))
    jst = jopt.adamw_init(jp)
    jst["ef"] = jopt.ef_init(jp)
    for _ in range(2):
        jp, jst, _ = jopt.adamw_update(
            jc, jp, jax.tree.map(jnp.asarray, mixed_tree(rng)), jst)
    tp = as_torch(jax.tree.map(np.asarray, jp))
    tst = interop.opt_state_from_arrays(jax.tree.map(np.asarray, jst),
                                        "cpu")
    assert tst["step"].dtype == torch.int32 and int(tst["step"]) == 2
    assert sorted(tst) == ["ef", "m", "step", "v"]
    g = mixed_tree(rng)
    jp, jst, jm = jopt.adamw_update(jc, jp, jax.tree.map(jnp.asarray, g),
                                    jst)
    tp, tst, tm = topt.adamw_update(tc, tp, as_torch(g), tst)
    assert ulps(tm["lr"].numpy(), jm["lr"]) == 0
    for got, exp in zip(tflat(tp), jflat(jp)):
        assert ulps(got, exp) <= 1
    for got, exp in zip(tflat(tst["ef"]), jflat(jst["ef"])):
        np.testing.assert_array_equal(got, exp)


# ---- gradients -------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jgrad(arch):
    cfg = jconfigs.get_smoke(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg, JRT, b), has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg = jconfigs.get_smoke(arch)
    jp = jparams(cfg)
    tcfg = tconfigs.get_smoke(arch)
    tp = port_params(tcfg, jp)
    jb, tb = tokens(cfg.vocab, 4, 32, seed=2)
    (jl, jaux), jg = jgrad(arch)(jp, jb)
    tl, taux, tg = tts.loss_and_grads(tp, tcfg, TRT, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5)
    for got, exp in zip(tflat(tg), jflat(jg)):
        np.testing.assert_allclose(got, exp, rtol=0,
                                   atol=1e-5 * np.abs(exp).max())
    # The wire cast: one bf16 ulp apart at most.
    wire = topt.tree_map(TRT.astype, tg)
    for got, exp in zip(topt.tree_leaves(wire),
                        jflat(jax.tree.map(JRT.astype, jg))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), exp, rtol=2 ** -7,
                                   atol=1e-6 * np.abs(exp).max())


def test_bf16_full_remat_train_step():
    """yi-9b smoke in bf16 compute with full rematerialisation: the same
    two steps as the JAX package's within bf16's rounding."""
    cfg = dataclasses.replace(jconfigs.get_smoke("yi-9b"), dtype="bfloat16",
                              remat="full")
    tcfg = dataclasses.replace(tconfigs.get_smoke("yi-9b"),
                               dtype="bfloat16", remat="full")
    jp = jparams(cfg)
    tp = port_params(tcfg, jp)
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    jstep = jax.jit(jts.make_train_step(cfg, JRT, jts.TrainConfig(
        opt=jopt.AdamWConfig(**OPT))))
    tstep = tts.make_train_step(tcfg, TRT, tts.TrainConfig(
        opt=topt.AdamWConfig(**OPT)))
    for i in range(2):
        jb, tb = tokens(cfg.vocab, 4, 32, seed=20 + i)
        jp, jst, jm = jstep(jp, jst, jb, jax.random.PRNGKey(i))
        tp, tst, tm = tstep(tp, tst, tb, i)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-2)


def test_remat_full_equals_none_and_dots_raises():
    """``remat="full"`` (nothing saved in a unit) and ``"dots"`` (the
    weight products' outputs saved) give the loss and every gradient of
    ``"none"`` bitwise; serving never rematerialises."""
    cfg = tconfigs.get_smoke("gemma2-27b")
    jp = jparams(jconfigs.get_smoke("gemma2-27b"))
    _, tb = tokens(cfg.vocab, 2, 24, seed=3)
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = tts.loss_and_grads(port_params(c, jp), c, TRT, tb)
    for remat in ("full", "dots"):
        assert torch.equal(out["none"][0], out[remat][0])
        for a, b in zip(topt.tree_leaves(out["none"][2]),
                        topt.tree_leaves(out[remat][2])):
            assert torch.equal(a, b)
    c = dataclasses.replace(cfg, remat="dots")
    with torch.no_grad():    # serving never rematerialises
        tmodel.forward(port_params(c, jp), c, TRT, tb)


def test_cast_cotangent_bf16():
    x = torch.randn(3, 4, requires_grad=True)
    y = tcommon.cast_cotangent_bf16(x)
    assert torch.equal(y, x) and y.dtype == torch.float32
    (g,) = torch.autograd.grad(y, (x,), torch.full((3, 4), 1 / 3))
    assert torch.equal(g, torch.full((3, 4), 1 / 3).to(torch.bfloat16)
                       .float())


def test_gradients_reach_the_stacked_leaves():
    """One stacked (R, ...) leaf a unit position: its gradient has every
    repeat's slice, and the caller's parameters never require grad."""
    cfg = tconfigs.get_smoke("yi-9b")
    tp = port_params(cfg, jparams(jconfigs.get_smoke("yi-9b")))
    _, tb = tokens(cfg.vocab, 2, 16, seed=4)
    _, _, g = tts.loss_and_grads(tp, cfg, TRT, tb)
    wq = g["blocks"]["0"]["attn"]["wq"]
    assert wq.shape == tp["blocks"]["0"]["attn"]["wq"].shape
    assert all(float(wq[j].abs().max()) > 0 for j in range(wq.shape[0]))
    assert not any(t.requires_grad for t in topt.tree_leaves(tp))
