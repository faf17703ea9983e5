"""The port's train step (``repro_torch.train.train_step.
make_train_step``) against the JAX package's, on the CPU: two steps on
the smoke configs of yi-9b, gemma2-27b (softcaps, window, post-norms,
``embed_scale``) and glm4-9b (``qkv_bias``), with ``grad_accum`` 1 and 2
and ``compress="int8_ef"``, f32 compute, bf16 wire gradients.

Both sides start from the JAX package's parameters (carried across by
``repro_torch.interop``) and take the same numpy tokens.  Tolerances:
loss rtol 1e-5, grad norm rtol 2e-5, the learning rate bitwise;
parameters after the two steps: all but 1e-3 of the elements within
1e-6 + 2^-6 x the summed learning rates, every element within 1e-6 +
2.5 x.  Adam's update ``m / (sqrt(v) + eps)`` is about ``lr sign(g)``
whatever ``|g|``: a one-ulp flip of a bf16 wire gradient moves its
update by up to 2^-7 of ``lr``, and a gradient component within the two
sides' rounding of 0 (below ``eps``, or under int8 an ``x / scale`` on a
rounding half) may move by up to ``2 lr`` a step on one side only.
"""

import functools

import jax
import jax.numpy as jnp
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
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

JRT, TRT = JRuntime(mesh=None), Runtime()
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)
# Every (grad_accum, compress) pair on yi-9b, the other two configs on
# one step each way (glm4-9b's one-microbatch gradients are held in
# tests/test_torch_train.py).
STEP_CASES = [("yi-9b", 1, "none"), ("yi-9b", 2, "none"),
              ("yi-9b", 2, "int8_ef"), ("gemma2-27b", 1, "none"),
              ("gemma2-27b", 2, "int8_ef"), ("glm4-9b", 2, "int8_ef")]


@functools.lru_cache(maxsize=None)
def jstep(arch, ga, compress):
    cfg = jconfigs.get_smoke(arch)
    tc = jts.TrainConfig(opt=jopt.AdamWConfig(**OPT, compress=compress),
                         grad_accum=ga)
    return jax.jit(jts.make_train_step(cfg, JRT, tc))


def tokens(vocab, b, s, seed):
    t = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    tt = torch.from_numpy(t.astype(np.int64))
    return {"tokens": jnp.asarray(t), "labels": jnp.asarray(t)}, \
        {"tokens": tt, "labels": tt}


@pytest.mark.parametrize("arch,ga,compress", STEP_CASES)
def test_train_steps_match_reference(arch, ga, compress):
    cfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, JRT, key))(
        jax.random.PRNGKey(0))
    tp = interop.model_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp), "cpu")
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    if compress == "int8_ef":
        jst["ef"], tst["ef"] = jopt.ef_init(jp), topt.ef_init(tp)
    tstep = tts.make_train_step(tcfg, TRT, tts.TrainConfig(
        opt=topt.AdamWConfig(**OPT, compress=compress), grad_accum=ga))
    lr_sum = 0.0
    for i in range(2):
        jb, tb = tokens(cfg.vocab, 4, 32, seed=10 + i)
        jp, jst, jm = jstep(arch, ga, compress)(jp, jst, jb,
                                                jax.random.PRNGKey(i))
        tp, tst, tm = tstep(tp, tst, tb, i)
        lr_sum += float(tm["lr"])
        assert sorted(tm) == sorted(jm)
        assert int(tst["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-5)
        assert float(tm["lr"]) == float(jm["lr"])
    n_off = n_all = 0
    for got, exp in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        diff = np.abs(got.numpy() - np.asarray(exp))
        assert diff.max() <= 1e-6 + 2.5 * lr_sum, (arch, diff.max())
        n_off += int((diff > 1e-6 + lr_sum / 64).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
    if compress == "int8_ef":   # carried as the JAX package carries it
        assert all(not t.any() for t in topt.tree_leaves(tst["ef"]))
