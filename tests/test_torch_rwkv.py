"""The port's RWKV6 block (``repro_torch.models.rwkv``) and the model's
``r`` block against the JAX package's, on the CPU.

rwkv6-7b's smoke config (d_model 64, 4 heads of 16, decay LoRA 16, d_ff
160) in f32, on the JAX package's own ``rwkv_init`` parameters carried
across as numpy arrays, and numpy inputs from a seed.  The JAX side runs
jitted on the CPU; its WKV recurrence (a ``lax.scan``) reaches no Pallas
kernel.

Tolerance in f32: |port - ref| <= 1e-5 |ref| + 1e-5 max|ref| for every
output, cache leaf and gradient.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import Runtime as JRuntime
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.dist.sharding import Runtime as TRuntime
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv as trwkv
from repro_torch.train import optimizer as topt

JRT, TRT = JRuntime(mesh=None), TRuntime()
ARCH = "rwkv6-7b"
RTOL = 1e-5


def close(port, ref, what, rtol=RTOL):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


def as_port(arrays):
    return interop._tree(lambda a: torch.from_numpy(np.array(a)), arrays)


@functools.lru_cache(maxsize=None)
def both():
    cfg = jconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, jrwkv.rwkv_init(jax.random.PRNGKey(2),
                                                  cfg))
    return cfg, tconfigs.get_smoke(ARCH), jp


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_init_matches_reference():
    """The tree and shapes of ``rwkv_init``; ``w0`` and the zero norm
    equal; every drawn leaf within +-2 sigma of its scale."""
    cfg, tcfg, jp = both()
    tp = trwkv.rwkv_init(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert sorted(tp) == sorted(jp)
    for mix in ("tm", "cm"):
        assert sorted(tp[mix]) == sorted(jp[mix])
    np.testing.assert_array_equal(tp["tm"]["w0"].numpy(), jp["tm"]["w0"])
    assert not tp["tm"]["ln"]["scale"].any()
    scale_o = 0.02 / np.sqrt(2 * cfg.n_layers)
    sigmas = {("tm", "mu"): 0.1, ("cm", "mu"): 0.1, ("tm", "u"): 0.3,
              ("tm", "wo"): scale_o, ("cm", "wv"): scale_o}
    for mix in ("tm", "cm"):
        for k, t in tp[mix].items():
            if k in ("w0", "ln"):
                continue
            assert tuple(t.shape) == jp[mix][k].shape, (mix, k)
            sigma = sigmas.get((mix, k), 0.02)
            assert float(t.abs().max()) <= np.float32(2 * sigma), (mix, k)


def _cache(cfg, b, seed):
    """A cache as after an earlier chunk: random f32 state and tokens."""
    c = jrwkv.init_rwkv_cache(JRT, cfg, b)
    return {k: rand(v.shape, seed + i, 0.5) for i, (k, v) in
            enumerate(sorted(c.items()))}


@pytest.mark.parametrize("cached", [False, True])
def test_time_mix_matches_reference(cached):
    """The output, the new state and the boundary token, from zeros or
    from a carried state and boundary token."""
    cfg, tcfg, jp = both()
    x = rand((2, 12, cfg.d_model), 3)
    c = _cache(cfg, 2, 4) if cached else {}
    exp = jax.jit(lambda p, xx, st, last: jrwkv.time_mix(
        p, cfg, JRT, xx, st, last))(
        jp["tm"], jnp.asarray(x), c.get("state"), c.get("tm_last"))
    got = trwkv.time_mix(
        as_port(jp["tm"]), tcfg, TRT, torch.from_numpy(x),
        *(torch.from_numpy(c[k]) if cached else None
          for k in ("state", "tm_last")))
    for what, g, e in zip(("out", "state", "last"), got, exp):
        close(g, e, what)


@pytest.mark.parametrize("cached", [False, True])
def test_channel_mix_matches_reference(cached):
    cfg, tcfg, jp = both()
    x = rand((2, 12, cfg.d_model), 5)
    last = rand((2, cfg.d_model), 6) if cached else None
    exp = jax.jit(lambda p, xx, ll: jrwkv.channel_mix(p, cfg, xx, ll))(
        jp["cm"], jnp.asarray(x), last)
    got = trwkv.channel_mix(as_port(jp["cm"]), tcfg, torch.from_numpy(x),
                            None if last is None else torch.from_numpy(last))
    for what, g, e in zip(("out", "last"), got, exp):
        close(g, e, what)


@pytest.mark.parametrize("cached", [False, True])
def test_rwkv_apply_matches_reference(cached):
    """Without a cache a 14-token pass; with one a 12-token prefill that
    fills it, then two decode steps, the output and every cache leaf held
    after each."""
    cfg, tcfg, jp = both()
    tp = as_port(jp)
    x = rand((2, 14, cfg.d_model), 7)
    japply = jax.jit(lambda p, xx, c: jrwkv.rwkv_apply(p, cfg, JRT, xx,
                                                       cache=c))
    if not cached:
        exp, _ = japply(jp, jnp.asarray(x), None)
        got, c = trwkv.rwkv_apply(tp, tcfg, TRT, torch.from_numpy(x))
        assert c is None
        close(got, exp, "no cache")
        return
    jc = jrwkv.init_rwkv_cache(JRT, cfg, 2)
    tc = trwkv.init_rwkv_cache(TRT, tcfg, 2, device="cpu")
    assert all(t.dtype == torch.float32 for t in tc.values())
    for step, sl in (("prefill", slice(0, 12)), ("decode", slice(12, 13)),
                     ("decode 2", slice(13, 14))):
        exp, jc = japply(jp, jnp.asarray(x[:, sl]), jc)
        got, tc2 = trwkv.rwkv_apply(tp, tcfg, TRT,
                                    torch.from_numpy(x[:, sl]), cache=tc)
        assert tc2 is tc
        close(got, exp, step)
        for k in sorted(jc):
            close(tc[k], jc[k], f"{step} {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r_block_cache_keeps_f32_and_casts_on_use(dtype):
    """The model's ``r`` block in bf16 compute reads its f32 boundary
    tokens cast to bf16 and writes them back in f32, as the JAX package's
    (the state, f32 either way): a prefill then a decode step, the logits
    within bf16's rounding of the JAX package's and the caches within
    the f32 bound where the compute is f32 (2e-2 of the largest in
    bf16)."""
    cfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=dtype)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, JRT, key))(
        jax.random.PRNGKey(0))
    tp = interop.model_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                          "cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    jc = jmodel.init_cache(cfg, JRT, 2, 16)
    tc = tmodel.init_cache(tcfg, TRT, 2, 16, device="cpu")
    fwd = jax.jit(lambda p, bt, c: jmodel.forward(p, cfg, JRT, bt, cache=c))
    rtol = RTOL if dtype == "float32" else 2e-2
    for sl in (slice(0, 8), slice(8, 9)):
        exp, jc, _ = fwd(jp, {"tokens": jnp.asarray(toks[:, sl])}, jc)
        got, tc, _ = tmodel.forward(
            tp, tcfg, TRT, {"tokens": torch.from_numpy(toks[:, sl].astype(
                np.int64))}, cache=tc)
        assert got.dtype == tmodel.common.dtype_of(dtype)
        close(got, exp, f"logits {sl}", rtol=rtol)
        for k in ("state", "tm_last", "cm_last"):
            assert tc["0"][k].dtype == torch.float32
            close(tc["0"][k], jc["0"][k], f"cache {k}", rtol=rtol)


@pytest.mark.parametrize("s", [1, 16])
def test_r_block_gradients_match_reference(s):
    """The model's ``r`` block (its two norms, the time and channel mixes
    and their residuals) at S 1 and 16: the gradients of ``sum(y w)``
    with respect to every parameter and the input, against
    ``jax.vjp``."""
    cfg, tcfg, jp = both()
    bp = {"ln1": {"scale": rand((cfg.d_model,), 10, 0.1)},
          "ln2": {"scale": rand((cfg.d_model,), 11, 0.1)}, "rwkv": jp}
    x = rand((2, s, cfg.d_model), 12)
    w = rand((2, s, cfg.d_model), 13)

    def jf(p, xx):
        return jmodel._apply_block(p, cfg, JRT, "r", xx, None, None, None,
                                   block_skip=False)[0]
    y, vjp = jax.vjp(jax.jit(jf), bp, jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(w))
    tp = topt.tree_map(lambda t: t.requires_grad_(), as_port(bp))
    xt = torch.from_numpy(x).requires_grad_()
    out, _, _ = tmodel._apply_block(tp, tcfg, TRT, "r", xt, None, None)
    close(out, y, "r block")
    # At S 1 the decay (w0, wa, wb) reaches only the final state: no
    # gradient flows to it (zeros on the JAX side).
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                topt.tree_leaves(tp) + [xt],
                                allow_unused=True, materialize_grads=True)
    exp = jax.tree.leaves(jg_p) + [jg_x]
    assert len(grads) == len(exp)
    for i, (g, e) in enumerate(zip(grads, exp)):
        close(g, e, f"gradient leaf {i}")
