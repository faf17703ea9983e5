"""The port's Mamba2 (SSD) block (``repro_torch.models.ssm``) and
zamba2's ``m`` and shared ``a`` blocks against the JAX package's, on the
CPU.

zamba2-1.2b's smoke config (d_model 64, 8 SSM heads of 16, d_state 16,
chunk 16) in f32, on the JAX package's own ``ssm_init`` parameters
carried across as numpy arrays, and numpy inputs from a seed.  The JAX
side runs jitted on the CPU; its SSM code reaches no Pallas kernel.
Both ``ssd_scan`` (up to 2 chunks) and ``ssd_chunked`` (beyond, with a
padded last chunk: L 40 at chunk 16) are held.

Tolerance in f32: |port - ref| <= 1e-5 |ref| + 1e-5 max|ref| for every
output, cache leaf and gradient (the two sum in other orders and use
other libm routines).
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
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.dist.sharding import Runtime as TRuntime
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.train import optimizer as topt

JRT, TRT = JRuntime(mesh=None), TRuntime()
ARCH = "zamba2-1.2b"
RTOL = 1e-5


def close(port, ref, what, rtol=RTOL):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


def as_port(arrays):
    return interop._tree(lambda a: torch.from_numpy(np.array(a)), arrays)


@functools.lru_cache(maxsize=None)
def both():
    """The smoke config, the JAX package's ``ssm_init`` parameters and
    the port's copy of them."""
    cfg = jconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.PRNGKey(1), cfg))
    return cfg, tconfigs.get_smoke(ARCH), jp


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def ssd_inputs(cfg, l, seed, b=2):
    """x (B, L, H, P), dt after softplus (B, L, H), B and C (B, L, N)."""
    s, nh = cfg.ssm, cfg.n_ssm_heads
    x = rand((b, l, nh, s.head_dim), seed)
    dt = np.asarray(jax.nn.softplus(rand((b, l, nh), seed + 1) - 2.0))
    bb = rand((b, l, s.d_state), seed + 2)
    cc = rand((b, l, s.d_state), seed + 3)
    return x, dt, bb, cc


# ---- components ----------------------------------------------------------
def test_init_matches_reference():
    """The tree, shapes and dtypes of ``ssm_init``; the deterministic
    leaves (``dt_bias``, ``A_log``, ``D``, the zero ``conv_b`` and norm)
    equal; the drawn ones within +-2 sigma of their scale."""
    cfg, tcfg, jp = both()
    tp = tssm.ssm_init(tcfg, torch.Generator().manual_seed(0),
                       device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in ("dt_bias", "A_log", "D", "conv_b"):
        np.testing.assert_array_equal(tp[k].numpy(), jp[k], err_msg=k)
    assert not tp["norm"]["scale"].any()
    for k, sigma in (("in_proj", 0.02), ("conv_w", 0.2),
                     ("out_proj", 0.02 / np.sqrt(2 * cfg.n_layers))):
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert float(tp[k].abs().max()) <= np.float32(2 * sigma), k


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_matches_reference(cached):
    cfg, _, jp = both()
    width, cdim = jp["conv_w"].shape
    u = rand((2, 7, cdim), 3)
    bias = rand((cdim,), 4, 0.1)
    cache = rand((2, width - 1, cdim), 5) if cached else None
    exp, exp_c = jssm._causal_conv(jnp.asarray(u), jnp.asarray(jp["conv_w"]),
                                   jnp.asarray(bias),
                                   None if cache is None
                                   else jnp.asarray(cache))
    got, got_c = tssm._causal_conv(
        torch.from_numpy(u), torch.from_numpy(np.array(jp["conv_w"])),
        torch.from_numpy(bias), None if cache is None
        else torch.from_numpy(cache))
    close(got, exp, "conv")
    close(got_c, exp_c, "conv cache")


@pytest.mark.parametrize("l", [24, 40])
def test_ssd_paths_match_reference(l):
    """``ssd_scan`` (its y and final state) and ``ssd_chunked`` at L <= 2
    chunks and above, L not a multiple of the chunk (16); the port's two
    paths agree with each other as the JAX package's do."""
    cfg, _, jp = both()
    x, dt, b, c = ssd_inputs(cfg, l, 10 + l)
    args = (x, dt, jp["A_log"], b, c, jp["D"])
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.array(a)) for a in args]
    ey, es = jax.jit(jssm.ssd_scan)(*jargs)
    gy, gs = tssm.ssd_scan(*targs)
    close(gy, ey, "ssd_scan y")
    close(gs, es, "ssd_scan state")
    ec = jax.jit(functools.partial(jssm.ssd_chunked,
                                   chunk=cfg.ssm.chunk))(*jargs)
    gc = tssm.ssd_chunked(*targs, cfg.ssm.chunk)
    close(gc, ec, "ssd_chunked")
    close(gc, gy, "port chunked vs scan")
    # a state carried in: the decode step's form
    s0 = rand(tuple(es.shape), 7)

    def first(xs):
        return [a if i in (2, 5) else a[:, :1] for i, a in enumerate(xs)]
    ey, es = jax.jit(jssm.ssd_scan)(*first(jargs), state=jnp.asarray(s0))
    gy, gs = tssm.ssd_scan(*first(targs), state=torch.from_numpy(s0))
    close(gy, ey, "decode step y")
    close(gs, es, "decode step state")


# ---- ssm_apply's three branches -------------------------------------------
def _japply(cfg):
    return jax.jit(lambda p, x, c: jssm.ssm_apply(p, cfg, JRT, x, cache=c))


@pytest.mark.parametrize("l", [20, 40])
@pytest.mark.parametrize("cached", [False, True])
def test_ssm_apply_matches_reference(l, cached):
    """Without a cache: ``ssd_scan`` at L 20, ``ssd_chunked`` at L 40.
    With one: the prefill primes it (at L 40 ``ssd_chunked`` and an
    ``ssd_scan`` for the state), then two decode steps from it; the
    outputs, the state and the conv window held after each."""
    cfg, tcfg, jp = both()
    tp = as_port(jp)
    x = rand((2, l + 2, cfg.d_model), 20 + l)
    japply = _japply(cfg)
    if not cached:
        exp, _ = japply(jp, jnp.asarray(x[:, :l]), None)
        got, c = tssm.ssm_apply(tp, tcfg, TRT, torch.from_numpy(x[:, :l]))
        assert c is None
        close(got, exp, "no cache")
        return
    jc = jssm.init_ssm_cache(JRT, cfg, 2)
    tc = tssm.init_ssm_cache(TRT, tcfg, 2, device="cpu")
    assert tc["conv"].dtype == tc["state"].dtype == torch.float32
    for step, sl in (("prefill", slice(0, l)), ("decode", slice(l, l + 1)),
                     ("decode 2", slice(l + 1, l + 2))):
        exp, jc = japply(jp, jnp.asarray(x[:, sl]), jc)
        got, tc2 = tssm.ssm_apply(tp, tcfg, TRT, torch.from_numpy(x[:, sl]),
                                  cache=tc)
        assert tc2 is tc
        close(got, exp, step)
        close(tc["state"], jc["state"], f"{step} state")
        close(tc["conv"], jc["conv"], f"{step} conv")


# ---- the blocks' gradients --------------------------------------------------
@pytest.mark.parametrize("l", [20, 40])
def test_m_block_gradients_match_reference(l):
    """zamba2's ``m`` block (norm, then ``ssm_apply``, residual) at L 20
    (``ssd_scan``) and L 40 (``ssd_chunked``): the gradients of ``sum(y
    w)`` with respect to every parameter and the input, against
    ``jax.vjp``."""
    cfg, tcfg, jp = both()
    bp = {"ln1": {"scale": rand((cfg.d_model,), 30, 0.1)}, "ssm": jp}
    x = rand((2, l, cfg.d_model), 31)
    w = rand((2, l, cfg.d_model), 32)

    def jf(p, xx):
        return jmodel._apply_block(p, cfg, JRT, "m", xx, None, None, None,
                                   block_skip=False)[0]
    y, vjp = jax.vjp(jax.jit(jf), bp, jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(w))
    tp = topt.tree_map(lambda t: t.requires_grad_(), as_port(bp))
    xt = torch.from_numpy(x).requires_grad_()
    out, _, _ = tmodel._apply_block(tp, tcfg, TRT, "m", xt, None, None)
    close(out, y, "m block")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                topt.tree_leaves(tp) + [xt])
    exp = jax.tree.leaves(jg_p) + [jg_x]
    assert len(grads) == len(exp)
    for i, (g, e) in enumerate(zip(grads, exp)):
        close(g, e, f"gradient leaf {i}")


def test_shared_a_block_gradients_match_reference():
    """The shared ``a`` block applied twice (two repeats' positions,
    windowed attention at the smoke window 16 over 24 tokens, then the
    MLP): its one weight set's gradient sums over both applications, held
    against ``jax.vjp``."""
    cfg = jconfigs.get_smoke(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, JRT, key))(
        jax.random.PRNGKey(4))
    shared = jax.tree.map(np.asarray, jp["shared_attn"])
    s = 24
    x = rand((2, s, cfg.d_model), 40)
    w = rand((2, s, cfg.d_model), 41)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (2, s))

    def jf(p, xx):
        for _ in range(2):
            xx = jmodel._apply_block({}, cfg, JRT, "a", xx, pos, None, p,
                                     block_skip=False)[0]
        return xx
    y, vjp = jax.vjp(jax.jit(jf), shared, jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(w))
    tp = topt.tree_map(lambda t: t.requires_grad_(), as_port(shared))
    xt = torch.from_numpy(x).requires_grad_()
    rope = tcommon.rope_tables(torch.from_numpy(np.array(pos)),
                               cfg.d_head, cfg.rope_theta)
    out = xt
    for _ in range(2):
        out = tmodel._apply_block({}, tcfg, TRT, "a", out, rope, None,
                                  tp)[0]
    close(out, y, "a block twice")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                topt.tree_leaves(tp) + [xt])
    for i, (g, e) in enumerate(zip(grads, jax.tree.leaves(jg_p) + [jg_x])):
        close(g, e, f"gradient leaf {i}")


# ---- the model -------------------------------------------------------------
def test_remat_full_is_bitwise_none_with_inner_checkpoints():
    """zamba2's smoke pattern ``mmma`` is longer than 2 blocks: under
    ``remat="full"`` each block is checkpointed inside its unit's
    checkpoint.  Loss and every gradient equal ``remat="none"``'s
    bitwise; the shared block's attention runs twice a repeat (its
    forward, then its own block's recompute: the unit's recompute stops
    at the last block's input)."""
    from repro_torch.models import attention as tattn
    from repro_torch.train import train_step as tts

    cfg = tconfigs.get_smoke(ARCH)
    params = tmodel.init_params(cfg, TRT, torch.Generator().manual_seed(3),
                                "cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 40)))
    calls = []
    orig = tattn.flash_attention

    def counted(*a, **kw):
        calls.append(kw["causal"])
        return orig(*a, **kw)
    runs, counts = {}, {}
    try:
        tattn.flash_attention = counted
        for remat in ("none", "full"):
            calls.clear()
            runs[remat] = tts.loss_and_grads(
                params, dataclasses.replace(cfg, remat=remat), TRT,
                {"tokens": tok, "labels": tok})
            counts[remat] = len(calls)
    finally:
        tattn.flash_attention = orig
    assert counts == {"none": cfg.pattern_repeats,
                      "full": 2 * cfg.pattern_repeats}
    assert torch.equal(runs["none"][0], runs["full"][0])
    for a, b in zip(topt.tree_leaves(runs["none"][2]),
                    topt.tree_leaves(runs["full"][2])):
        assert torch.equal(a, b)
