"""The port's LM substrate (``repro_torch.configs``, ``dist.sharding``,
``models``) against the JAX package's, on the CPU.

The smoke configs of the dense attention family (yi-9b, glm4-9b,
qwen2.5-32b, gemma2-27b), of the mixture-of-experts family
(olmoe-1b-7b, deepseek-v2-236b with its latent attention), of the
recurrent families (zamba2-1.2b: Mamba2 blocks and the shared attention
block; rwkv6-7b) and of the frontend models (qwen2-vl-7b, hubert-xlarge:
embeddings in place of tokens; f32 compute) run on the JAX package's own
parameters, carried across by ``repro_torch.interop``; inputs come from a
numpy seed.  The JAX side runs jitted on the CPU, as its own tests run
it; its model code reaches no Pallas kernel.

Tolerance in f32: |port - ref| <= 1e-5 |ref| + 1e-5 max|ref| (the two
sum in other orders and use other libm routines; the observed gap is
below 1e-6 max|ref|).  The port's own initialisation is checked apart:
it draws with ``torch.nn.init.trunc_normal_``, not JAX's bits.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import Runtime as JRuntime
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.dist.sharding import Runtime as TRuntime
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel

JRT, TRT = JRuntime(mesh=None), TRuntime()
DENSE = ["yi-9b", "glm4-9b", "qwen2.5-32b", "gemma2-27b"]
MOE = ["olmoe-1b-7b", "deepseek-v2-236b"]
RECURRENT = ["zamba2-1.2b", "rwkv6-7b"]
FRONTEND = ["qwen2-vl-7b", "hubert-xlarge"]
RTOL = 1e-5
# Truncated at +-2 sigma with no variance correction: the sample std is
# sqrt(1 - 4 phi(2) / (Phi(2) - Phi(-2))) sigma.
TRUNC_STD = 0.8796


def close(port, ref, what, rtol=RTOL):
    """|port - ref| <= rtol |ref| + rtol max|ref|."""
    port = port.float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, what
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def both_params(arch, seed=0):
    """The JAX package's smoke config, its parameters from ``seed`` and
    the port's copy of them (shared by the tests; none writes to them)."""
    cfg = jconfigs.get_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, JRT, key))(
        jax.random.PRNGKey(seed))
    tp = interop.model_params_from_arrays(tconfigs.get_smoke(arch),
                                          jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def as_t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def model_inputs(cfg, b, s, seed=0):
    """The same input for both packages: tokens, or for a frontend model
    (B, S, frontend_dim) f32 embeddings, as (key, numpy array)."""
    if cfg.frontend is None:
        return "tokens", tokens(cfg, b, s, seed)
    return "embeds", np.random.default_rng(seed).standard_normal(
        (b, s, cfg.frontend_dim)).astype(np.float32)


def as_port(key, a):
    return {key: as_t(a) if key == "tokens" else torch.from_numpy(a)}


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---- configs and the runtime ------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke"):
        jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.pattern_repeats == jc.pattern_repeats


def test_registry_and_shapes_equal_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.cell_matrix(tconfigs.ARCHS) == \
        jconfigs.cell_matrix(jconfigs.ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


def test_runtime_is_one_device():
    """``Runtime()`` is the one-device contract; a mesh is a ``Mesh`` of
    ranks (``tests/test_torch_sharding.py``), anything else raises."""
    assert TRT == TRuntime() and TRT.mesh is None
    assert TRT.fsdp_size == 1 and TRT.tp_size == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        TRT.mesh = object()
    with pytest.raises(TypeError, match="make_mesh"):
        TRuntime(mesh=object())


def test_init_takes_an_explicit_device():
    """No init function defaults to a device: one left out is an error,
    and ``cuda`` without a card raises rather than falling back."""
    cfg = tconfigs.get_smoke("yi-9b")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(TypeError):
        tmodel.init_params(cfg, TRT, gen)
    with pytest.raises(TypeError):
        tmodel.init_cache(cfg, TRT, 1, 8)
    with pytest.raises(TypeError):
        tattn.init_kv_cache(TRT, cfg, 1, 8)
    with pytest.raises(TypeError):
        tcommon.mlp_init(8, 16, gen)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodel.init_params(cfg, TRT, gen, "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodel.init_cache(cfg, TRT, 1, 8, device="cuda")


# ---- components -------------------------------------------------------------
def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3.0
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    exp = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                          1e-6)
    got = tcommon.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-6)
    close(got, exp, "rmsnorm")
    # bf16 activations: normalised in f32, one rounding back.
    xb = jnp.asarray(x, jnp.bfloat16)
    got_b = tcommon.rmsnorm({"scale": torch.from_numpy(scale)},
                            torch.from_numpy(np.asarray(xb, np.float32))
                            .bfloat16(), 1e-6)
    exp_b = np.asarray(jcommon.rmsnorm({"scale": jnp.asarray(scale)}, xb,
                                       1e-6), np.float32)
    assert got_b.dtype == torch.bfloat16
    # one bf16 ulp at most where the f32 values straddle a rounding edge
    np.testing.assert_allclose(got_b.float().numpy(), exp_b, rtol=2 ** -8)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    pos[1] += 7
    exp = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    rope = tcommon.rope_tables(torch.from_numpy(pos), 16, theta)
    close(tcommon.apply_rope(torch.from_numpy(x), rope), exp, "apply_rope")
    # M-RoPE: three position rows, one a section of the half dimension.
    pos3 = np.stack([pos, pos + 3, pos[:, ::-1]])
    exp = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos3), theta,
                             (2, 3, 3))
    rope = tcommon.rope_tables(torch.from_numpy(pos3.copy()), 16, theta,
                               sections=(2, 3, 3))
    close(tcommon.apply_rope(torch.from_numpy(x), rope), exp, "M-RoPE")


def test_mlp_apply_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    p = jcommon.mlp_init(jax.random.PRNGKey(3), 64, 160)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    exp = jcommon.mlp_apply(p, jnp.asarray(x))
    close(tcommon.mlp_apply(tp, torch.from_numpy(x)), exp, "mlp")


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    lg = rng.standard_normal((2, 5, 512)).astype(np.float32) * 20
    lab = rng.integers(0, 512, (2, 5)).astype(np.int32)
    for cap in (0.0, 30.0):
        exp = jcommon.cross_entropy(jnp.asarray(lg), jnp.asarray(lab), cap)
        got = tcommon.cross_entropy(torch.from_numpy(lg),
                                    torch.from_numpy(lab), cap)
        close(got, exp, f"cross_entropy cap {cap}")


# ---- attention ----------------------------------------------------------------
@pytest.mark.parametrize("mode", ["prefill", "cache"])
@pytest.mark.parametrize("arch", DENSE)
def test_attn_apply_matches_reference(arch, mode):
    """Unit position 0's attention (gemma2's is a sliding-window ``l``
    block): prefill without a cache; or prefill filling a cache (20
    tokens, so gemma2's 16-slot window cache takes the last 16), then one
    decode step, the output and the cache held after each."""
    cfg, jp, tp = both_params(arch)
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["0"]["attn"])
    ta = {k: v[0] for k, v in tp["blocks"]["0"]["attn"].items()}
    window = cfg.window if cfg.layer_pattern[0] == "l" else 0
    b, s = 2, 20
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s + 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 1, dtype=np.int32), (b, s + 1))
    japply = jax.jit(lambda p, xs, ps, c: jattn.attn_apply(
        p, cfg, JRT, xs, ps, window=window, cache=c))

    def tapply(xs, ps, c):
        rope = tcommon.rope_tables(torch.from_numpy(ps.copy()), cfg.d_head,
                                   cfg.rope_theta)
        return tattn.attn_apply(ta, cfg, TRT, torch.from_numpy(xs), rope,
                                window=window, cache=c)
    if mode == "prefill":
        exp, _ = japply(ja, x[:, :s], pos[:, :s], None)
        got, c = tapply(x[:, :s], pos[:, :s], None)
        assert c is None
        close(got, exp, "prefill")
        return
    jc = jattn.init_kv_cache(JRT, cfg, b, 32, window, jnp.float32)
    tc = tattn.init_kv_cache(TRT, cfg, b, 32, window, torch.float32,
                             device="cpu")
    for step, sl in (("fill", slice(0, s)), ("decode", slice(s, s + 1))):
        exp, jc = japply(ja, x[:, sl], pos[:, sl], jc)
        got, tc = tapply(x[:, sl], pos[:, sl], tc)
        close(got, exp, step)
        for name in ("k", "v"):
            close(tc[name], jc[name], f"{step} cache {name}")
        assert int(tc["pos"]) == int(jc["pos"])


# ---- the model ------------------------------------------------------------------
def _jforward(cfg):
    return jax.jit(lambda p, bt, c: jmodel.forward(p, cfg, JRT, bt, cache=c))


@pytest.mark.parametrize("mode", ["nocache", "cache"])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_forward_matches_reference(arch, mode):
    """The logits (and the experts' aux loss, 0 without experts) of a
    20-token forward without a cache; or of a 19-token prefill into an
    f32 cache of 32, then of one decode step (none for an encoder), the
    cache (k and v, the latent, or the recurrent state, conv window and
    boundary tokens, which have no pos) held after each.  A frontend
    model takes 20 rows of embeddings in place of the tokens."""
    cfg, jp, tp = both_params(arch)
    b, s = 2, 20
    key, inp = model_inputs(cfg, b, s)
    tcfg = tconfigs.get_smoke(arch)
    if mode == "nocache":
        exp, jaux = jax.jit(lambda p, bt: jmodel.forward(p, cfg, JRT, bt))(
            jp, {key: jnp.asarray(inp)})
        got, aux = tmodel.forward(tp, tcfg, TRT, as_port(key, inp))
        if cfg.moe is None:
            assert float(aux) == 0.0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
        close(got, exp, "logits")
        return
    jc = jmodel.init_cache(cfg, JRT, b, 32, jnp.float32)
    tc = tmodel.init_cache(tcfg, TRT, b, 32, torch.float32, device="cpu")
    fwd = _jforward(cfg)
    steps = (("prefill", slice(0, s - 1)), ("decode", slice(s - 1, s)))
    for step, sl in steps[:2 if cfg.decoder else 1]:
        exp, jc, _ = fwd(jp, {key: jnp.asarray(inp[:, sl])}, jc)
        got, tc, _ = tmodel.forward(tp, tcfg, TRT, as_port(key, inp[:, sl]),
                                    cache=tc)
        close(got, exp, f"{step} logits")
        assert sorted(tc) == sorted(jc)
        for i in jc:
            assert sorted(tc[i]) == sorted(jc[i])
            for name in sorted(set(jc[i]) - {"pos"}):
                close(tc[i][name], jc[i][name], f"{step} cache {i} {name}")
            if "pos" in jc[i]:
                assert tc[i]["pos"].tolist() == \
                    np.asarray(jc[i]["pos"]).tolist()


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_above_two_chunks_matches_reference(arch):
    """A 40-token forward, above 2 chunks of the smoke configs' 16: the
    SSD runs ``ssd_chunked`` with a padded last chunk (rwkv6's recurrence
    is one path at every length)."""
    cfg, jp, tp = both_params(arch)
    toks = tokens(cfg, 2, 40, seed=11)
    exp, _ = jax.jit(lambda p, bt: jmodel.forward(p, cfg, JRT, bt))(
        jp, {"tokens": jnp.asarray(toks)})
    got, _ = tmodel.forward(tp, tconfigs.get_smoke(arch), TRT,
                            {"tokens": as_t(toks)})
    close(got, exp, "logits")


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + ["qwen2-vl-7b"])
def test_decode_matches_prefill(arch):
    """The port's own check, as the JAX package's
    ``test_decode_matches_prefill``: an 11-token prefill and one decode
    step give the 12-token forward's last logits (rtol = atol = 2e-2);
    qwen2-vl on 12 rows of embeddings."""
    cfg = tconfigs.get_smoke(arch)
    params = tmodel.init_params(cfg, TRT, torch.Generator().manual_seed(0),
                                "cpu")
    b, s = 2, 12
    key, inp = model_inputs(cfg, b, s, seed=6)
    full, _ = tmodel.forward(params, cfg, TRT, as_port(key, inp))
    cache = tmodel.init_cache(cfg, TRT, b, 32, torch.float32,
                              device="cpu")
    _, cache, _ = tmodel.forward(params, cfg, TRT, as_port(key, inp[:, :-1]),
                                 cache=cache)
    step, _, _ = tmodel.forward(params, cfg, TRT, as_port(key, inp[:, -1:]),
                                cache=cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_after_a_long_prefill_matches_the_forward(arch):
    """A 48-token prefill, above 2 chunks (zamba2 primes its SSM state
    through ``ssd_chunked`` and an ``ssd_scan`` for the state; 48 is a
    multiple of the shared block's 16-token window, so its ring holds
    exactly the window, see the gemma2 test below), then two decode
    steps: each within rtol = atol = 2e-2 of the 50-token forward's
    logits at its position, and the decode position read from the first
    cache that has one (zamba2's ``a`` block at unit position 3; rwkv6's
    caches have none)."""
    cfg = tconfigs.get_smoke(arch)
    params = tmodel.init_params(cfg, TRT, torch.Generator().manual_seed(1),
                                "cpu")
    toks = as_t(tokens(cfg, 2, 50, seed=12))
    full, _ = tmodel.forward(params, cfg, TRT, {"tokens": toks})
    cache = tmodel.init_cache(cfg, TRT, 2, 64, torch.float32, device="cpu")
    _, cache, _ = tmodel.forward(params, cfg, TRT, {"tokens": toks[:, :48]},
                                 cache=cache)
    has_pos = [i for i in sorted(cache, key=int) if "pos" in cache[i]]
    assert has_pos == (["3"] if arch == "zamba2-1.2b" else [])
    for t in (48, 49):
        step, _, _ = tmodel.forward(params, cfg, TRT,
                                    {"tokens": toks[:, t:t + 1]}, cache=cache)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s", [16, 20])
def test_gemma2_window_ring_after_a_long_prefill(s):
    """gemma2's ``l`` layers keep a 16-slot ring (window 16).  A prefill
    of ``s`` >= 16 tokens puts token ``s - 16 + j`` in slot ``j``; the
    next decode writes slot ``s % 16``.  Unless ``s % 16 == 0`` that
    evicts token ``s - 16 + s % 16``, inside the window, and keeps token
    ``s - 16``, outside it.  The port copies the JAX package (its decode
    logits within the f32 tolerance), and the JAX package's decode then
    departs from its own teacher-forced forward at s = 20 (by 0.109 on
    logits up to 0.445 on this seed), while at s = 16 it agrees within
    1e-5."""
    cfg, jp, tp = both_params("gemma2-27b")
    tcfg = tconfigs.get_smoke("gemma2-27b")
    b = 2
    toks = tokens(cfg, b, s + 1, seed=7)
    full, _ = jax.jit(lambda p, bt: jmodel.forward(p, cfg, JRT, bt))(
        jp, {"tokens": jnp.asarray(toks)})
    full = np.asarray(full[:, -1])
    jc = jmodel.init_cache(cfg, JRT, b, 48, jnp.float32)
    tc = tmodel.init_cache(tcfg, TRT, b, 48, torch.float32, device="cpu")
    assert tc["0"]["k"].shape[2] == cfg.window == 16
    fwd = _jforward(cfg)
    _, jc, _ = fwd(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc)
    exp, jc, _ = fwd(jp, {"tokens": jnp.asarray(toks[:, s:])}, jc)
    _, tc, _ = tmodel.forward(tp, tcfg, TRT, {"tokens": as_t(toks[:, :s])},
                              cache=tc)
    got, tc, _ = tmodel.forward(tp, tcfg, TRT, {"tokens": as_t(toks[:, s:])},
                                cache=tc)
    close(got, exp, f"decode after a {s}-token prefill")
    close(tc["0"]["k"], jc["0"]["k"], "window cache k")
    gap = float(np.abs(np.asarray(exp[:, 0]) - full).max())
    if s % cfg.window:
        assert gap > 0.05 * float(np.abs(full).max()), gap
    else:
        close(np.asarray(exp[:, 0]), full, "decode vs forward", rtol=1e-5)


# ---- the port's own initialisation ---------------------------------------------
def _scale(path, cfg):
    """The std each drawn leaf is initialised with; None for zeros."""
    if path.endswith("/scale") or path.split("/")[-1] in ("bq", "bk", "bv"):
        return None
    if path.endswith("attn/wo") or path.endswith("moe/w2"):
        return 0.02 / math.sqrt(2 * cfg.n_layers)
    if path.endswith("mlp/wo") or path.endswith("shared/wo"):
        return 0.02 / math.sqrt(2)
    return 0.02


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_init_params_tree_matches_reference(arch):
    cfg = tconfigs.get_smoke(arch)
    jp = leaves(both_params(arch)[1])
    tp = leaves(tmodel.init_params(cfg, TRT,
                                   torch.Generator().manual_seed(0), "cpu"))
    assert sorted(tp) == sorted(jp)
    for path, t in tp.items():
        assert tuple(t.shape) == jp[path].shape, path
        assert t.dtype == torch.float32 and jp[path].dtype == jnp.float32
        assert t.device.type == "cpu"


@pytest.mark.parametrize("arch", DENSE + ["deepseek-v2-236b"])
def test_init_draws_are_truncated_normals(arch):
    """Every drawn value within +-2 sigma; per scale (0.02, 0.02/sqrt(2)
    for the MLP's and the shared experts' ``wo``, 0.02/sqrt(2 n_layers)
    for attention's ``wo`` and the experts' ``w2``)
    the pooled sample std within 4 standard errors (1/sqrt(2n) relative)
    of 0.8796 sigma; norm scales and biases zero."""
    cfg = tconfigs.get_smoke(arch)
    tp = leaves(tmodel.init_params(cfg, TRT,
                                   torch.Generator().manual_seed(1), "cpu"))
    pooled = {}
    for path, t in tp.items():
        sigma = _scale(path, cfg)
        if sigma is None:
            assert not t.any(), path
            continue
        assert float(t.abs().max()) <= np.float32(2 * sigma), path
        pooled.setdefault(sigma, []).append(t.flatten().double())
    assert len(pooled) == 3
    for sigma, parts in pooled.items():
        x = torch.cat(parts)
        n = x.numel()
        std = float(x.std())
        assert abs(std / (TRUNC_STD * sigma) - 1) < 4 / math.sqrt(2 * n), \
            (sigma, n, std / sigma)
        assert abs(float(x.mean())) < 4 * sigma / math.sqrt(n)


def test_init_is_a_function_of_the_generator_seed():
    cfg = tconfigs.get_smoke("gemma2-27b")

    def draw(seed):
        return leaves(tmodel.init_params(
            cfg, TRT, torch.Generator().manual_seed(seed), "cpu"))
    a, b, c = draw(5), draw(5), draw(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["/embed/tok"], c["/embed/tok"])
    # the repeats of a stacked leaf are different draws
    wq = a["/blocks/0/attn/wq"]
    assert not torch.equal(wq[0], wq[1])


def test_interop_checks_the_stacking():
    cfg, jp, _ = both_params("yi-9b")
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"]["0"]["attn"]["wq"] = tree["blocks"]["0"]["attn"]["wq"][0]
    with pytest.raises(ValueError, match="pattern repeats"):
        interop.model_params_from_arrays(tconfigs.get_smoke("yi-9b"), tree,
                                         "cpu")
    bf = {"0": {"k": np.asarray(jnp.full((1, 2, 1, 1), 1.5, jnp.bfloat16)),
                "v": np.zeros((1, 2, 1, 1), np.float32),
                "pos": np.array([3], np.int32)}}
    c = interop.kv_cache_from_arrays(bf, "cpu")
    assert c["0"]["k"].dtype == torch.bfloat16
    assert float(c["0"]["k"].float().sum()) == 3.0
    assert c["0"]["pos"].tolist() == [3]
