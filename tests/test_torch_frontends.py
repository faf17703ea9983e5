"""The frontend models (qwen2-vl-7b: vision, M-RoPE, qkv biases;
hubert-xlarge: audio, an encoder without a causal mask) and
``remat="dots"`` against the JAX package, on the CPU.

Both sides run the smoke configs on the JAX package's parameters
(carried across by ``repro_torch.interop``) and the same numpy
embeddings (the stubbed towers' patch and frame embeddings); the JAX side
runs its live functions, jitted on the CPU, and reaches no Pallas kernel.

Tolerances: M-RoPE's tables 1e-6 absolute; in f32, |port - ref| <= 1e-5
|ref| + 1e-5 max|ref| for logits, loss rtol 1e-5 and every gradient leaf
within 1e-5 of its largest (``tests/test_torch_models.py``,
``tests/test_torch_train.py``); a train step's loss rtol 1e-5, grad norm
2e-5 and parameters as ``tests/test_torch_train_steps.py`` holds them;
the loop's logged loss 2e-5 and grad norm 1e-4
(``tests/test_torch_train_loop.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.dist.sharding import Runtime as JRuntime
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.sharding import Runtime as TRuntime
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as tengine
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

JRT, TRT = JRuntime(mesh=None), TRuntime()
FRONTENDS = ["qwen2-vl-7b", "hubert-xlarge"]
RTOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)


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
    """The JAX package's smoke config and parameters from ``seed``, and
    the port's copy of them (shared by the tests; none writes to them)."""
    cfg = jconfigs.get_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, JRT, key))(
        jax.random.PRNGKey(seed))
    tp = interop.model_params_from_arrays(tconfigs.get_smoke(arch),
                                          jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def embeds(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.frontend_dim)).astype(np.float32)


def mrope_positions(b, s, seed=0):
    """(3, B, S) int32 positions whose three rows differ: a temporal row
    that advances every 4 patches, and height and width rows drawn at
    random."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(s) // 4, (b, s))
    return np.stack([t, rng.integers(0, 9, (b, s)),
                     rng.integers(0, 13, (b, s))]).astype(np.int32)


def batches(cfg, b, s, seed, positions=None):
    """The same ``{"embeds", "labels"}`` batch for the JAX package and the
    port (labels drawn from the vocabulary), with ``positions`` when
    given."""
    e = embeds(cfg, b, s, seed)
    lab = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    jb = {"embeds": jnp.asarray(e), "labels": jnp.asarray(lab)}
    tb = {"embeds": torch.from_numpy(e),
          "labels": torch.from_numpy(lab.astype(np.int64))}
    if positions is not None:
        jb["positions"] = jnp.asarray(positions)
        tb["positions"] = torch.from_numpy(positions)
    return jb, tb


# ---- M-RoPE -------------------------------------------------------------------
@pytest.mark.parametrize("d,sections", [(32, (4, 6, 6)), (128, (16, 24, 24))])
def test_mrope_tables_match_reference(d, sections):
    """q-like (B, S, H, D) inputs rotated by three different position
    rows, one a section (qwen2-vl's (16, 24, 24) at D 128), within 1e-6
    of the JAX package's ``apply_rope``; 2-D positions are refused."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 24, 3, d)).astype(np.float32)
    pos = mrope_positions(2, 24, seed=d)
    assert len({tuple(r.ravel()) for r in pos}) == 3
    exp = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    rope = tcommon.rope_tables(torch.from_numpy(pos), d, 1e6, sections)
    assert rope[0].shape == (2, 24, 1, d // 2)
    got = tcommon.apply_rope(torch.from_numpy(x), rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0,
                               atol=1e-6)
    # One position row for all three sections is plain RoPE.
    flat = tcommon.rope_tables(torch.from_numpy(pos[:1].repeat(3, 0)), d,
                               1e6, sections)
    plain = tcommon.rope_tables(torch.from_numpy(pos[0]), d, 1e6)
    assert all(torch.equal(a, b) for a, b in zip(flat, plain))
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        tcommon.rope_tables(torch.from_numpy(pos[0]), d, 1e6, sections)


# ---- the forward ----------------------------------------------------------------
@pytest.mark.parametrize("arch,explicit", [("qwen2-vl-7b", False),
                                           ("qwen2-vl-7b", True),
                                           ("hubert-xlarge", False)])
def test_frontend_forward_matches_reference(arch, explicit):
    """The logits of a 20-frame forward without a cache on the embeddings;
    qwen2-vl with its (B, S) default positions and with explicit (3, B,
    S) ones whose rows differ (they move the logits by more than ten
    times the tolerance)."""
    cfg, jp, tp = both_params(arch)
    pos = mrope_positions(2, 20, seed=3) if explicit else None
    jb, tb = batches(cfg, 2, 20, seed=3, positions=pos)
    exp, jaux = jax.jit(lambda p, bt: jmodel.forward(p, cfg, JRT, bt))(jp, jb)
    got, aux = tmodel.forward(tp, tconfigs.get_smoke(arch), TRT, tb)
    assert float(aux) == 0.0 == float(jaux)
    close(got, exp, "logits")
    if explicit:
        default, _ = tmodel.forward(tp, tconfigs.get_smoke(arch), TRT,
                                    {"embeds": tb["embeds"]})
        assert float((default - got).abs().max()) > \
            10 * RTOL * float(got.abs().max())


# ---- loss, gradients, a train step, the loop --------------------------------------
@functools.lru_cache(maxsize=None)
def jgrad(arch, remat=None):
    cfg = jconfigs.get_smoke(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg, JRT, b), has_aux=True))


def _grads_close(tg, jg):
    for got, exp in zip(topt.tree_leaves(tg), jax.tree.leaves(jg)):
        exp = np.asarray(exp, np.float32)
        np.testing.assert_allclose(got.float().numpy(), exp, rtol=0,
                                   atol=1e-5 * np.abs(exp).max())


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_loss_and_gradients_match_reference(arch):
    """``jax.value_and_grad(loss_fn)``: qwen2-vl's loss over shifted
    labels (a causal decoder) with M-RoPE positions, hubert's unshifted;
    every gradient leaf, ``frontend.proj`` and qwen2-vl's qkv biases
    among them; the token table that qwen2-vl never reads gets zeros on
    both sides."""
    cfg, jp, tp = both_params(arch)
    pos = mrope_positions(2, 24, seed=4) if cfg.mrope_sections else None
    jb, tb = batches(cfg, 2, 24, seed=4, positions=pos)
    (jl, jaux), jg = jgrad(arch)(jp, jb)
    tl, taux, tg = tts.loss_and_grads(tp, tconfigs.get_smoke(arch), TRT, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5)
    _grads_close(tg, jg)
    assert float(tg["frontend"]["proj"].abs().max()) > 0
    if cfg.frontend == "vision":
        assert not tg["embed"]["tok"].any()
        assert float(tg["blocks"]["0"]["attn"]["bk"].abs().max()) > 0


def test_remat_dots_gradients_match_reference_dots():
    """``remat="dots"`` (the weight products' outputs saved, the rest
    recomputed) against the JAX package's ``"dots"``
    (``dots_with_no_batch_dims_saveable``) at the f32 tolerance, on
    hubert."""
    arch = "hubert-xlarge"
    cfg, jp, tp = both_params(arch)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), remat="dots")
    jb, tb = batches(cfg, 2, 24, seed=5)
    (jl, _), jg = jgrad(arch, "dots")(jp, jb)
    tl, _, tg = tts.loss_and_grads(tp, tcfg, TRT, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _grads_close(tg, jg)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_train_step_matches_reference(arch):
    """One AdamW step on the embeddings: loss rtol 1e-5, grad norm 2e-5,
    the learning rate bitwise, parameters within 1e-6 + 2.5 lr (all but
    1e-3 of them within 1e-6 + lr / 64)."""
    cfg, jp, tp = both_params(arch)
    tcfg = tconfigs.get_smoke(arch)
    jstep = jax.jit(jts.make_train_step(cfg, JRT, jts.TrainConfig(
        opt=jopt.AdamWConfig(**OPT))))
    tstep = tts.make_train_step(tcfg, TRT, tts.TrainConfig(
        opt=topt.AdamWConfig(**OPT)))
    jb, tb = batches(cfg, 4, 32, seed=10)
    jp2, _, jm = jstep(jp, jopt.adamw_init(jp), jb, jax.random.PRNGKey(0))
    tp2, tst, tm = tstep(topt.tree_map(torch.clone, tp),
                         topt.adamw_init(tp), tb, 0)
    assert sorted(tm) == sorted(jm) and int(tst["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-5)
    lr = float(tm["lr"])
    assert lr == float(jm["lr"])
    n_off = n_all = 0
    for got, exp in zip(topt.tree_leaves(tp2), jax.tree.leaves(jp2)):
        diff = np.abs(got.numpy() - np.asarray(exp))
        assert diff.max() <= 1e-6 + 2.5 * lr, (arch, diff.max())
        n_off += int((diff > 1e-6 + lr / 64).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_hubert_loop_history_matches_reference(monkeypatch):
    """``TrainLoop`` on hubert's ``embeds`` batches, 5 logged steps from
    the JAX package's parameters: loss within 2e-5, grad norm within
    1e-4."""
    arch = "hubert-xlarge"
    jcfg, jp, tp = both_params(arch)
    monkeypatch.setattr(jloop.TrainLoop, "init_state", lambda self, seed: {
        "params": jax.tree.map(jnp.copy, jp), "opt": jopt.adamw_init(jp)})
    monkeypatch.setattr(tloop.TrainLoop, "init_state", lambda self, seed: {
        "params": topt.tree_map(torch.clone, tp),
        "opt": topt.adamw_init(tp)})
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jl = jloop.TrainLoop(
        jcfg, JRT, JDataConfig(2, 24, seed=1),
        jts.TrainConfig(opt=jopt.AdamWConfig(**opt)),
        jloop.LoopConfig(total_steps=5, log_every=1))
    tl = tloop.TrainLoop(
        tconfigs.get_smoke(arch), TRT, DataConfig(2, 24, seed=1),
        tts.TrainConfig(opt=topt.AdamWConfig(**opt)),
        tloop.LoopConfig(total_steps=5, log_every=1), device="cpu")
    assert sorted(tl.data.batch(0)) == ["embeds", "labels"]
    port, ref = tl.run()["history"], jl.run()["history"]
    assert len(port) == 5
    assert [h["step"] for h in port] == [h["step"] for h in ref]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=2e-5)
        np.testing.assert_allclose(p["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


# ---- serving steps ------------------------------------------------------------------
def _steps(arch, cache_dtype="float32", batch=2, max_len=32):
    cfg, jp, tp = both_params(arch)
    tcfg = tconfigs.get_smoke(arch)
    jsc = jengine.ServeConfig(batch=batch, max_len=max_len,
                              cache_dtype=cache_dtype)
    tsc = tengine.ServeConfig(batch=batch, max_len=max_len,
                              cache_dtype=cache_dtype)
    return cfg, jp, tp, tcfg, jsc, tsc


def test_qwen2_vl_prefill_and_decode_steps_match_reference():
    """qwen2-vl's prefill step on 9 rows of embeddings into an f32 cache,
    then 3 decode steps each fed one row of embeddings: the prefill's
    last logits and every step's f32 logits and next token as the JAX
    package's steps give them, the caches (k, v, pos) after each."""
    cfg, jp, tp, tcfg, jsc, tsc = _steps("qwen2-vl-7b")
    e = embeds(cfg, 2, 12, seed=7)
    jpre = jax.jit(jengine.make_prefill_step(cfg, JRT, jsc))
    jdec = jax.jit(jengine.make_decode_step(cfg, JRT, jsc))
    tpre = tengine.make_prefill_step(tcfg, TRT, tsc, device="cpu")
    tdec = tengine.make_decode_step(tcfg, TRT, tsc)
    exp, jc = jpre(jp, {"embeds": jnp.asarray(e[:, :9])})
    got, tc = tpre(tp, {"embeds": torch.from_numpy(e[:, :9])})
    close(got, exp, "prefill logits")
    for t in range(9, 12):
        jn, jlg, jc = jdec(jp, jc, jnp.asarray(e[:, t:t + 1]))
        tn, tlg, tc = tdec(tp, tc, torch.from_numpy(e[:, t:t + 1]))
        close(tlg, jlg, f"decode {t} logits")
        assert tn.tolist() == np.asarray(jn).tolist()
        for i in jc:
            for name in ("k", "v"):
                close(tc[i][name], jc[i][name], f"decode {t} cache {name}")
            assert tc[i]["pos"].tolist() == np.asarray(jc[i]["pos"]).tolist()


def test_hubert_prefill_step_matches_reference_and_has_no_decode():
    """hubert's prefill step (the encoder's forward writing a cache, no
    causal mask) against the JAX package's, its last logits and cache;
    the forward without a cache gives the same logits; there is no
    decode step."""
    cfg, jp, tp, tcfg, jsc, tsc = _steps("hubert-xlarge")
    e = embeds(cfg, 2, 19, seed=8)
    exp, jc = jax.jit(jengine.make_prefill_step(cfg, JRT, jsc))(
        jp, {"embeds": jnp.asarray(e)})
    got, tc = tengine.make_prefill_step(tcfg, TRT, tsc, device="cpu")(
        tp, {"embeds": torch.from_numpy(e)})
    close(got, exp, "prefill logits")
    for name in ("k", "v"):
        close(tc["0"][name], jc["0"][name], f"cache {name}")
    assert tc["0"]["pos"].tolist() == np.asarray(jc["0"]["pos"]).tolist()
    full, _ = tmodel.forward(tp, tcfg, TRT, {"embeds": torch.from_numpy(e)})
    close(got, full[:, -1].numpy(), "prefill against the forward")
    with pytest.raises(AssertionError, match="encoder-only"):
        tengine.make_decode_step(tcfg, TRT, tsc)
