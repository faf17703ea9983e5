"""The port's serving path (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) against the JAX package's, on the CPU.

Both engines run the smoke configs of the dense attention family, of
the mixture-of-experts family (olmoe-1b-7b; deepseek-v2-236b, whose
decode is the absorbed latent attention) and of the recurrent families
(zamba2-1.2b, rwkv6-7b, whose SSM and RWKV caches stay f32 under either
cache dtype) on the JAX package's parameters (carried across by
``repro_torch.interop``) over
the same prompts, under both cache dtypes.  Their tokens must be equal,
and the logits of every step (the prefill's last-token logits and each
decode step's f32 logits after the final softcap) within tolerance:

* f32 cache: |port - ref| <= 1e-5 |ref| + 1e-5 max|ref|, the f32
  tolerance of ``test_torch_models``;
* bf16 cache: the same bound, though the caches need not be equal.  The
  two packages write the cache from k and v that differ in their last
  f32 bits, so now and then an entry rounds to the neighbouring bf16
  value, 2^-8 of the entry apart (one of 4 096 to 8 192 in layer 0 here).
  Through the softmax such an entry moves the logits by far less than the
  bound: the largest gap seen on these configs is 7.2e-7 of max|ref|,
  against 5.8e-7 with f32 caches.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import Runtime as JRuntime
from repro.models import model as jmodel
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.dist.sharding import Runtime as TRuntime
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServingEngine as TEngine

JRT, TRT = JRuntime(mesh=None), TRuntime()
DENSE = ["yi-9b", "glm4-9b", "qwen2.5-32b", "gemma2-27b"]
MOE = ["olmoe-1b-7b", "deepseek-v2-236b"]
RECURRENT = ["zamba2-1.2b", "rwkv6-7b"]
RTOL = 1e-5


def _recorded(eng, logits):
    """Wrap the engine's prefill and decode steps so that every step's
    logits are appended to ``logits`` as f32 numpy arrays."""
    prefill, decode = eng.prefill, eng.decode

    def host(x):
        return (x.float().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.float32))

    def rec_prefill(params, batch):
        lg, cache = prefill(params, batch)
        logits.append(host(lg))
        return lg, cache

    def rec_decode(params, cache, toks):
        nxt, lg, cache = decode(params, cache, toks)
        logits.append(host(lg))
        return nxt, lg, cache

    eng.prefill, eng.decode = rec_prefill, rec_decode


@functools.lru_cache(maxsize=None)
def both_params(arch):
    """The JAX package's parameters of a smoke config and the port's copy
    (shared by both cache dtypes; the engines write to neither)."""
    cfg = jconfigs.get_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, JRT, key))(
        jax.random.PRNGKey(0))
    return jp, interop.model_params_from_arrays(
        tconfigs.get_smoke(arch), jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_engine_matches_reference(arch, cache_dtype):
    cfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp, tp = both_params(arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in (3, 8, 5)]
    jl, tl = [], []
    jeng = JEngine(cfg, JRT, jp, JServeConfig(batch=4, max_len=32,
                                              cache_dtype=cache_dtype))
    teng = TEngine(tcfg, TRT, tp, TServeConfig(batch=4, max_len=32,
                                               cache_dtype=cache_dtype),
                   device="cpu")
    _recorded(jeng, jl)
    _recorded(teng, tl)
    exp = jeng.run(prompts, max_new=8)
    got = teng.run(prompts, max_new=8)
    assert got == exp
    assert all(len(o) == 9 for o in got)
    assert len(tl) == len(jl) == 9
    for i, (g, e) in enumerate(zip(tl, jl)):
        assert g.shape == e.shape == (4, cfg.vocab)
        np.testing.assert_allclose(g, e, rtol=RTOL,
                                   atol=RTOL * float(np.abs(e).max()),
                                   err_msg=f"step {i}")
    # The engine's weights are cast once to the compute dtype (f32 here:
    # the same tensors), the norms' scales kept as they are.
    assert teng.params["blocks"]["0"]["ln1"]["scale"].dtype == torch.float32


def test_engine_casts_the_weights_once_to_the_compute_dtype():
    """bf16 compute: every weight held in bf16 but the norms' scales, and
    the forward on the cast tree gives the bits of the forward on the f32
    masters (which casts at every use)."""
    cfg = dataclasses.replace(tconfigs.get_smoke("gemma2-27b"),
                              dtype="bfloat16")
    params = tmodel.init_params(cfg, TRT, torch.Generator().manual_seed(2),
                                "cpu")
    cast = tmodel.cast_params(params, cfg)
    assert cast["blocks"]["1"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["embed"]["tok"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 9)))
    a, _ = tmodel.forward(params, cfg, TRT, {"tokens": toks})
    b, _ = tmodel.forward(cast, cfg, TRT, {"tokens": toks})
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("arch", RECURRENT)
def test_cast_params_is_bitwise_for_the_recurrent_families(arch):
    """bf16 compute: the leaves the recurrent blocks read in f32 (the
    SSM's ``A_log``, ``dt_bias`` and ``D``, RWKV6's ``w0`` and ``u``, the
    norms' scales) keep f32, every other weight is held in bf16, and a
    prefill and two decode steps on the cast tree give the bits of the
    same on the f32 masters, logits and every cache leaf."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="bfloat16")
    params = tmodel.init_params(cfg, TRT, torch.Generator().manual_seed(4),
                                "cpu")
    cast = tmodel.cast_params(params, cfg)
    if arch == "zamba2-1.2b":
        kept = [cast["blocks"]["0"]["ssm"][k] for k in ("A_log", "dt_bias",
                                                        "D")]
        assert cast["blocks"]["0"]["ssm"]["conv_w"].dtype == torch.bfloat16
        assert cast["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
        assert cast["blocks"]["3"] == {}
    else:
        kept = [cast["blocks"]["0"]["rwkv"]["tm"][k] for k in ("w0", "u")]
        assert cast["blocks"]["0"]["rwkv"]["tm"]["mu"].dtype == \
            torch.bfloat16
    assert all(t.dtype == torch.float32 for t in kept)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (2, 11)))
    outs = []
    for p in (params, cast):
        cache = tmodel.init_cache(cfg, TRT, 2, 16, device="cpu")
        got = [tmodel.forward(p, cfg, TRT, {"tokens": toks[:, :9]},
                              cache=cache)[0]]
        for t in (9, 10):
            got.append(tmodel.forward(p, cfg, TRT,
                                      {"tokens": toks[:, t:t + 1]},
                                      cache=cache)[0])
        outs.append((got, cache))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for i in outs[0][1]:
        for k, t in outs[0][1][i].items():
            assert torch.equal(t, outs[1][1][i][k]), (i, k)


def test_launcher_serves_on_the_cpu(capsys):
    args = ["--arch", "yi-9b", "--smoke", "--device", "cpu",
            "--n-requests", "6", "--max-new", "5", "--seed", "3"]
    outs = tlaunch.main(args)
    assert len(outs) == 6 and all(len(o) == 6 for o in outs)
    vocab = tconfigs.get_smoke("yi-9b").vocab
    assert all(0 <= t < vocab for o in outs for t in o)
    text = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in text[:6]] == \
        [f"req {i}" for i in range(6)]
    assert text[-1].startswith("6 requests, 36 tokens in ")
    assert text[-1].endswith("on cpu")
    assert tlaunch.main(args) == outs        # the seed fixes everything


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "yi-9b", "--smoke"])
    cfg = tconfigs.get_smoke("yi-9b")
    params = tmodel.init_params(cfg, TRT, torch.Generator().manual_seed(0),
                                "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(cfg, TRT, params, TServeConfig(batch=1, max_len=8))


def test_engine_rejects_what_is_not_ported(monkeypatch):
    """The engine serves token prompts, as the JAX package's feeds them
    (whose ``run`` fails on a frontend model's missing ``embeds``): the
    frontend models are refused with a ``ValueError`` that names the
    steps to drive instead, by the engine and by the launcher before it
    draws any weight (also for the full configs, and for ``cuda``
    without a card)."""
    def drawn(*a, **kw):
        raise AssertionError("weights drawn")
    monkeypatch.setattr(tmodel, "init_params", drawn)
    for arch in ("qwen2-vl-7b", "hubert-xlarge"):
        cfg = tconfigs.get_smoke(arch)
        with pytest.raises(ValueError, match="make_prefill_step"):
            TEngine(cfg, TRT, {}, TServeConfig(batch=1, max_len=8),
                    device="cpu")
        for argv in (["--arch", arch, "--smoke", "--device", "cpu"],
                     ["--arch", arch]):
            with pytest.raises(ValueError, match="embeddings, not token"):
                tlaunch.main(argv)
