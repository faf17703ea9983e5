"""The port's training loop and launcher (``repro_torch.train.loop``,
``repro_torch.launch.train``) against the JAX package's, on the CPU, and
serving what training made.

Histories run on the JAX package's initial parameters (the port's
``TrainLoop.init_state`` is replaced by one that carries them across
through ``repro_torch.interop``); the batches are the same by
construction (``tests/test_torch_data.py``).  Tolerance: each logged loss
within rtol 2e-5 and grad norm within 1e-4.  The first step differs by
f32 sums in other orders (1e-5 and 2e-5, ``tests/test_torch_train.py``);
after it the parameters drift apart where a bf16 wire gradient rounds
the other way or an Adam update sits at its ``eps``
(``tests/test_torch_train_steps.py``), by 3e-5 of the grad norm after
five steps of gemma2-27b smoke.
The mixture-of-experts family's histories also carry the experts' aux
loss, which the JAX package's loop does not log.
The port's own crash-and-restart is held exactly: on the CPU every step
is deterministic.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.dist.sharding import Runtime as JRuntime
from repro.launch import train as jlaunch
from repro.models import model as jmodel
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.sharding import Runtime
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import ServeConfig, ServingEngine
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

JRT, TRT = JRuntime(mesh=None), Runtime()


def ref_params(tcfg, seed=0):
    """The JAX package's smoke parameters of ``tcfg``'s architecture,
    as the port's tree."""
    jcfg = jconfigs.get_smoke(tcfg.name.replace("-smoke", ""))
    jp = jax.jit(lambda key: jmodel.init_params(jcfg, JRT, key))(
        jax.random.PRNGKey(seed))
    return interop.model_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp), "cpu")


def ref_init_state(self, seed=0):
    params = ref_params(self.cfg, seed)
    return {"params": params, "opt": topt.adamw_init(params)}


def close_history(port, ref):
    assert [h["step"] for h in port] == [h["step"] for h in ref]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=2e-5)
        np.testing.assert_allclose(p["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


def test_loop_history_matches_reference(monkeypatch):
    monkeypatch.setattr(tloop.TrainLoop, "init_state", ref_init_state)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jl = jloop.TrainLoop(
        jconfigs.get_smoke("gemma2-27b"), JRT, JDataConfig(2, 24, seed=1),
        jts.TrainConfig(opt=jopt.AdamWConfig(**opt)),
        jloop.LoopConfig(total_steps=5, log_every=1))
    tl = tloop.TrainLoop(
        tconfigs.get_smoke("gemma2-27b"), TRT, DataConfig(2, 24, seed=1),
        tts.TrainConfig(opt=topt.AdamWConfig(**opt)),
        tloop.LoopConfig(total_steps=5, log_every=1), device="cpu")
    port, ref = tl.run()["history"], jl.run()["history"]
    assert len(port) == 5
    close_history(port, ref)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_loop_history_matches_reference(monkeypatch, arch):
    """The mixture-of-experts family: four logged steps' loss and grad
    norm held to the JAX package's loop; each entry carries the experts'
    aux loss, the first one's within rtol 1e-5 of the JAX package's
    ``loss_fn`` on the same parameters and batch."""
    jcfg = jconfigs.get_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(jcfg, JRT, key))(
        jax.random.PRNGKey(0))
    tp = interop.model_params_from_arrays(
        tconfigs.get_smoke(arch), jax.tree.map(np.asarray, jp), "cpu")
    # Both loops start from these parameters (the JAX package's own init
    # draws the same ones, eagerly and slower).
    monkeypatch.setattr(jloop.TrainLoop, "init_state", lambda self, seed: {
        "params": jax.tree.map(jnp.copy, jp), "opt": jopt.adamw_init(jp)})
    monkeypatch.setattr(tloop.TrainLoop, "init_state", lambda self, seed: {
        "params": topt.tree_map(torch.clone, tp),
        "opt": topt.adamw_init(tp)})
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    jl = jloop.TrainLoop(
        jcfg, JRT, JDataConfig(2, 16, seed=1),
        jts.TrainConfig(opt=jopt.AdamWConfig(**opt)),
        jloop.LoopConfig(total_steps=4, log_every=1))
    tl = tloop.TrainLoop(
        tconfigs.get_smoke(arch), TRT, DataConfig(2, 16, seed=1),
        tts.TrainConfig(opt=topt.AdamWConfig(**opt)),
        tloop.LoopConfig(total_steps=4, log_every=1), device="cpu")
    port, ref = tl.run()["history"], jl.run()["history"]
    assert len(port) == 4
    close_history(port, ref)
    # The JAX package's first step again (its jitted step, compiled by the
    # run), for the aux its loop does not log.
    _, _, jm = jl.step_fn(jax.tree.map(jnp.copy, jp), jopt.adamw_init(jp),
                          jl.data.batch(0), jax.random.PRNGKey(0))
    np.testing.assert_allclose(port[0]["aux"], float(jm["aux"]), rtol=1e-5)
    assert all(np.isfinite(h["aux"]) and h["aux"] > 0 for h in port)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_recurrent_loop_history_matches_reference(monkeypatch, arch):
    """The recurrent families: four logged steps' loss and grad norm held
    to the JAX package's loop from its parameters, 40 tokens a row (above
    2 chunks of 16: zamba2's SSD trains through ``ssd_chunked``); no aux
    is logged without experts."""
    jcfg = jconfigs.get_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(jcfg, JRT, key))(
        jax.random.PRNGKey(0))
    tp = interop.model_params_from_arrays(
        tconfigs.get_smoke(arch), jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(jloop.TrainLoop, "init_state", lambda self, seed: {
        "params": jax.tree.map(jnp.copy, jp), "opt": jopt.adamw_init(jp)})
    monkeypatch.setattr(tloop.TrainLoop, "init_state", lambda self, seed: {
        "params": topt.tree_map(torch.clone, tp),
        "opt": topt.adamw_init(tp)})
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    jl = jloop.TrainLoop(
        jcfg, JRT, JDataConfig(2, 40, seed=2),
        jts.TrainConfig(opt=jopt.AdamWConfig(**opt)),
        jloop.LoopConfig(total_steps=4, log_every=1))
    tl = tloop.TrainLoop(
        tconfigs.get_smoke(arch), TRT, DataConfig(2, 40, seed=2),
        tts.TrainConfig(opt=topt.AdamWConfig(**opt)),
        tloop.LoopConfig(total_steps=4, log_every=1), device="cpu")
    port, ref = tl.run()["history"], jl.run()["history"]
    assert len(port) == 4 and all("aux" not in h for h in port)
    close_history(port, ref)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_launcher_prints_the_aux_beside_the_loss(capsys, grad_accum):
    """Every line carries the experts' aux, also when the step
    accumulates microbatches (then their mean)."""
    tlaunch.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "2",
                  "--global-batch", "2", "--seq", "16", "--log-every", "1",
                  "--grad-accum", str(grad_accum), "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    assert all(sorted(x) == ["aux", "grad_norm", "loss", "step", "wall_s"]
               for x in lines)
    assert all(np.isfinite(x["aux"]) and x["aux"] > 0 for x in lines)


def test_launcher_prints_the_references_history(monkeypatch, capsys):
    argv = ["--arch", "yi-9b", "--smoke", "--steps", "4", "--global-batch",
            "4", "--seq", "64", "--log-every", "1"]
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    jlaunch.main()
    ref_lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    monkeypatch.setattr(tloop.TrainLoop, "init_state", ref_init_state)
    tlaunch.main(argv + ["--device", "cpu"])
    port_lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(port_lines) == 4
    assert all(sorted(x) == ["grad_norm", "loss", "step", "wall_s"]
               for x in port_lines)
    close_history(port_lines, ref_lines)


def test_launcher_device_and_mesh():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--arch", "yi-9b", "--smoke", "--steps", "1"])
    # a model axis above 1 is tensor parallelism, which MLA has no body
    # for yet (ROADMAP A13.5.3e): refused before the ranks are joined
    with pytest.raises(NotImplementedError, match="A13.5.3e"):
        tlaunch.main(["--arch", "deepseek-v2-236b", "--smoke", "--mesh",
                      "2x2", "--device", "cpu"])
    # data parallel needs its ranks: torchrun starts them
    # (tests/test_torch_dp.py)
    with pytest.raises(RuntimeError, match="torchrun --standalone"):
        tlaunch.main(["--arch", "yi-9b", "--smoke", "--mesh", "4",
                      "--device", "cpu"])


def _tiny():
    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                       vocab=128, dtype="float32", remat="none")


def _loop(d, total, inject=None):
    return tloop.TrainLoop(
        _tiny(), TRT, DataConfig(global_batch=8, seq_len=32),
        tts.TrainConfig(opt=topt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                             total_steps=total)),
        tloop.LoopConfig(total_steps=total, ckpt_every=10, log_every=5,
                         ckpt_dir=d, inject_failure_at=inject),
        device="cpu")


def test_failure_injection_and_restart_reproduces_trajectory(tmp_path):
    """Crash at step 17, restart from the step-10 checkpoint: the logged
    losses and grad norms, and the final state, equal a never-crashed
    run's exactly."""
    golden = _loop(str(tmp_path / "a"), 25).run()
    crashed = _loop(str(tmp_path / "b"), 25, inject=17)
    with pytest.raises(RuntimeError, match="injected failure"):
        crashed.run()
    resumed = _loop(str(tmp_path / "b"), 25).run()
    g = {h["step"]: (h["loss"], h["grad_norm"]) for h in golden["history"]}
    r = {h["step"]: (h["loss"], h["grad_norm"]) for h in resumed["history"]}
    assert sorted(r) == [10, 15, 20, 24]
    for step in r:
        assert r[step] == g[step]
    for a, b in zip(topt.tree_leaves(golden["state"]),
                    topt.tree_leaves(resumed["state"])):
        assert torch.equal(a, b)


def test_straggler_detection_with_fake_clock():
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0, 5.0,
                  5.0, 30.0, 30.0, 31.0, 31.0, 32.0])
    loop = tloop.TrainLoop(
        _tiny(), TRT, DataConfig(global_batch=8, seq_len=32),
        tts.TrainConfig(opt=topt.AdamWConfig(warmup_steps=1, total_steps=8)),
        tloop.LoopConfig(total_steps=8, ckpt_every=100, log_every=100),
        clock=lambda: next(ticks), device="cpu")
    assert loop.run()["stragglers"] == [5]


def test_engine_serves_trained_params_without_a_graph(monkeypatch):
    """Parameters that require grad (as a user's trained ones may) give
    the same tokens as their detached copy, and the engine runs its
    forwards with grad mode off."""
    cfg = tconfigs.get_smoke("yi-9b")
    tp = ref_params(cfg)
    st = topt.adamw_init(tp)
    step = tts.make_train_step(cfg, TRT, tts.TrainConfig(
        opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1)))
    rng = np.random.default_rng(0)
    for i in range(2):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
        tp, st, _ = step(tp, st, {"tokens": t, "labels": t}, i)
    detached = topt.tree_map(lambda t: t.detach().clone(), tp)
    trained = topt.tree_map(lambda t: t.clone().requires_grad_(), tp)
    modes = []
    fwd = tmodel.forward

    def spy(*a, **kw):
        modes.append(torch.is_grad_enabled())
        out = fwd(*a, **kw)
        assert out[0].grad_fn is None
        return out
    monkeypatch.setattr(tmodel, "forward", spy)
    sc = ServeConfig(batch=2, max_len=32)
    prompts = [np.array([3, 1, 4, 1, 5]), np.array([9, 2, 6])]
    outs = [ServingEngine(cfg, TRT, p, sc, device="cpu").run(prompts, 6)
            for p in (trained, detached)]
    assert outs[0] == outs[1]
    assert modes and not any(modes)
