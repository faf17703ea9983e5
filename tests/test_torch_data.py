"""The port's synthetic data pipeline and training checkpoints against
the JAX package's, on the CPU.

Batches are held bitwise (the same numpy draws from the same
``SeedSequence``); the checkpoint format is held to the JAX package's
contract (``tests/test_ckpt.py``): round trip, uncommitted steps
ignored, checksums, latest step and retention, shape mismatch, and the
JAX package restoring a checkpoint the port wrote.
"""

import os

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.data.pipeline import make_global_batch as jmake
from repro.dist.sharding import Runtime as JRuntime
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.data.pipeline import DataConfig, SyntheticDataset, \
    make_global_batch
from repro_torch.dist.sharding import Runtime
from repro_torch.models.config import ModelConfig

JRT, RT = JRuntime(mesh=None), Runtime()


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, d_head=16, d_ff=64, vocab=256, dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("kind", ["lm", "bytes"])
@pytest.mark.parametrize("seed,step,b,s,vocab", [(0, 0, 4, 64, 256),
                                                 (5, 13, 8, 33, 100),
                                                 (2, 7, 2, 512, 64000)])
def test_batches_bitwise_the_reference(kind, seed, step, b, s, vocab):
    jc, tc = _cfgs(vocab=vocab)
    jb = JDataset(jc, JDataConfig(b, s, seed=seed, kind=kind), JRT).batch(step)
    tb = SyntheticDataset(tc, DataConfig(b, s, seed=seed, kind=kind), RT,
                          "cpu").batch(step)
    assert sorted(tb) == sorted(jb) == ["labels", "tokens"]
    assert tb["tokens"].dtype == torch.int64
    assert tb["labels"] is tb["tokens"]
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    tg = make_global_batch(tc, RT, b, s, step, seed, kind, device="cpu")
    np.testing.assert_array_equal(
        tg["tokens"].numpy(), np.asarray(jmake(jc, JRT, b, s, step, seed,
                                               kind)["tokens"]))


def test_frontend_embeds_bitwise_the_reference():
    jc, tc = _cfgs(family="audio", causal=False, frontend="audio",
                   frontend_dim=24)
    jb = JDataset(jc, JDataConfig(4, 32, seed=3), JRT).batch(2)
    tb = SyntheticDataset(tc, DataConfig(4, 32, seed=3), RT, "cpu").batch(2)
    assert sorted(tb) == sorted(jb) == ["embeds", "labels"]
    assert tb["embeds"].dtype == torch.float32
    np.testing.assert_array_equal(tb["embeds"].numpy(),
                                  np.asarray(jb["embeds"]))
    np.testing.assert_array_equal(tb["labels"].numpy(),
                                  np.asarray(jb["labels"]))


def test_dataset_takes_an_explicit_device():
    _, tc = _cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SyntheticDataset(tc, DataConfig(2, 8), RT)
    with pytest.raises(ValueError, match="kind"):
        SyntheticDataset(tc, DataConfig(2, 8, kind="zipf"), RT, "cpu")


# ---- checkpoints -------------------------------------------------------------
def _state(x=1.0):
    return {"a": {"w": torch.full((4, 3), x), "b": torch.arange(5),
                  "h": torch.full((2, 2), x, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    save_checkpoint(str(tmp_path), 3, _state(2.5), {"next_step": 3})
    got, extra = restore_checkpoint(str(tmp_path), _state(0.0))
    assert torch.equal(got["a"]["w"], torch.full((4, 3), 2.5))
    assert got["a"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["a"]["h"], torch.full((2, 2), 2.5,
                                                 dtype=torch.bfloat16))
    assert torch.equal(got["a"]["b"], torch.arange(5))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    assert extra["next_step"] == 3


def test_reference_restores_the_ports_checkpoint(tmp_path):
    """The same files: the JAX package reads a step of f32 and integer
    leaves that the port wrote, checksums and all.  (bf16 leaves are the
    port's 16-bit patterns, which only the port reads back as bf16.)"""
    import jax.numpy as jnp
    state = _state(1.5)
    del state["a"]["h"]
    save_checkpoint(str(tmp_path), 4, state, {"next_step": 4})
    like = {"a": {"w": jnp.zeros((4, 3)), "b": jnp.zeros(5, jnp.int32)},
            "step": jnp.asarray(0)}
    got, extra = jckpt.restore_checkpoint(str(tmp_path), like)
    np.testing.assert_array_equal(np.asarray(got["a"]["w"]), 1.5)
    np.testing.assert_array_equal(np.asarray(got["a"]["b"]), np.arange(5))
    assert extra == {"next_step": 4}


def test_uncommitted_checkpoint_ignored(tmp_path):
    p = save_checkpoint(str(tmp_path), 5, _state())
    os.remove(os.path.join(p, "COMMIT"))
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), _state())


def test_checksum_detects_corruption(tmp_path):
    p = save_checkpoint(str(tmp_path), 1, _state())
    shard = os.path.join(p, "shard_00000.npz")
    data = dict(np.load(shard))
    data["a/w"] = data["a/w"] + 1
    np.savez(shard, **data)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), _state())


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, _state(float(s)))
        mgr.wait()
    assert latest_step(str(tmp_path)) == 30
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(tmp_path)
                   if x.startswith("step_"))
    assert steps == [20, 30], "gc keeps the last 2"
    got, _ = mgr.restore_latest(_state(0.0))
    assert float(got["a"]["w"][0, 0]) == 30.0


def test_save_copies_to_the_host_before_returning(tmp_path):
    """The asynchronous writer works on a host copy: changing the state
    in place right after ``save`` changes nothing on disk."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    st = _state(1.0)
    mgr.save(1, st)
    st["a"]["w"].fill_(9.0)
    mgr.wait()
    got, _ = restore_checkpoint(str(tmp_path), _state(0.0))
    assert torch.equal(got["a"]["w"], torch.full((4, 3), 1.0))


def test_restore_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state())
    bad = _state()
    bad["a"]["w"] = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), bad)
