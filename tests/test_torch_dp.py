"""Data-parallel training of the port (``repro_torch.train``) on 4 gloo
ranks against the JAX package's on 4 forced host devices.

The JAX package's side runs once, in one subprocess, over meshes of its
own ``repro.launch.mesh.make_mesh`` (``jax.make_mesh`` gives explicit
axes in jax 0.9, on which its pjit step's sharding constraints raise:
the cause of its own ``test_manual_dp``, ``test_runtime_layouts`` and
``test_moe_ep`` failing).  It runs beside the port's ranks
(``tests/_torch_ranks.py``) and its launcher under ``torchrun``.  The
model is the JAX package's ``test_manual_dp`` model (2 layers, d_model
64, f32 compute), on the JAX package's parameters carried across through
``repro_torch.interop`` (drawn here by the same eager calls, and held
equal to the subprocess's).

The mesh step is held at grad_accum 1 on (4,) and on (2, 2) with the
model axis folded in, and at grad_accum 2 on (4,) with f32 and
``int8_ef`` microbatch gradients.

Tolerances: loss rtol 1e-5, grad norm rtol 2e-5, parameters within the
JAX package's own 5e-4 (``tests/test_manual_dp.py``); under the int8
wire ten steps of losses at rtol 1e-4 and the residuals within 1e-6 but
where one side's ``g / scale`` rounds the other way (1 element of 8192
of one leaf, off by one quantisation step, 1.93e-6; ``_residuals_close``);
the launcher at the loop's tolerances (loss 2e-5, grad norm 1e-4,
``tests/test_torch_train_loop.py``).  Manual DP is held rank by rank:
rank ``i`` against mesh device ``i``'s buffers, since under ``int8_ef``
each rank scales by its own ``max|g|`` and the ranks drift apart
(ROADMAP §C).  The elastic restore is bitwise.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_ranks import (DP_CFG, dp_rank, finish_reference, nested,
                          run_ranks, start_reference, SRC)
from repro import configs as jconfigs
from repro.dist.sharding import Runtime as JRuntime
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JModelConfig

WORLD = 4
LAUNCH = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--mesh", "4",
          "--steps", "4", "--global-batch", "8", "--seq", "64"]

_PROG = """import contextlib, io, json, sys, tempfile
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from repro.dist.sharding import Runtime
from repro.launch import train as launch
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.models.config import ModelConfig
from repro.train.manual_dp import ManualDPConfig, make_manual_dp_step
from repro.train.optimizer import AdamWConfig, adamw_init
from repro.train.train_step import TrainConfig, make_train_step

n = 4
out = {}


def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[f"{prefix}/{name}"] = np.asarray(leaf)


def per_device(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shards = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
        out[f"{prefix}/{name}"] = np.stack([np.asarray(s.data)
                                            for s in shards])


cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
                  vocab=256, dtype="float32", remat="none")
params0 = M.init_params(cfg, Runtime(), jax.random.PRNGKey(0))
flat(params0, "init")
flat(M.init_params(configs.get_smoke("yi-9b"), Runtime(),
                   jax.random.PRNGKey(0)), "yi_init")
tok = jnp.asarray(np.arange(8 * 32).reshape(8, 32) % 256, jnp.int32)
batch = {"tokens": tok, "labels": tok}
oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)

# the pjit step at (4,) and at (2, 2) with the model axis folded in
for name, shape, axes, kw in (("d4", (4,), ("data",), {}),
                              ("d2m2", (2, 2), ("data", "model"),
                               dict(tp_disabled=True))):
    mesh = make_mesh(shape, axes)
    rt = Runtime(mesh=mesh, data_axes=("data",), **kw)
    with mesh:
        step = jax.jit(make_train_step(cfg, rt, TrainConfig(opt=oc)))
        p, o = params0, adamw_init(params0)
        for i in range(2):
            p, o, m = step(p, o, batch, jax.random.PRNGKey(1))
            out[f"pjit_{name}/loss{i}"] = np.asarray(m["loss"])
            out[f"pjit_{name}/gnorm{i}"] = np.asarray(m["grad_norm"])
    flat(p, f"pjit_{name}/params")

# the pjit step at grad_accum 2 on (4,), f32 and int8-quantised
# microbatch gradients
mesh = make_mesh((4,), ("data",))
rt = Runtime(mesh=mesh, data_axes=("data",))
for name, compress in (("ga2_none", "none"), ("ga2_int8_ef", "int8_ef")):
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50,
                                     compress=compress), grad_accum=2)
    with mesh:
        step = jax.jit(make_train_step(cfg, rt, tc))
        p, o = params0, adamw_init(params0)
        for i in range(2):
            p, o, m = step(p, o, batch, jax.random.PRNGKey(1))
            out[f"pjit_{name}/loss{i}"] = np.asarray(m["loss"])
            out[f"pjit_{name}/gnorm{i}"] = np.asarray(m["grad_norm"])
    flat(p, f"pjit_{name}/params")

# manual DP at each wire, device by device
mesh = make_mesh((n,), ("data",))
rt = Runtime(mesh=mesh, data_axes=("data",), tp_disabled=True)
ef0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params0)
for wire in ("float32", "bfloat16", "int8_ef"):
    with mesh:
        man = jax.jit(make_manual_dp_step(
            cfg, rt, ManualDPConfig(opt=oc, wire=wire, n_rings=3)))
        p, o, e = params0, adamw_init(params0), ef0
        steps = 10 if wire == "int8_ef" else 1
        for i in range(steps):
            p, o, e, m = man(p, o, e, batch)
            per_device(m, f"man_{wire}/metrics{i}")
            if i == 0:
                per_device(p, f"man_{wire}/params1")
                per_device(e, f"man_{wire}/ef1")
    per_device(p, f"man_{wire}/params")

# elastic restore: (4, 1) P("data", None) onto (2, 2) P("model", "data")
mesh_a = make_mesh((4, 1), ("data", "model"))
mesh_b = make_mesh((2, 2), ("data", "model"))
x = jnp.arange(16 * 12, dtype=jnp.float32).reshape(16, 12)
with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d, 5, {"w": jax.device_put(
        x, NamedSharding(mesh_a, P("data", None)))}, {"next_step": 5})
    like = {"w": jax.device_put(jnp.zeros_like(x),
                                NamedSharding(mesh_b, P("model", "data")))}
    restored, extra = restore_checkpoint(d, like)
    assert extra["next_step"] == 5
    assert restored["w"].sharding.spec == P("model", "data")
per_device(restored, "elastic")

# the launcher on a mesh of 4
sys_argv = sys.argv
sys.argv = ["train", "--arch", "yi-9b", "--smoke", "--mesh", "4",
            "--steps", "4", "--global-batch", "8", "--seq", "64"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    launch.main()
sys.argv = sys_argv
hist = [json.loads(l) for l in buf.getvalue().splitlines()
        if l.startswith("{")]
out["launch/step"] = np.array([h["step"] for h in hist])
out["launch/loss"] = np.array([h["loss"] for h in hist])
out["launch/grad_norm"] = np.array([h["grad_norm"] for h in hist])
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


def _flat_arrays(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[f"{prefix}/{name}"] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference arrays, the port's 4 ranks' results, the launcher's
    stdout, the initial parameters drawn here)."""
    d = tmp_path_factory.mktemp("dp")
    ref_proc = start_reference(_PROG, WORLD, d / "ref.npz")
    try:
        init = _flat_arrays(jmodel.init_params(
            JModelConfig(**DP_CFG), JRuntime(), jax.random.PRNGKey(0)),
            "init")
        yi = _flat_arrays(jmodel.init_params(
            jconfigs.get_smoke("yi-9b"), JRuntime(), jax.random.PRNGKey(0)),
            "init")
        np.savez(d / "yi_init.npz", **yi)
        tok = np.arange(8 * 32).reshape(8, 32) % 256
        port = run_ranks(dp_rank, WORLD, d, nested(init, "init"), tok,
                         str(d / "ckpt"), timeout=110)
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        launch = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(WORLD),
             os.path.join(os.path.dirname(__file__), "_torch_launch.py"),
             str(d / "yi_init.npz"), *LAUNCH],
            capture_output=True, text=True, timeout=110, env=env)
        assert launch.returncode == 0, (launch.stdout[-2000:],
                                        launch.stderr[-4000:])
    finally:
        ref = finish_reference(ref_proc, d / "ref.npz", timeout=150)
    return ref, port, launch.stdout, init, yi


def test_initial_parameters_are_the_reference_subprocess(runs):
    ref, _, _, init, yi = runs
    for k, a in init.items():
        np.testing.assert_array_equal(a, ref[k])
    for k, a in yi.items():
        np.testing.assert_array_equal(a, ref["yi_" + k])


def _params_close(got, ref, prefix, atol=5e-4, row=None):
    names = [k for k in ref if k.startswith(prefix + "/")]
    assert names
    for k in names:
        exp = ref[k] if row is None else ref[k][row]
        np.testing.assert_allclose(got[k], exp, rtol=0, atol=atol,
                                   err_msg=k)


def _residuals_close(got, ref, prefix, rank):
    """The int8 residuals ``g - q scale``: all but 1e-3 of each leaf's
    elements within 1e-6; the rest within one quantisation step (twice
    the leaf's largest residual), where ``g / scale`` sat on a rounding
    half and the two sides' f32 gradients rounded it apart."""
    names = [k for k in ref if k.startswith(prefix + "/")]
    assert names
    for k in names:
        exp = ref[k][rank]
        err = np.abs(got[k] - exp)
        assert np.mean(err > 1e-6) <= 1e-3, (k, float(err.max()))
        assert err.max() <= 2 * np.abs(exp).max() + 1e-6, k


@pytest.mark.parametrize("layout", ["d4", "d2m2"])
def test_mesh_step_matches_pjit_step(runs, layout):
    """Two steps of the sharded train step, (4,) and (2, 2) with the
    model axis folded in (``tp_disabled``)."""
    ref, port, *_ = runs
    for out in port:
        for i in range(2):
            np.testing.assert_allclose(
                out[f"pjit_{layout}/loss{i}"], ref[f"pjit_{layout}/loss{i}"],
                rtol=1e-5)
            np.testing.assert_allclose(
                out[f"pjit_{layout}/gnorm{i}"],
                ref[f"pjit_{layout}/gnorm{i}"], rtol=2e-5)
    _params_close(port[0], ref, f"pjit_{layout}/params")


@pytest.mark.parametrize("compress", ["none", "int8_ef"])
def test_mesh_step_grad_accum_matches_pjit_step(runs, compress):
    """Two steps at grad_accum 2 on (4,): each microbatch is the global
    batch's leading rows, one row a rank; under ``int8_ef`` its gradient
    is reduced over the ranks before it is quantised, with one scale a
    leaf as in the pjit step."""
    ref, port, *_ = runs
    name = f"ga2_{compress}"
    for out in port:
        for i in range(2):
            np.testing.assert_allclose(
                out[f"pjit_{name}/loss{i}"], ref[f"pjit_{name}/loss{i}"],
                rtol=1e-5)
            np.testing.assert_allclose(
                out[f"pjit_{name}/gnorm{i}"], ref[f"pjit_{name}/gnorm{i}"],
                rtol=2e-5)
    _params_close(port[0], ref, f"pjit_{name}/params")


def test_mesh_step_grad_accum_needs_microbatches_over_the_ranks(runs):
    """grad_accum 4 splits 8 rows into microbatches of 2, which do not
    divide over 4 ranks: a ValueError naming the numbers, on every
    rank."""
    _, port, *_ = runs
    for out in port:
        assert out["ga4_raises"] == ("grad_accum 4 splits the global batch "
                                     "of 8 rows into microbatches of 2, "
                                     "which do not divide over 4 data ranks")


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8_ef"])
def test_manual_dp_rank_by_rank(runs, wire):
    ref, port, *_ = runs
    steps = 10 if wire == "int8_ef" else 1
    for rank, out in enumerate(port):
        np.testing.assert_allclose(out[f"man_{wire}/loss0"],
                                   ref[f"man_{wire}/metrics0/loss"][rank],
                                   rtol=1e-5)
        np.testing.assert_allclose(
            out[f"man_{wire}/gnorm0"],
            ref[f"man_{wire}/metrics0/grad_norm"][rank], rtol=2e-5)
        np.testing.assert_allclose(
            [out[f"man_{wire}/loss{i}"] for i in range(steps)],
            [ref[f"man_{wire}/metrics{i}/loss"][rank] for i in range(steps)],
            rtol=1e-4)
        _params_close(out, ref, f"man_{wire}/params1", row=rank)
        _params_close(out, ref, f"man_{wire}/params", row=rank)
        if wire == "int8_ef":
            _residuals_close(out, ref, f"man_{wire}/ef1", rank)
    if wire == "int8_ef":
        losses = [port[0][f"man_{wire}/loss{i}"] for i in range(steps)]
        assert np.all(np.isfinite(losses))
        assert losses[-1] < losses[0] - 0.2, losses
    else:   # the float wires keep the ranks bitwise equal
        for out in port[1:]:
            for k, a in port[0].items():
                if k.startswith(f"man_{wire}/params"):
                    np.testing.assert_array_equal(out[k], a, err_msg=k)
    # per leaf: 3 rings, 2 (n - 1) steps each, each step sending one
    # chunk of its ring's padded slice
    itemsize = {"float32": 4, "bfloat16": 2, "int8_ef": 4}[wire]
    chunks = sum(-(-ref[k].size // (WORLD * 3)) for k in ref
                 if k.startswith("init/"))
    assert port[0][f"man_{wire}/sent_bytes"] == \
        steps * 3 * 2 * (WORLD - 1) * chunks * itemsize


def test_elastic_restore_onto_another_mesh_bitwise(runs):
    ref, port, *_ = runs
    for rank, out in enumerate(port):
        assert out["elastic_extra"] == {"next_step": 5}
        np.testing.assert_array_equal(out["elastic"], ref["elastic/w"][rank])


def test_loop_resumed_on_another_mesh_continues_bitwise(runs):
    """A loop on (4,) that fails at step 2 and resumes from its
    checkpoint on (2, 2) with the model axis folded in (the same shards)
    gives the uninterrupted run's losses, norms and parameters."""
    _, port, *_ = runs
    for out in port:
        whole = out["loop_whole"]
        assert [h[0] for h in whole] == [0, 1, 2, 3]
        assert out["loop_resumed"] == whole[2:]
        assert out["loop_params_equal"]
        assert out["tp_raises"]
        assert out["host_device_runtime"] == ({"data": WORLD}, WORLD)
        assert out["hdr_raises"]


def test_launcher_under_torchrun_matches_reference_launcher(runs):
    ref, _, stdout, *_ = runs
    import json
    lines = stdout.splitlines()
    assert any(l.startswith("mesh {'data': 4}: 4 ranks, backend gloo")
               for l in lines), stdout
    hist = [json.loads(l) for l in lines if l.startswith("{")]
    assert [h["step"] for h in hist] == ref["launch/step"].tolist()
    np.testing.assert_allclose([h["loss"] for h in hist],
                               ref["launch/loss"], rtol=2e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               ref["launch/grad_norm"], rtol=1e-4)
