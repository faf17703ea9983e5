"""Tensor parallelism of the port (ROADMAP A13.5.3b): one mesh step
(``repro_torch.train.train_step``) of the smoke configs on ``(data,
model)`` meshes of 4 gloo ranks with a model axis above 1, against the
JAX package's pjit step on the same mesh shapes over 4 forced host
devices.

* yi-9b on (2, 2), where its 4 query and 2 KV heads both split, and on
  (1, 4), where the query heads split and the KV heads stay whole (each
  rank reads the KV head of its query head);
* qwen2-vl-7b on (2, 2): the QKV biases, M-RoPE on (3, B, S) positions,
  and the frontend's projection split on ``d``;
* hubert-xlarge on (2, 2): non-causal attention, vocabulary 64;
* olmoe-1b-7b on (2, 2) and (1, 4): the experts' FFN width split, the
  router's gradient summed over the model axis, and the load-balance
  loss each data shard's own, averaged (on (2, 2) not the global batch's
  that one device gives, on (1, 4) the same);
* yi-9b under ``sequence_parallel=True`` on (2, 2), with S even (the
  residual stream split into rows) and S odd (no split, the JAX
  package's fallback), the norms' gradients included;
* yi-9b on (2, 2) at ``grad_accum=2`` under ``int8_ef``: each
  microbatch's gradient quantised with one scale a leaf, its largest
  magnitude taken over the model axis too where the leaf is split.

Besides: ``TrainLoop`` checkpointed on (2, 2), restored on (4,) and back
on (2, 2), against the same loop uninterrupted; and the families
without a model-axis body (MLA, Mamba2, RWKV6: ROADMAP A13.5.3e)
refusing a model axis above 1.

The JAX package's side runs once, its cases split between two
subprocesses, over meshes of its own ``repro.launch.mesh.make_mesh``
(ROADMAP §C), beside the port's spawned ranks
(``tests/_torch_ranks.py``).  Both start from the port's seed-0
parameters and take the same numpy batches (4 rows of 32, two a data
shard), with an f32 gradient wire.  The file takes about 30 s in one
process.

Tolerances (``tests/test_torch_dp_families.py``'s): loss and ``aux``
rtol 1e-5, grad norm rtol 2e-5, parameters within 5e-4; the first
moments of the router and of the norms' scales (AdamW's ``(1 - b1) g``
after one step) within 1e-5 of each leaf's largest; the restored loop's
losses rtol 2e-5 and grad norms 1e-4 (the loop histories' tolerances).
"""

import numpy as np
import pytest
import torch

from _torch_ranks import (TP_OPT, finish_reference, run_ranks,
                          start_reference, tp_rank)
from repro_torch import configs as tconfigs
from repro_torch.dist.sharding import Runtime
from repro_torch.kernels import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.train.optimizer import tree_map

WORLD = 4
B, S = 4, 32
# (name, arch, mesh shape, sequence_parallel, seq, grad_accum under
# int8_ef or 1)
CASES = [("yi_2x2", "yi-9b", (2, 2), False, S, 1),
         ("yi_1x4", "yi-9b", (1, 4), False, S, 1),
         ("qwen2vl_2x2", "qwen2-vl-7b", (2, 2), False, S, 1),
         ("hubert_2x2", "hubert-xlarge", (2, 2), False, S, 1),
         ("olmoe_2x2", "olmoe-1b-7b", (2, 2), False, S, 1),
         ("olmoe_1x4", "olmoe-1b-7b", (1, 4), False, S, 1),
         ("yi_sp_even", "yi-9b", (2, 2), True, S, 1),
         ("yi_sp_odd", "yi-9b", (2, 2), True, S - 1, 1),
         ("yi_ga2_int8", "yi-9b", (2, 2), False, S, 2)]
ARCHS = sorted({c[1] for c in CASES})

_PROG = """import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.dist.sharding import Runtime
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.train.optimizer import AdamWConfig, adamw_init
from repro.train.train_step import TrainConfig, make_train_step

with np.load(sys.argv[2]) as z:
    arrays = {k: z[k] for k in z.files}
out = {}


def nested(prefix):
    tree = {}
    for name, a in arrays.items():
        if name.startswith(prefix + "/"):
            d = tree
            keys = name[len(prefix) + 1:].split("/")
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = jnp.asarray(a)
    return tree


def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[f"{prefix}/{name}"] = np.asarray(leaf)


for case in sys.argv[3].split(","):
    name, arch, shape, sp, seq, ga = case.split(":")
    shape = tuple(int(x) for x in shape.split("x"))
    seq, ga = int(seq), int(ga)
    tc = TrainConfig(opt=AdamWConfig(
        lr=%(lr)r, warmup_steps=%(warmup_steps)r,
        total_steps=%(total_steps)r,
        compress="int8_ef" if ga > 1 else "none"), grad_accum=ga)
    cfg = configs.get_smoke(arch)
    p0 = nested(f"{arch}/params")
    batch = {k: (v[:, :seq] if k == "embeds" else v[..., :seq])
             for k, v in nested(f"{arch}/batch").items()}
    if "tokens" not in batch:
        batch["labels"] = batch["labels"].astype(jnp.int32)
    else:
        batch = {k: v.astype(jnp.int32) for k, v in batch.items()}
    mesh = make_mesh(shape, ("data", "model"))
    rt = Runtime(mesh=mesh, data_axes=("data",), collective_dtype="float32",
                 sequence_parallel=sp == "1")
    with mesh:
        step = jax.jit(make_train_step(cfg, rt, tc))
        p, o, m = step(p0, adamw_init(p0), batch, jax.random.PRNGKey(1))
    for k in ("loss", "aux", "grad_norm"):
        out[f"{name}/{k}"] = np.asarray(m[k])
    flat(p, f"{name}/params")
    flat(o["m"], f"{name}/m")
    if cfg.moe is not None:   # the global batch's aux, on one device
        out[f"{name}/global_aux"] = np.asarray(
            M.loss_fn(p0, cfg, Runtime(), batch)[1]["aux"])
np.savez(sys.argv[1], **out)
print("REF_OK")
""" % TP_OPT


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _arrays():
    """Each arch's seed-0 smoke parameters (the port's draw) and a batch
    of B x S, as flat numpy arrays."""
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in ARCHS:
        cfg = tconfigs.get_smoke(arch)
        params = tmodel.init_params(cfg, Runtime(),
                                    torch.Generator().manual_seed(0), "cpu")
        _flat(tree_map(lambda x: x.numpy(), params), f"{arch}/params",
              arrays)
        if cfg.frontend is None:
            tok = rng.integers(0, cfg.vocab, (B, S))
            batch = {"tokens": tok, "labels": tok}
        else:
            batch = {"embeds": rng.standard_normal(
                (B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S))}
            if cfg.mrope_sections is not None:
                t = np.broadcast_to(np.arange(S) // 4, (B, S))
                batch["positions"] = np.stack(
                    [t, rng.integers(0, 9, (B, S)),
                     rng.integers(0, 13, (B, S))]).astype(np.int32)
        _flat(batch, f"{arch}/batch", arrays)
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    arrays = _arrays()
    np.savez(d / "init.npz", **arrays)
    # The reference's compiles are the long pole: two subprocesses take
    # every other case.
    refs = [(start_reference(
        _PROG, WORLD, d / f"ref{i}.npz", d / "init.npz",
        ",".join(f"{n}:{a}:{'x'.join(map(str, sh))}:{int(sp)}:{s}:{ga}"
                 for n, a, sh, sp, s, ga in CASES[i::2])), d / f"ref{i}.npz")
        for i in range(2)]
    ref = {}
    try:
        port = run_ranks(tp_rank, WORLD, d, CASES, arrays, str(d),
                         timeout=150)
    finally:
        for proc, path in refs:
            ref.update(finish_reference(proc, path, timeout=180))
    return ref, port


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_tp_step_matches_pjit_step(runs, name):
    ref, port = runs
    for out in port:
        np.testing.assert_allclose(out[f"{name}/loss"], ref[f"{name}/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"{name}/grad_norm"],
                                   ref[f"{name}/grad_norm"], rtol=2e-5)
        np.testing.assert_allclose(out[f"{name}/aux"], ref[f"{name}/aux"],
                                   rtol=1e-5)
        assert out[f"{name}/model_wire_bytes"] > 0
    names = [k for k in ref if k.startswith(f"{name}/params/")]
    assert names
    for k in names:
        np.testing.assert_allclose(port[0][k], ref[k], rtol=0, atol=5e-4,
                                   err_msg=k)


def _moments_close(ref, port, name, leaf):
    keys = [k for k in ref if k.startswith(f"{name}/m/")
            and k.endswith(f"/{leaf}")]
    assert keys
    for out in port:
        for k in keys:
            exp = ref[k]
            np.testing.assert_allclose(out[k], exp, rtol=0,
                                       atol=1e-5 * np.abs(exp).max(),
                                       err_msg=k)


@pytest.mark.parametrize("name", ["olmoe_2x2", "olmoe_1x4"])
def test_router_gradient_and_data_shard_aux(runs, name):
    """The router's gradient is the pjit step's, and the aux the JAX
    package's mean of the data shards' own: on (2, 2) apart from the
    global batch's, on (1, 4) (one data shard) equal to it."""
    ref, port = runs
    _moments_close(ref, port, name, "router")
    glob = float(ref[f"{name}/global_aux"])
    aux = port[0][f"{name}/aux"]
    if name == "olmoe_2x2":
        assert abs(aux - glob) > 1e-4 * glob, (aux, glob)
    else:
        np.testing.assert_allclose(aux, glob, rtol=1e-5)


@pytest.mark.parametrize("name", ["yi_sp_even", "yi_sp_odd"])
def test_sequence_parallel_norm_gradients(runs, name):
    """Under sequence parallelism the norms' scales read the rank's rows;
    their gradients, summed over the model axis, are the pjit step's."""
    ref, port = runs
    _moments_close(ref, port, name, "scale")
    # S even splits the rows and crosses the model axis more
    even, odd = (port[0][f"{n}/model_wire_bytes"]
                 for n in ("yi_sp_even", "yi_sp_odd"))
    assert even > port[0]["yi_2x2/model_wire_bytes"] and odd < even


def test_loop_restored_across_meshes(runs):
    _, port = runs
    for out in port:
        whole, resumed = out["loop_whole"], out["loop_resumed"]
        assert [h[0] for h in whole] == [h[0] for h in resumed] == \
            list(range(6))
        np.testing.assert_allclose([h[1] for h in resumed],
                                   [h[1] for h in whole], rtol=2e-5)
        np.testing.assert_allclose([h[2] for h in resumed],
                                   [h[2] for h in whole], rtol=1e-4)


def test_families_without_a_model_axis_body_refuse(runs):
    _, port = runs
    for out in port:
        for arch, msgs in out["refused"].items():
            assert all("A13.5.3e" in m for m in msgs), (arch, msgs)


def test_kv_heads_read_and_k5_refuses_a_cut_group():
    """The KV heads a rank's query heads read where only the query heads
    split, as ``i // (H / Hkv)`` of the global head; K5 refuses a query
    head count that is not a multiple of the KV heads."""
    import dataclasses
    cfg = tconfigs.get_smoke("yi-9b")
    for h, kv, tp in ((4, 2, 4), (32, 2, 4), (12, 3, 2), (6, 3, 2)):
        c = dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv)
        for r in range(tp):
            rt = Runtime(model_group=object(), model_ranks=tuple(range(tp)),
                         model_index=r)
            heads = tattn.kv_heads_read(c, rt)
            h_loc = h // tp
            assert h_loc % len(heads) == 0
            per = h_loc // len(heads)
            assert [heads[i // per] for i in range(h_loc)] == \
                [(r * h_loc + i) // (h // kv) for i in range(h_loc)]
    q, k = torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k, k)
