"""The port's layout contract (``repro_torch.dist.sharding``), spec trees
(parameters, optimizer state and caches of every config), device order
and data shards against the JAX package's, in one process.

The JAX package's ``Runtime`` takes a ``jax.sharding.AbstractMesh``, the
port's a :class:`~repro_torch.dist.sharding.Mesh` of ranks that no
process group backs: spec builders need shapes and names only.  Specs
compare by ``tuple``.  A data shard's rows are the port's
``SyntheticDataset`` under a mesh, with the rank it asks
``torch.distributed`` for set by the test.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.core import topology as jtopo
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.dist.sharding import Runtime as JRuntime
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.core import topology as ttopo
from repro_torch.data.pipeline import DataConfig, SyntheticDataset
from repro_torch.dist.sharding import P, Runtime, host_device_runtime
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.train import optimizer as topt

DENSE = ("yi-9b", "glm4-9b", "qwen2.5-32b", "gemma2-27b", "qwen2-vl-7b",
         "hubert-xlarge")
OTHER = ("olmoe-1b-7b", "deepseek-v2-236b", "zamba2-1.2b", "rwkv6-7b")
# hubert-xlarge is an encoder: no cache
CACHED = tuple(a for a in DENSE + OTHER if a != "hubert-xlarge")

# (mesh shape, axis names, Runtime keywords)
LAYOUTS = {
    "data8": ((8,), ("data",), dict(data_axes=("data",))),
    "data2_model4": ((2, 4), ("data", "model"), dict(data_axes=("data",))),
    "data2_model4_fsdp": ((2, 4), ("data", "model"),
                          dict(data_axes=("data",), tp_disabled=True)),
    "pod_data_model": ((2, 2, 2), ("pod", "data", "model"),
                       dict(data_axes=("pod", "data"))),
}


def runtimes(layout):
    shape, names, kw = LAYOUTS[layout]
    return (JRuntime(mesh=AbstractMesh(shape, names), **kw),
            Runtime(mesh=tmesh.make_mesh(shape, names), **kw))


def as_tuples(tree):
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_runtime_sizes_and_specs(layout):
    jrt, trt = runtimes(layout)
    for attr in ("fsdp_axes", "fsdp_size", "tp_size", "fsdp", "tp"):
        assert getattr(trt, attr) == getattr(jrt, attr), attr
    entries = [("fsdp", None), ("fsdp", "tp"), ("tp", "fsdp", None),
               (None, "model"), ("data", "pod"), ("nope", "fsdp")]
    shapes = [(16, 8), (16, 6), (6, 16, 3), (3, 8), (4, 4), (5, 5)]
    for e in entries:
        assert tuple(trt.spec(*e)) == tuple(jrt.spec(*e)), e
        for shape in shapes:
            if len(shape) == len(e):
                assert tuple(trt.spec_div(e, shape)) == \
                    tuple(jrt.spec_div(e, shape)), (e, shape)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", DENSE + OTHER)
def test_param_and_opt_specs_match_reference(arch, layout, smoke):
    get = "get_smoke" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    jrt, trt = runtimes(layout)
    jspec = jmodel.param_specs(jcfg, jrt)
    tspec = tmodel.param_specs(tcfg, trt)
    assert as_tuples(tspec) == as_tuples(jspec)
    for ef in (False, True):
        assert as_tuples(topt.opt_specs(tspec, ef)) == \
            as_tuples(jopt.opt_specs(jspec, ef))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", CACHED)
def test_cache_specs_match_reference(arch, layout, smoke):
    """At batch 8 and length 128 (below gemma2's and zamba2's windows in
    their full configs, above them in their smoke ones).  The port has
    no sequence-sharded decode yet (ROADMAP A13.5.3d): it is held to the
    JAX package's ``seq_sharded_decode=False`` everywhere, and to its
    default (True) where the model axis is folded or absent, which
    shards no sequence."""
    get = "get_smoke" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    jrt, trt = runtimes(layout)
    got = as_tuples(tmodel.cache_specs(tcfg, trt, 8, 128))
    unsharded = dataclasses.replace(jrt, seq_sharded_decode=False)
    assert got == as_tuples(jmodel.cache_specs(jcfg, unsharded, 8, 128))
    if trt.tp_size == 1:
        assert got == as_tuples(jmodel.cache_specs(jcfg, jrt, 8, 128))


def _ranks(tree):
    if isinstance(tree, dict):
        return {k: _ranks(v) for k, v in tree.items()}
    return len(tree)


@pytest.mark.parametrize("arch", DENSE + OTHER)
def test_spec_trees_cover_the_port_trees(arch):
    """The smoke config's ``param_specs`` (and ``cache_specs``) have the
    keys of ``init_params``' (and ``init_cache``'s) tree, a spec entry
    for each of a leaf's dims."""
    cfg = tconfigs.get_smoke(arch)
    _, trt = runtimes("data8")
    gen = torch.Generator().manual_seed(0)
    params = tmodel.init_params(cfg, Runtime(), gen, "cpu")
    assert _ranks(tmodel.param_specs(cfg, trt)) == \
        topt.tree_map(lambda p: p.dim(), params)
    if arch in CACHED:
        cache = tmodel.init_cache(cfg, Runtime(), 8, 128, device="cpu")
        assert _ranks(tmodel.cache_specs(cfg, trt, 8, 128)) == \
            topt.tree_map(lambda c: c.dim(), cache)


@pytest.mark.parametrize("n", [8, 64, 100])
@pytest.mark.parametrize("q", [5, 7])
def test_fatpaths_device_order_bitwise(q, n):
    got = tmesh.fatpaths_device_order(n, ttopo.slim_fly(q))
    exp = jmesh.fatpaths_device_order(n, jtopo.slim_fly(q))
    np.testing.assert_array_equal(got, exp)
    assert sorted(got.tolist()) == list(range(n))
    np.testing.assert_array_equal(tmesh.fatpaths_device_order(n),
                                  np.arange(n))


def test_make_mesh_places_ranks_by_device_order():
    order = tmesh.fatpaths_device_order(8, ttopo.slim_fly(5))
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), device_order=order)
    assert mesh.shape == {"data": 2, "model": 4}
    np.testing.assert_array_equal(mesh.ranks.ravel(), order)
    r = int(order[6])                       # position (1, 2)
    assert mesh.coords(r) == {"data": 1, "model": 2}
    assert mesh.axis_index(("model", "data"), r) == 2 * 2 + 1
    assert mesh.axis_ranks(("data",), r) == (int(order[2]), r)


@pytest.mark.parametrize("frontend", [False, True], ids=["tokens", "embeds"])
@pytest.mark.parametrize("layout", ["data8", "data2_model4_fsdp",
                                    "pod_data_model"])
def test_data_shards_bitwise(monkeypatch, layout, frontend):
    jrt, trt = runtimes(layout)
    arch = "hubert-xlarge" if frontend else "yi-9b"
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    d = dict(global_batch=16, seq_len=24, seed=3)
    jds = JDataset(jcfg, JDataConfig(**d), jrt)
    rows = 16 // jrt.fsdp_size
    for rank in range(trt.mesh.size):
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
        ds = SyntheticDataset(tcfg, DataConfig(**d), trt, "cpu")
        shard = trt.mesh.axis_index(trt.fsdp_axes, rank)
        for step in (0, 5):
            b = ds.batch(step)
            np.testing.assert_array_equal(
                b["labels"].numpy(), jds._shard_tokens(step, shard, rows))
            if frontend:
                np.testing.assert_array_equal(
                    b["embeds"].numpy(), jds._shard_embeds(step, shard, rows))
            else:
                assert b["tokens"] is b["labels"]
    with pytest.raises(ValueError, match="divide"):
        SyntheticDataset(tcfg, DataConfig(global_batch=6, seq_len=8), trt,
                         "cpu")


def test_local_slices_tile_the_global_tensor(monkeypatch):
    _, trt = runtimes("pod_data_model")
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = P(("pod", "data"), None, "model")
    parts = {}
    for r in range(8):
        c = trt.mesh.coords(r)
        parts[(c["pod"] * 2 + c["data"], c["model"])] = trt.local(x, spec, r)
    back = torch.cat([torch.cat([parts[(i, j)] for j in range(2)], dim=2)
                      for i in range(4)], dim=0)
    assert torch.equal(back, x)
    # without an explicit rank, the rank torch.distributed gives
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 5)
    assert torch.equal(trt.local(x, spec), trt.local(x, spec, 5))


def test_host_device_runtime_without_a_world():
    assert host_device_runtime() == Runtime(data_axes=("data",))
    assert host_device_runtime(1, axis="batch").mesh is None
    with pytest.raises(RuntimeError, match="torchrun --standalone "
                       "--nproc-per-node 4"):
        host_device_runtime(4)


@pytest.mark.parametrize("devices", [None, 1, 2, 3, 4, 5])
def test_host_device_runtime_takes_the_whole_world_or_one(monkeypatch,
                                                          devices):
    """In a world of 4: the whole world or the single device; a part of
    it raises before any process group is made (its ranks could not all
    reach the mesh's groups), as do more ranks than the world holds."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    if devices in (2, 3):
        with pytest.raises(ValueError, match="whole world"):
            host_device_runtime(devices)
    elif devices == 5:
        with pytest.raises(RuntimeError, match="--nproc-per-node 5"):
            host_device_runtime(devices)
    elif devices == 1:
        assert host_device_runtime(devices).mesh is None
    else:
        rt = host_device_runtime(devices)
        assert rt.mesh.shape == {"data": 4} and rt.fsdp_size == 4
        assert rt.mesh.ranks.tolist() == [0, 1, 2, 3]


def test_runtime_without_mesh_unchanged():
    rt = Runtime()
    assert rt.mesh is None and rt.collective_dtype == "bfloat16"
    assert rt.tp_size == 1 and rt.fsdp_size == 1 and not rt.tp
    assert rt.fsdp is None
    assert rt.spec("fsdp", None) == P(None, None)
    assert rt.spec_div(("fsdp", "tp", None), (4, 6, 8)) == P(None, None, None)
    x = torch.ones(4, 6)
    assert rt.local(x, P("data", None)) is x
    assert rt.gather(x, P("data", None)) is x
    fn = lambda v: v  # noqa: E731
    assert rt.shard_map(fn, in_specs=P(), out_specs=P()) is fn
    assert rt.astype(torch.ones(2)).dtype == torch.bfloat16
    assert Runtime(collective_dtype="float32").astype(
        torch.ones(2, dtype=torch.bfloat16)).dtype == torch.float32
    with pytest.raises(ValueError):
        Runtime(collective_dtype="int8")
    with pytest.raises(ValueError, match="data_axes"):
        Runtime(mesh=tmesh.make_mesh((2,), ("x",)))
    spec = P("data", ("pod", "model"), None)
    assert tuple(spec) == ("data", ("pod", "model"), None)
    import pickle
    assert pickle.loads(pickle.dumps(spec)) == spec
