"""Spawned gloo ranks, and the JAX package's side in one subprocess, for
the port's multi-rank tests (``tests/test_torch_collectives.py``,
``tests/test_torch_dp.py``, ``tests/test_torch_dp_families.py``).

:func:`run_ranks` starts ``world`` processes (the ``spawn`` method), each
joining a gloo group through a ``file://`` rendezvous under the test's
temporary directory (so parallel test workers never share a port), with
a group timeout: a rank that hangs in a collective fails it.  The parent
waits for every rank's result under its own deadline and ends every
process it started.  The rank bodies live here, importing the port only,
so that a spawned rank does not import JAX.

:func:`run_reference` runs a program of the JAX package in one
subprocess with ``N`` forced host devices and returns the arrays it
saved.
"""

from __future__ import annotations

import datetime
import os
import queue
import subprocess
import sys
import traceback
import uuid

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
# A collective that waits longer fails the rank instead of hanging it.
GROUP_TIMEOUT_S = 60


def _rank_main(body, rank, world, init, args, q):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = body(rank, world, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, True, out))
    except Exception:  # reported to the parent, which fails the test
        q.put((rank, False, traceback.format_exc()))


def run_ranks(body, world: int, tmp_dir, *args, timeout: float = 90.0):
    """``[body(rank, world, *args) for each rank]``, each in its own
    process of one gloo world."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = os.path.join(str(tmp_dir), f"pg-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(body, r, world, init, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, val = q.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise AssertionError(
                    f"ranks {sorted(set(range(world)) - set(results))} gave "
                    f"no result within {timeout} s") from None
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{val}")
            results[rank] = val
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    return [results[r] for r in range(world)]


def start_reference(prog: str, devices: int, out_path, *argv):
    """Start ``prog`` (which saves an npz to ``sys.argv[1]`` and prints
    ``REF_OK``) in one subprocess with ``devices`` forced host devices;
    :func:`finish_reference` waits for it."""
    env = {"XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp")}
    return subprocess.Popen([sys.executable, "-c", prog, str(out_path),
                             *map(str, argv)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def finish_reference(proc, out_path, timeout: float) -> dict:
    """The arrays the program of :func:`start_reference` saved; kills it
    past ``timeout`` seconds."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "REF_OK" in stdout, (stdout[-1000:], stderr[-3000:])
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def run_reference(prog: str, devices: int, out_path, *argv,
                  timeout: float = 120.0) -> dict:
    """:func:`start_reference`, then :func:`finish_reference`."""
    return finish_reference(start_reference(prog, devices, out_path, *argv),
                            out_path, timeout)


# -----------------------------------------------------------------------------
# Rank bodies.
# -----------------------------------------------------------------------------
def collectives_rank(rank, world, ref, order):
    """The ring collectives on this rank's rows of the reference's
    inputs: ``{name: result}``."""
    import torch

    from repro_torch.dist.collectives import (layer_strides,
                                              multiring_all_reduce,
                                              ring_all_gather,
                                              ring_reduce_scatter)
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("data",))
    pos = int(mesh.axis_index(("data",), rank))
    out = {}

    def t(name, row=pos):
        return torch.from_numpy(ref[name][row].copy())

    for r in (1, 2, 3, 5):
        st = layer_strides(world, r)
        out[f"f32_{r}"] = multiring_all_reduce(t("xf"), "data", st,
                                               mesh=mesh).numpy()
        out[f"i32_{r}"] = multiring_all_reduce(t("xi"), "data", st,
                                               mesh=mesh).numpy()
        out[f"bf16_{r}"] = multiring_all_reduce(
            t("xb").to(torch.bfloat16), "data", st,
            mesh=mesh).float().numpy()
    rs = ring_reduce_scatter(t("y"), "data", 5, mesh=mesh)
    out["rs5"] = rs.numpy()
    out["ag5"] = ring_all_gather(rs, "data", 5, chunk_offset=5,
                                 mesh=mesh).numpy()
    # an axis tuple, row-major: (pod, data) of a (2, 4) mesh
    mesh2 = make_mesh((2, world // 2), ("pod", "data"))
    pos2 = mesh2.axis_index(("pod", "data"), rank)
    out["tuple_3"] = multiring_all_reduce(
        t("xf", pos2), ("pod", "data"), layer_strides(world, 3),
        mesh=mesh2).numpy()
    # a permuted mesh: rank order[j] sits at position j
    mesh3 = make_mesh((world,), ("data",), device_order=order)
    pos3 = mesh3.axis_index(("data",), rank)
    out["perm_2"] = multiring_all_reduce(
        t("xf", pos3), "data", layer_strides(world, 2), mesh=mesh3).numpy()
    out["pos_perm"] = pos3
    # n == 1: the shortcut returns the payload untouched
    mesh4 = make_mesh((world, 1), ("data", "model"))
    x = t("xf")
    out["n1"] = (multiring_all_reduce(x, "model", (1,), mesh=mesh4) is x
                 and ring_reduce_scatter(x, "model", 1,
                                         mesh=mesh4).data_ptr()
                 == x.data_ptr())
    # a stride sharing a factor with n is refused before any send
    raised = []
    for fn in (lambda: ring_reduce_scatter(x, "data", 2, mesh=mesh),
               lambda: ring_all_gather(x, "data", 4, mesh=mesh),
               lambda: multiring_all_reduce(x, "data", (1, 6), mesh=mesh)):
        try:
            fn()
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["raised"] = raised
    return out


def nested(flat: dict, prefix: str) -> dict:
    """The nested dict of the arrays named ``prefix/a/b/...``."""
    out: dict = {}
    for name, a in flat.items():
        if not name.startswith(prefix + "/"):
            continue
        keys = name[len(prefix) + 1:].split("/")
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = a
    return out


def _flat(tree, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v.detach().cpu().numpy().copy()
    return out


DP_CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4, d_head=16, d_ff=128, vocab=256, dtype="float32",
              remat="none")
DP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50)


def dp_rank(rank, world, init, tok, ckpt_dir):
    """The data-parallel paths on this rank: the mesh step at (4,) and
    at (2, 2) with the model axis folded in, manual DP at each wire, the
    elastic restore, and a loop resumed on another mesh."""
    import torch

    from repro_torch import interop
    from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import P, Runtime, tree_map_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import loop as tloop
    from repro_torch.train.manual_dp import (ManualDPConfig,
                                             make_manual_dp_step)
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             tree_map)
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = ModelConfig(**DP_CFG)
    oc = AdamWConfig(**DP_OPT)
    out = {}

    def params0():
        return interop.model_params_from_arrays(cfg, init, "cpu")

    tokens = torch.from_numpy(tok.astype("int64"))
    batch = {"tokens": tokens, "labels": tokens}
    for name, shape, axes, kw in (("d4", (4,), ("data",), {}),
                                  ("d2m2", (2, 2), ("data", "model"),
                                   dict(tp_disabled=True))):
        rt = Runtime(mesh=make_mesh(shape, axes), data_axes=("data",), **kw)
        pspecs = tmodel.param_specs(cfg, rt)
        p = tree_map_specs(lambda x, s: rt.local(x, s).clone(), params0(),
                           pspecs)
        o = adamw_init(p)
        step = make_train_step(cfg, rt, TrainConfig(opt=oc))
        rows = {k: rt.local(v, P(rt.fsdp, None)) for k, v in batch.items()}
        for i in range(2):
            p, o, m = step(p, o, rows, i)
            out[f"pjit_{name}/loss{i}"] = float(m["loss"])
            out[f"pjit_{name}/gnorm{i}"] = float(m["grad_norm"])
        full = tree_map_specs(rt.gather, p, pspecs)
        if rank == 0:
            _flat(full, f"pjit_{name}/params", out)

    # grad_accum 2 on (4,): the global batch's microbatches, f32 and
    # int8-quantised
    rt = Runtime(mesh=make_mesh((4,), ("data",)), data_axes=("data",))
    pspecs = tmodel.param_specs(cfg, rt)
    rows = {k: rt.local(v, P(rt.fsdp, None)) for k, v in batch.items()}
    for compress in ("none", "int8_ef"):
        name = f"ga2_{compress}"
        p = tree_map_specs(lambda x, s: rt.local(x, s).clone(), params0(),
                           pspecs)
        o = adamw_init(p)
        step = make_train_step(cfg, rt, TrainConfig(
            opt=AdamWConfig(**DP_OPT, compress=compress), grad_accum=2))
        for i in range(2):
            p, o, m = step(p, o, rows, i)
            out[f"pjit_{name}/loss{i}"] = float(m["loss"])
            out[f"pjit_{name}/gnorm{i}"] = float(m["grad_norm"])
        full = tree_map_specs(rt.gather, p, pspecs)
        if rank == 0:
            _flat(full, f"pjit_{name}/params", out)
    step = make_train_step(cfg, rt, TrainConfig(opt=oc, grad_accum=4))
    try:
        step(p, o, rows, 0)
        out["ga4_raises"] = None
    except ValueError as e:
        out["ga4_raises"] = str(e)

    rt = Runtime(mesh=make_mesh((world,), ("data",)), data_axes=("data",),
                 tp_disabled=True)
    for wire in ("float32", "bfloat16", "int8_ef"):
        man = make_manual_dp_step(cfg, rt, ManualDPConfig(
            opt=oc, wire=wire, n_rings=3))
        p = params0()
        o = adamw_init(p)
        e = tree_map(lambda x: torch.zeros(x.shape), p)
        for i in range(10 if wire == "int8_ef" else 1):
            p, o, e, m = man(p, o, e, batch)
            out[f"man_{wire}/loss{i}"] = float(m["loss"])
            out[f"man_{wire}/gnorm{i}"] = float(m["grad_norm"])
            if i == 0:
                _flat(p, f"man_{wire}/params1", out)
                _flat(e, f"man_{wire}/ef1", out)
        _flat(p, f"man_{wire}/params", out)
        out[f"man_{wire}/sent_bytes"] = man.wire.sent_bytes

    # elastic: (4, 1) P("data", None) saved, restored onto (2, 2)
    # P("model", "data")
    rt_a = Runtime(mesh=make_mesh((4, 1), ("data", "model")))
    rt_b = Runtime(mesh=make_mesh((2, 2), ("data", "model")))
    x = torch.arange(16 * 12, dtype=torch.float32).reshape(16, 12)
    spec_a, spec_b = {"w": P("data", None)}, {"w": P("model", "data")}
    save_checkpoint(f"{ckpt_dir}/elastic", 5,
                    {"w": rt_a.local(x, spec_a["w"]).clone()},
                    {"next_step": 5}, rt=rt_a, specs=spec_a)
    like = {"w": torch.zeros(rt_b.local(x, spec_b["w"]).shape)}
    restored, extra = restore_checkpoint(f"{ckpt_dir}/elastic", like,
                                         rt=rt_b, specs=spec_b)
    out["elastic"] = restored["w"].numpy()
    out["elastic_extra"] = extra

    # a loop on (4,) against one that fails at step 2 and resumes on
    # (2, 2) with the model axis folded in: the same shards, so the same
    # bits
    def loop(rt, total, d, fail=None):
        return tloop.TrainLoop(
            cfg, rt, DataConfig(global_batch=8, seq_len=32, seed=1),
            TrainConfig(opt=oc),
            tloop.LoopConfig(total_steps=total, ckpt_every=2, log_every=1,
                             ckpt_dir=d, inject_failure_at=fail),
            device="cpu")

    rt4 = Runtime(mesh=make_mesh((4,), ("data",)))
    rt22 = Runtime(mesh=make_mesh((2, 2), ("data", "model")),
                   tp_disabled=True)
    whole = loop(rt4, 4, f"{ckpt_dir}/whole").run()
    failing = loop(rt4, 4, f"{ckpt_dir}/resume", fail=2)
    try:
        failing.run()
        raise AssertionError("no injected failure")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    failing.mgr.wait()
    resumed = loop(rt22, 4, f"{ckpt_dir}/resume").run()
    out["loop_whole"] = [(h["step"], h["loss"], h["grad_norm"])
                         for h in whole["history"]]
    out["loop_resumed"] = [(h["step"], h["loss"], h["grad_norm"])
                           for h in resumed["history"]]
    full = [tree_map_specs(r.gather, s["state"]["params"],
                           tmodel.param_specs(cfg, r))
            for r, s in ((rt4, whole), (rt22, resumed))]
    a, b = _flat(full[0], "p", {}), _flat(full[1], "p", {})
    out["loop_params_equal"] = a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)
    # the default group's world as a 1-D mesh
    from repro_torch.dist.sharding import host_device_runtime
    hdr = host_device_runtime()
    out["host_device_runtime"] = (hdr.mesh.shape, hdr.fsdp_size)
    try:
        host_device_runtime(world + 1)
        out["hdr_raises"] = False
    except RuntimeError as e:
        out["hdr_raises"] = f"--nproc-per-node {world + 1}" in str(e)
    # a model axis above 1 is tensor parallelism, which Mamba2 and RWKV6
    # have no body for yet (A13.5.3e)
    from repro_torch import configs
    out["tp_raises"] = True
    for arch in ("zamba2-1.2b", "rwkv6-7b"):
        try:
            make_train_step(configs.get_smoke(arch), Runtime(
                mesh=make_mesh((2, 2), ("data", "model"))))
            out["tp_raises"] = False
        except NotImplementedError as e:
            out["tp_raises"] &= "A13.5.3e" in str(e)
    return out


def multiring_card_rank(rank, world, xs):
    """``multiring_all_reduce`` of this rank's rows on the card and on the
    CPU (gloo: the card's payloads cross through host buffers)."""
    import torch

    from repro_torch.dist.collectives import (WireLog, layer_strides,
                                              multiring_all_reduce)
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("data",))
    out = {}
    for name, x in xs.items():
        t = torch.from_numpy(x[rank].copy())
        if name == "bf16":
            t = t.to(torch.bfloat16)
        log = WireLog()
        card = multiring_all_reduce(t.cuda(), "data", layer_strides(world, 3),
                                    mesh=mesh, log=log)
        assert card.is_cuda and log.staging_seconds > 0
        host = multiring_all_reduce(t, "data", layer_strides(world, 3),
                                    mesh=mesh)
        out[name] = (card.cpu().float().numpy(), host.float().numpy())
    return out


def model_region_card_rank(rank, world, xs):
    """The model region's functions over a (1, ``world``) mesh on the
    card and on the CPU (gloo: the card's payloads cross through host
    buffers): forward and backward of enter, leave, gather and split on
    this rank's rows of ``xs``."""
    import torch

    from repro_torch.dist.collectives import (WireLog, model_enter,
                                              model_gather, model_leave,
                                              model_split)
    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch.mesh import make_mesh

    log = WireLog()
    rt = Runtime(mesh=make_mesh((1, world), ("data", "model"))).step_body(
        log)
    x0 = torch.from_numpy(xs["x"][rank].copy())
    g0 = torch.from_numpy(xs["g"][rank].copy())
    out = {}
    for name, fn in (("enter", lambda x: model_enter(x, rt)),
                     ("leave", lambda x: model_leave(x, rt)),
                     ("gather", lambda x: model_gather(x, rt, 1)),
                     ("split", lambda x: model_split(x, rt, 1))):
        res = []
        for dev in ("cuda", "cpu"):
            x = x0.to(dev).requires_grad_()
            y = fn(x)
            g = g0.to(dev)
            if name == "gather":
                g = torch.cat([g, 2 * g], dim=1)
            elif name == "split":
                g = g.narrow(1, 0, g.shape[1] // world)
            (dx,) = torch.autograd.grad(y, x, g)
            assert y.device.type == dx.device.type == dev
            res.append((y.detach().cpu().numpy(), dx.cpu().numpy()))
        out[name] = res
    out["staged"] = log.staging_seconds > 0
    return out


FAMILY_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50)


def dp_families_rank(rank, world, cases, tok):
    """One mesh step of each case ``(name, arch, remat, params)`` (the
    smoke config of ``arch`` at ``remat``, from the nested numpy
    ``params``) on a mesh of ``world`` ranks with an f32 wire: its
    metrics, the first moment of the router's gradient (gathered) and,
    on rank 0, the parameters after the step; beside them the aux this
    rank's rows alone give (a body without ``batch_group``)."""
    import dataclasses

    import torch

    from repro_torch import configs, interop
    from repro_torch.dist.sharding import P, Runtime, tree_map_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, make_train_step

    tokens = torch.from_numpy(tok.astype("int64"))
    batch = {"tokens": tokens, "labels": tokens}
    rt = Runtime(mesh=make_mesh((world,), ("data",)), data_axes=("data",),
                 collective_dtype="float32")
    rows = {k: rt.local(v, P(rt.fsdp, None)) for k, v in batch.items()}
    out = {}
    for name, arch, remat, params in cases:
        cfg = dataclasses.replace(configs.get_smoke(arch), remat=remat)
        full = interop.model_params_from_arrays(cfg, params, "cpu")
        pspecs = tmodel.param_specs(cfg, rt)
        p = tree_map_specs(lambda x, s: rt.local(x, s).clone(), full,
                           pspecs)
        step = make_train_step(cfg, rt, TrainConfig(
            opt=AdamWConfig(**FAMILY_OPT)))
        p, o, m = step(p, adamw_init(p), rows, 0)
        for k in ("loss", "aux", "grad_norm"):
            out[f"{name}/{k}"] = float(m[k])
        with torch.no_grad():
            out[f"{name}/local_aux"] = float(
                tmodel.loss_fn(full, cfg, Runtime(), rows)[1]["aux"])
        moments = tree_map_specs(rt.gather, o["m"], pspecs)
        for i, block in moments["blocks"].items():
            if "moe" in block:
                out[f"{name}/m/blocks/{i}/moe/router"] = \
                    block["moe"]["router"].numpy()
        p = tree_map_specs(rt.gather, p, pspecs)
        if rank == 0:
            _flat(p, f"{name}/params", out)
    return out


TP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50)
# The leaves whose first moment a tensor-parallel case reports: the
# router, and the norms' scales (sequence parallelism sums them over the
# model axis).
TP_MOMENTS = ("router", "scale")


def _rows(batch, rt):
    """The rank's rows of a global batch: dim 0, or dim 1 of M-RoPE's
    (3, B, S) positions."""
    from repro_torch.dist.sharding import P

    return {k: rt.local(v, P(None, rt.fsdp, None)) if k == "positions"
            else rt.local(v, P(rt.fsdp, *(None,) * (v.dim() - 1)))
            for k, v in batch.items()}


def tp_rank(rank, world, cases, arrays, ckpt_dir):
    """One mesh step of each case ``(name, arch, shape, sp, seq, ga)`` on
    a ``(data, model)`` mesh of ``shape`` with an f32 wire (at
    ``grad_accum=ga`` under ``int8_ef`` where ``ga > 1``): its metrics,
    the first moments of ``TP_MOMENTS`` (gathered) and, on rank 0, the
    parameters after the step; then a loop checkpointed on (2, 2),
    restored on (4,) and back; then the families that have no model-axis
    body yet, each refusing a model axis above 1."""
    import dataclasses

    import torch

    from repro_torch import configs, interop
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import Runtime, tree_map_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.train import loop as tloop
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, tree_map
    from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                              make_train_step)

    out = {}
    tc = TrainConfig(opt=AdamWConfig(**TP_OPT))
    for name, arch, shape, sp, seq, ga in cases:
        cfg = configs.get_smoke(arch)
        rt = Runtime(mesh=make_mesh(shape, ("data", "model")),
                     data_axes=("data",), collective_dtype="float32",
                     sequence_parallel=sp)
        full = interop.model_params_from_arrays(
            cfg, nested(arrays, f"{arch}/params"), "cpu")
        batch = {k: torch.from_numpy(v[..., :seq] if k != "embeds"
                                     else v[:, :seq])
                 for k, v in nested(arrays, f"{arch}/batch").items()}
        pspecs = tmodel.param_specs(cfg, rt)
        p = tree_map_specs(lambda x, s: rt.local(x, s).clone(), full,
                           pspecs)
        step = make_train_step(cfg, rt, dataclasses.replace(
            tc, grad_accum=ga, opt=dataclasses.replace(
                tc.opt, compress="int8_ef" if ga > 1 else "none")))
        p, o, m = step(p, adamw_init(p), _rows(batch, rt), 0)
        for k in ("loss", "aux", "grad_norm"):
            out[f"{name}/{k}"] = float(m[k])
        out[f"{name}/model_wire_bytes"] = step.model_wire.reduced_bytes
        moments = tree_map_specs(rt.gather, o["m"], pspecs)
        tree_map(lambda path, x: out.__setitem__(
            f"{name}/m/" + "/".join(path), x.numpy())
            if path[-1] in TP_MOMENTS else None, moments, with_path=True)
        p = tree_map_specs(rt.gather, p, pspecs)
        if rank == 0:
            _flat(p, f"{name}/params", out)

    # a loop on (2, 2) that fails at step 2, resumed on (4,), failing at
    # step 4, resumed on (2, 2) again, against one uninterrupted on (2, 2).
    # The pipeline draws each data shard's rows apart, so that (2, 2) and
    # (4,) would see other batches: every loop takes its rows of one
    # global batch a step instead.
    cfg = dataclasses.replace(configs.get_smoke("yi-9b"), remat="full")
    rt22 = Runtime(mesh=make_mesh((2, 2), ("data", "model")))
    rt4 = Runtime(mesh=make_mesh((4,), ("data",)))

    def global_batch(step):
        tok = torch.from_numpy(np.random.default_rng(step).integers(
            0, cfg.vocab, (4, 32)))
        return {"tokens": tok, "labels": tok}

    def loop(rt, d, fail=None):
        run = tloop.TrainLoop(
            cfg, rt, DataConfig(global_batch=4, seq_len=32, seed=1), tc,
            tloop.LoopConfig(total_steps=6, ckpt_every=2, log_every=1,
                             ckpt_dir=d, inject_failure_at=fail),
            device="cpu")
        run.data.batch = lambda step: _rows(global_batch(step), rt)
        return run

    whole = loop(rt22, f"{ckpt_dir}/whole").run()
    resumed = []
    for rt, fail in ((rt22, 2), (rt4, 4), (rt22, None)):
        run = loop(rt, f"{ckpt_dir}/resume", fail)
        try:
            resumed += run.run()["history"]
        except RuntimeError as e:
            if f"injected failure at step {fail}" not in str(e):
                raise
            resumed += run.history
            run.mgr.wait()
    out["loop_whole"] = [(h["step"], h["loss"], h["grad_norm"])
                         for h in whole["history"]]
    out["loop_resumed"] = [(h["step"], h["loss"], h["grad_norm"])
                           for h in resumed]

    # no model-axis body yet: refused before a weight is drawn
    out["refused"] = {}
    for arch in ("deepseek-v2-236b", "zamba2-1.2b", "rwkv6-7b"):
        msgs = []
        for fn in (lambda: make_train_step(configs.get_smoke(arch), rt22),
                   lambda: make_train_state(configs.get_smoke(arch), rt22,
                                            None, device="cpu")):
            try:
                fn()
                msgs.append("")
            except NotImplementedError as e:
                msgs.append(str(e))
        out["refused"][arch] = msgs
    return out
