"""Every model family of the port on a data-parallel mesh: one mesh step
(``repro_torch.train.train_step``) of the smoke olmoe-1b-7b,
deepseek-v2-236b, zamba2-1.2b and rwkv6-7b on 4 gloo ranks, and of
olmoe-1b-7b under ``remat="full"`` (the experts' collective rerun inside
the backward), against the JAX package's pjit step on 4 forced host
devices.

The JAX package's side runs once, in one subprocess, over meshes of its
own ``repro.launch.mesh.make_mesh`` (``jax.make_mesh``'s explicit axes
make its pjit step raise, ROADMAP §C), beside the port's spawned ranks
(``tests/_torch_ranks.py``).  Both sides start from the port's seed-0
parameters and take the same numpy tokens (8 rows of 32, two a rank),
with an f32 gradient wire (``collective_dtype="float32"``) so that the
gradients are compared unrounded.

Tolerances: loss and ``aux`` rtol 1e-5, grad norm rtol 2e-5, parameters
within 5e-4 (``tests/test_torch_dp.py``'s); the router's gradient,
read as AdamW's first moment ``(1 - b1) g`` after the step (no clipping
at these norms), within 1e-5 of its largest.  Under the pjit step the
experts' load-balance loss is the global batch's; a rank's own rows
give another one (the ranks' mean differs by about 1e-3 relative here),
and its gradient through ``AUX_COEF`` moves the loss by less than the
loss's rtol, so the ``aux`` check is the one that tells the designs
apart.  The file takes about 50 s in one process, most of it the
reference's compiles.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import (dp_families_rank, finish_reference, run_ranks,
                          start_reference)
from repro_torch import configs as tconfigs
from repro_torch.dist.sharding import Runtime
from repro_torch.models import model as tmodel
from repro_torch.train.optimizer import tree_map

WORLD = 4
# (name, arch, remat)
CASES = [("olmoe", "olmoe-1b-7b", "none"),
         ("deepseek", "deepseek-v2-236b", "none"),
         ("zamba2", "zamba2-1.2b", "none"),
         ("rwkv6", "rwkv6-7b", "none"),
         ("olmoe_full", "olmoe-1b-7b", "full")]
MOE = ("olmoe", "deepseek", "olmoe_full")

_PROG = """import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.dist.sharding import Runtime
from repro.launch.mesh import make_mesh
from repro.train.optimizer import AdamWConfig, adamw_init
from repro.train.train_step import TrainConfig, make_train_step

cases = [c.split(":") for c in sys.argv[3].split(",")]
with np.load(sys.argv[2]) as z:
    arrays = {k: z[k] for k in z.files}
out = {}


def nested(prefix, cfg):
    tree = {}
    for name, a in arrays.items():
        if name.startswith(prefix + "/"):
            d = tree
            keys = name[len(prefix) + 1:].split("/")
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = jnp.asarray(a)
    for i in range(len(cfg.layer_pattern)):   # an "a" position is {}
        tree["blocks"].setdefault(str(i), {})
    return tree


def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[f"{prefix}/{name}"] = np.asarray(leaf)


tok = jnp.asarray(arrays["tokens"], jnp.int32)
batch = {"tokens": tok, "labels": tok}
oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
mesh = make_mesh((4,), ("data",))
rt = Runtime(mesh=mesh, data_axes=("data",), collective_dtype="float32")
for name, arch, remat in cases:
    cfg = dataclasses.replace(configs.get_smoke(arch), remat=remat)
    p0 = nested(name, cfg)
    with mesh:
        step = jax.jit(make_train_step(cfg, rt, TrainConfig(opt=oc)))
        p, o, m = step(p0, adamw_init(p0), batch, jax.random.PRNGKey(1))
    for k in ("loss", "aux", "grad_norm"):
        out[f"{name}/{k}"] = np.asarray(m[k])
    flat(p, f"{name}/params")
    flat(o["m"], f"{name}/m")
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


def _draw(arch, remat):
    """The port's seed-0 smoke parameters, as a nested numpy dict."""
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), remat=remat)
    params = tmodel.init_params(cfg, Runtime(),
                                torch.Generator().manual_seed(0), "cpu")
    return tree_map(lambda x: x.numpy(), params)


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_families")
    tok = np.random.default_rng(0).integers(0, 512, (8, 32))
    params = {name: _draw(arch, remat) for name, arch, remat in CASES}
    arrays = {"tokens": tok}
    for name, p in params.items():
        _flat(p, name, arrays)
    np.savez(d / "init.npz", **arrays)
    ref_proc = start_reference(
        _PROG, WORLD, d / "ref.npz", d / "init.npz",
        ",".join(":".join(c) for c in CASES))
    try:
        port = run_ranks(dp_families_rank, WORLD, d,
                         [(name, arch, remat, params[name])
                          for name, arch, remat in CASES], tok, timeout=150)
    finally:
        ref = finish_reference(ref_proc, d / "ref.npz", timeout=180)
    return ref, port


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mesh_step_matches_pjit_step(runs, name):
    ref, port = runs
    for out in port:
        np.testing.assert_allclose(out[f"{name}/loss"], ref[f"{name}/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"{name}/grad_norm"],
                                   ref[f"{name}/grad_norm"], rtol=2e-5)
        np.testing.assert_allclose(out[f"{name}/aux"], ref[f"{name}/aux"],
                                   rtol=1e-5)
    names = [k for k in ref if k.startswith(f"{name}/params/")]
    assert names
    for k in names:
        np.testing.assert_allclose(port[0][k], ref[k], rtol=0, atol=5e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", MOE)
def test_router_gradient_and_global_aux(runs, name):
    """The router's gradient matches the pjit step's, and the global aux
    is not the ranks' mean of their own rows' aux."""
    ref, port = runs
    routers = [k for k in ref if k.startswith(f"{name}/m/")
               and k.endswith("/moe/router")]
    assert routers
    for out in port:
        for k in routers:
            exp = ref[k]
            np.testing.assert_allclose(out[k], exp, rtol=0,
                                       atol=1e-5 * np.abs(exp).max(),
                                       err_msg=k)
    local = np.mean([out[f"{name}/local_aux"] for out in port])
    assert abs(local - ref[f"{name}/aux"]) > 1e-4 * ref[f"{name}/aux"], \
        (local, ref[f"{name}/aux"])
