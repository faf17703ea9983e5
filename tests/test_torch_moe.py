"""The port's mixture-of-experts block (``repro_torch.models.moe``)
against the JAX package's, on the CPU.

The smoke configs of olmoe-1b-7b (8 experts, top-2) and deepseek-v2-236b
(8 experts, top-2 and a shared expert) in f32, on the JAX package's own
``moe_init`` parameters carried across as numpy arrays, and numpy inputs
from a seed.  The JAX side runs its mesh-free ``moe_apply`` (expert-sorted
rows through ``jax.lax.ragged_dot``), jitted on the CPU; no Pallas kernel
is on that path.

Tolerance in f32: |port - ref| <= 1e-5 |ref| + 1e-5 max|ref| for the
output and every gradient; the aux loss rtol 1e-5.  The chosen experts
must be equal.  Where they are not, the failure names the smallest gap
between a token's k-th and (k+1)-th router probability: a near-tie that
the two packages' f32 sums resolve differently is reported as such, never
hidden by another seed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import Runtime as JRuntime
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.dist.sharding import Runtime as TRuntime
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

JRT, TRT = JRuntime(mesh=None), TRuntime()
MOE = ["olmoe-1b-7b", "deepseek-v2-236b"]
RTOL = 1e-5


def close(port, ref, what, rtol=RTOL):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, what
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def both(arch):
    """The smoke config, the JAX package's ``moe_init`` parameters and the
    port's copy of them."""
    cfg = jconfigs.get_smoke(arch)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), cfg)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def port_params(arrays):
    return interop._tree(lambda a: torch.from_numpy(a.copy()), arrays)


def inputs(cfg, seed, b=2, s=24):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def smallest_gap(x, router, k):
    """The smallest gap between a token's k-th and (k+1)-th router
    probability (f32, the JAX package's routing)."""
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, x.shape[-1])) @ jnp.asarray(router), -1))
    top = -np.sort(-probs, axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


def same_choices(cfg, x, arrays):
    """The chosen experts of both packages are equal, or the failure
    reports the closest tie."""
    _, ji, _ = jmoe._route(jnp.asarray(x.reshape(-1, cfg.d_model)),
                           jnp.asarray(arrays["router"]), cfg.moe,
                           jnp.float32)
    _, ti, _ = tmoe.route(torch.from_numpy(x.reshape(-1, cfg.d_model)),
                          torch.from_numpy(arrays["router"].copy()),
                          tconfigs.get_smoke(cfg.name.replace("-smoke", "")))
    gap = smallest_gap(x, arrays["router"], cfg.moe.top_k)
    assert np.array_equal(ti.numpy(), np.asarray(ji)), (
        f"the chosen experts differ; the smallest k-th to (k+1)-th "
        f"probability gap is {gap:.3e}")
    return gap


@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch):
    cfg, jp, arrays = both(arch)
    tcfg = tconfigs.get_smoke(arch)
    x = inputs(cfg, 3)
    same_choices(cfg, x, arrays)
    jy, jaux = jax.jit(lambda p, a: jmoe.moe_apply(p, cfg, JRT, a))(
        jp, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(port_params(arrays), tcfg, TRT,
                              torch.from_numpy(x))
    close(ty, jy, "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    assert ("shared" in arrays) == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("arch", MOE)
def test_moe_gradients_match_reference(arch):
    """The gradients of ``sum(y * w) + 3 aux`` with respect to every
    parameter and the input, against ``jax.grad`` of the same scalar."""
    cfg, jp, arrays = both(arch)
    tcfg = tconfigs.get_smoke(arch)
    x = inputs(cfg, 4, s=16)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    same_choices(cfg, x, arrays)

    def jscalar(p, a):
        y, aux = jmoe.moe_apply(p, cfg, JRT, a)
        return jnp.sum(y * jnp.asarray(w)) + 3.0 * aux
    jg_p, jg_x = jax.jit(jax.grad(jscalar, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = port_params(arrays)
    leaves = topt.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply(tp, tcfg, TRT, tx)
    scalar = torch.sum(y * torch.from_numpy(w)) + 3.0 * aux
    grads = torch.autograd.grad(scalar, leaves + [tx])
    jflat = jax.tree.leaves(jg_p)
    assert len(jflat) == len(leaves)
    for i, (got, exp) in enumerate(zip(grads, jflat + [jg_x])):
        close(got, exp, f"gradient {i}")
    # The aux's gradient reaches the router (through p_e only).
    g_aux = torch.autograd.grad(tmoe.moe_apply(tp, tcfg, TRT, tx)[1],
                                tp["router"])[0]
    assert float(g_aux.abs().max()) > 0


def test_smallest_gap_is_what_decides_the_choices():
    """The helper that reports a near-tie: two experts given the same
    router column tie exactly (gap 0) for every token whose k-th and
    (k+1)-th choices they are."""
    cfg, _, arrays = both("olmoe-1b-7b")
    x = inputs(cfg, 6, b=1, s=8)
    router = arrays["router"].copy()
    assert smallest_gap(x, router, cfg.moe.top_k) > 0
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x[0]) @ router, -1))
    kth = np.argsort(-probs[0])[cfg.moe.top_k - 1]
    nxt = np.argsort(-probs[0])[cfg.moe.top_k]
    router[:, nxt] = router[:, kth]
    assert smallest_gap(x, router, cfg.moe.top_k) == 0.0


def test_experts_without_rows_are_skipped():
    """A router that sends every token to the same top-k experts: the
    other experts get no rows, and the output is still the reference's
    (the dense sum over the chosen experts, written out here)."""
    tcfg = tconfigs.get_smoke("olmoe-1b-7b")
    _, _, arrays = both("olmoe-1b-7b")
    p = port_params(arrays)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][0, :tcfg.moe.top_k] = 1.0     # experts 0..k-1, x[..., 0] > 0
    x = torch.from_numpy(inputs(tcfg, 7, b=1, s=6))
    x[..., 0] = torch.linspace(1.0, 3.0, 6)
    y, _ = tmoe.moe_apply(p, tcfg, TRT, x)
    topw, topi, _ = tmoe.route(x.reshape(-1, tcfg.d_model), p["router"],
                               tcfg)
    assert set(topi.flatten().tolist()) == set(range(tcfg.moe.top_k))
    exp = torch.zeros_like(x.reshape(-1, tcfg.d_model))
    for j in range(tcfg.moe.top_k):
        e = topi[:, j]
        xr = x.reshape(-1, tcfg.d_model)[:, None]
        h = torch.nn.functional.silu(xr @ p["w1"][e]) * (xr @ p["w3"][e])
        exp += topw[:, j, None] * (h @ p["w2"][e])[:, 0]
    close(y.reshape(-1, tcfg.d_model), exp.numpy(), "all rows to k experts")


def test_aux_enters_the_loss_under_full_remat():
    """``loss_fn``'s total is ce + AUX_COEF aux; under ``remat="full"``
    the loss and every gradient equal ``"none"``'s bitwise, the router's
    gradient included (the aux leaves the checkpointed unit)."""
    cfg = tconfigs.get_smoke("olmoe-1b-7b")
    params = tmodel.init_params(cfg, TRT, torch.Generator().manual_seed(0),
                                "cpu")
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 16)))
    batch = {"tokens": tok, "labels": tok}
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = tts.loss_and_grads(params, c, TRT, batch)
    (l0, m0, g0), (l1, m1, g1) = out["none"], out["full"]
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert float(m0["aux"]) > 0
    torch.testing.assert_close(l0, m0["ce"] + tmodel.AUX_COEF * m0["aux"],
                               rtol=0, atol=0)
    for a, b in zip(topt.tree_leaves(g0), topt.tree_leaves(g1)):
        assert torch.equal(a, b)
    assert float(g1["blocks"]["0"]["moe"]["router"].abs().max()) > 0
