"""The port's multi-head latent attention (``repro_torch.models.mla``) and
K5's plain versions at a V head dimension other than Q's, against the JAX
package's, on the CPU.

deepseek-v2-236b's smoke config (4 heads, q and k 16 + 8 = 24 wide, v
16, a 16 + 8 latent) in f32, on the JAX package's own ``mla_init``
parameters carried across as numpy arrays, numpy inputs from a seed.  The
JAX side's prefill runs ``chunked_attention`` (its flash semantics) and
its decode the absorbed einsums of ``_mla_decode``, jitted on the CPU; no
Pallas kernel is on that path.  The port's prefill runs K5's plain
version, :func:`repro_torch.kernels.ref.attention_ref`.

Tolerance in f32: |port - ref| <= 1e-5 |ref| + 1e-5 max|ref| for outputs
and caches (the two sum in other orders); K5's plain forward and backward
rtol 1e-5, atol 1e-6 against ``flash_chunked`` and its ``jax.vjp``, as
``tests/test_torch_flash_bwd.py`` holds them at Dv = D.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import Runtime as JRuntime
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.dist.sharding import Runtime as TRuntime
from repro_torch.kernels import ref
from repro_torch.models import common as tcommon
from repro_torch.models import mla as tmla

ARCH = "deepseek-v2-236b"
JRT, TRT = JRuntime(mesh=None), TRuntime()
RTOL = 1e-5


def close(port, ref_, what, rtol=RTOL):
    port = port.detach().float().numpy()
    ref_ = np.asarray(ref_, np.float32)
    assert port.shape == ref_.shape, what
    np.testing.assert_allclose(port, ref_, rtol=rtol,
                               atol=rtol * float(np.abs(ref_).max()),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def setup():
    cfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jmla.mla_init(jax.random.PRNGKey(2), cfg)
    tp = interop._tree(lambda a: torch.from_numpy(np.array(a)), jp)
    japply = jax.jit(lambda p, x, pos, c: jmla.mla_apply(p, cfg, JRT, x, pos,
                                                         cache=c))
    return cfg, tcfg, jp, tp, japply


def tapply(tcfg, tp, x, pos, cache):
    rope = tcommon.rope_tables(torch.from_numpy(pos.copy()),
                               tcfg.mla.rope_dim, tcfg.rope_theta)
    return tmla.mla_apply(tp, tcfg, TRT, torch.from_numpy(x), rope,
                          cache=cache)


def inputs(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return x, pos


def test_mla_prefill_matches_reference():
    """A 20-token prefill without a cache, and one filling a 32-slot f32
    cache: the output, and the latent and rope key written."""
    cfg, tcfg, jp, tp, japply = setup()
    x, pos = inputs(cfg, 2, 20, 1)
    exp, _ = japply(jp, x, pos, None)
    got, c = tapply(tcfg, tp, x, pos, None)
    assert c is None
    close(got, exp, "prefill")
    jc = jmla.init_mla_cache(JRT, cfg, 2, 32, jnp.float32)
    tc = tmla.init_mla_cache(TRT, tcfg, 2, 32, torch.float32, device="cpu")
    exp, jc = japply(jp, x, pos, jc)
    got, tc = tapply(tcfg, tp, x, pos, tc)
    close(got, exp, "prefill into a cache")
    close(tc["latent"], jc["latent"], "latent cache")
    assert int(tc["pos"]) == int(jc["pos"]) == 20
    assert not tc["latent"][:, 20:].any()


@pytest.mark.parametrize("length", [16, 12])
def test_absorbed_decode_matches_reference(length):
    """A 9-token prefill, then 4 decode steps one token at a time through
    the absorbed form, the output and the latent cache held after each;
    with 12 slots the last step finds the cache full (the JAX package
    then writes nothing and attends all 12 slots)."""
    cfg, tcfg, jp, tp, japply = setup()
    x, pos = inputs(cfg, 2, 13 if length == 16 else 14, 2)
    s0 = 9 if length == 16 else 10
    jc = jmla.init_mla_cache(JRT, cfg, 2, length, jnp.float32)
    tc = tmla.init_mla_cache(TRT, tcfg, 2, length, torch.float32,
                             device="cpu")
    for step, sl in [("prefill", slice(0, s0))] + [
            (f"decode {i}", slice(i, i + 1)) for i in range(s0, x.shape[1])]:
        exp, jc = japply(jp, x[:, sl], pos[:, sl], jc)
        got, tc = tapply(tcfg, tp, x[:, sl], pos[:, sl], tc)
        close(got, exp, step)
        close(tc["latent"], jc["latent"], f"{step} latent cache")
        assert int(tc["pos"]) == int(jc["pos"])


def test_absorbed_decode_equals_the_expanded_prefill():
    """The port's own check: the absorbed decode's output for token 10
    equals the expanded K5 prefill's last row over the same 11 tokens."""
    cfg, tcfg, _, tp, _ = setup()
    x, pos = inputs(cfg, 2, 11, 3)
    full, _ = tapply(tcfg, tp, x, pos, None)
    tc = tmla.init_mla_cache(TRT, tcfg, 2, 16, torch.float32, device="cpu")
    tapply(tcfg, tp, x[:, :10], pos[:, :10], tc)
    step, _ = tapply(tcfg, tp, x[:, 10:], pos[:, 10:], tc)
    close(step[:, 0], full[:, -1].numpy(), "decode vs prefill")


@functools.lru_cache(maxsize=None)
def jvjp(causal, scale):
    def run(q, k, v, do):
        out, pull = jax.vjp(lambda *a: jattn.flash_chunked(
            *a, causal, 0, 0.0, scale, 32, 0), q, k, v)
        return (out,) + pull(do)
    return jax.jit(run)


@pytest.mark.parametrize("causal,group", [(True, 1), (False, 2)])
def test_plain_k5_and_backward_at_dv_other_than_d(causal, group):
    """K5's plain forward (with its LSE) and backward at MLA's layout, q
    and k 24 wide and v 16, against ``flash_chunked`` and its VJP; the
    LSE against ``_flash_fwd_scan``'s."""
    rng = np.random.default_rng(4)
    b, h, s, d, dv = 1, 4, 72, 24, 16
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h // group, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h // group, s, dv)).astype(np.float32)
    do = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    scale = d ** -0.5
    out_j, *grads_j = jvjp(causal, scale)(q, k, v, do)
    _, lse_j = jattn._flash_fwd_scan(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, 0, 0.0, scale,
                                     32, 0)
    lse_j = np.asarray(lse_j)[..., 0]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ref.attention_ref(tq, tk, tv, causal=causal, scale=scale,
                                 return_lse=True)
    grads = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                        causal=causal, scale=scale)
    for name, got, exp in [("out", out, out_j), ("lse", lse, lse_j)] + list(
            zip(("dq", "dk", "dv"), grads, grads_j)):
        exp = np.asarray(exp)
        assert tuple(got.shape) == exp.shape, name
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
