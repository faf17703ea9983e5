"""K5's backward pass on the CPU: the port's plain backward
(``kernels.ref.flash_attention_bwd_ref``) and the autograd Function of
``kernels.flash_attention`` against ``jax.vjp`` of the JAX package's
``flash_chunked`` (its custom VJP, above its chunk) and
``dense_attention`` (plain autodiff, below it), and the forward's
log-sum-exp against ``_flash_fwd_scan``'s.

Inputs come from a numpy seed.  Tolerance in f32: rtol 1e-5, atol 1e-6
(the two sum the same products in other orders; O(1) gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import LAUNCHES, flash_attention, ref
from repro_torch.kernels.flash_attention import flash_attention_bwd

RTOL, ATOL = 1e-5, 1e-6
CHUNK = 64
# (causal, window, softcap, group): the JAX package's flash VJP cases.
CASES = [(True, 0, 0.0, 1), (True, 0, 0.0, 4), (False, 0, 0.0, 2),
         (True, 48, 0.0, 1), (True, 0, 30.0, 2), (True, 20, 50.0, 4)]


def inputs(b, h, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, h, sq, d))]


@functools.lru_cache(maxsize=None)
def jax_vjp(path, causal, window, softcap, scale):
    """Jitted ``(q, k, v, dout) -> (out, dq, dk, dv)`` of the JAX
    package's attention on ``path`` (shared by the tests)."""
    if path == "flash_chunked":
        def f(q, k, v):
            return jattn.flash_chunked(q, k, v, causal, window, softcap,
                                       scale, CHUNK, 0)
    else:
        def f(q, k, v):
            return jattn.dense_attention(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)

    def run(q, k, v, do):
        out, pull = jax.vjp(f, q, k, v)
        return (out,) + pull(do)
    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def jax_lse(causal, window, softcap, scale):
    return jax.jit(lambda q, k, v: jattn._flash_fwd_scan(
        q, k, v, causal, window, softcap, scale, CHUNK, 0))


def close(port, exp, what):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(exp), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("path,s", [("flash_chunked", 160),
                                    ("dense_attention", 48)])
@pytest.mark.parametrize("causal,window,softcap,group", CASES)
def test_gradients_match_reference_vjp(path, s, causal, window, softcap,
                                       group):
    b, h, d = 2, 4, 32
    scale = d ** -0.5
    q, k, v, do = inputs(b, h, h // group, s, s, d, seed=s + group + window)
    out_j, *grads_j = jax_vjp(path, causal, window, softcap, scale)(
        q, k, v, do)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))

    # The plain backward from the port's own forward and log-sum-exp.
    out, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    close(out, out_j, "out")
    for name, got, exp in zip("qkv", flash_attention_bwd(
            tq, tk, tv, out, lse, tdo, **kw), grads_j):
        close(got, exp, f"plain d{name}")

    # The autograd Function on CPU tensors.
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = dict(LAUNCHES)
    out_f = flash_attention(*leaves, **kw)
    grads_f = torch.autograd.grad(out_f, leaves, tdo)
    assert LAUNCHES == before       # the CPU path launches no kernel
    close(out_f, out_j, "Function out")
    for name, got, exp in zip("qkv", grads_f, grads_j):
        close(got, exp, f"Function d{name}")


@pytest.mark.parametrize("causal,window,softcap,group", CASES)
def test_lse_matches_flash_fwd_scan(causal, window, softcap, group):
    b, h, s, d = 1, 4, 160, 32
    scale = d ** -0.5
    q, k, v, _ = inputs(b, h, h // group, s, s, d, seed=7 + group)
    out_j, lse_j = jax_lse(causal, window, softcap, scale)(q, k, v)
    out, lse = ref.attention_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    close(lse, np.asarray(lse_j)[..., 0], "lse")
    close(out, out_j, "out")


def test_fully_masked_rows():
    """Sq > Sk under a causal window: rows from Sk + window - 1 on see no
    key.  Their output and their gradients are 0, their log-sum-exp
    ``finfo(f32).min``, as the JAX package's flash VJP gives."""
    b, h, hkv, sq, sk, d, window = 1, 2, 1, 150, 60, 32, 16
    scale = d ** -0.5
    q, k, v, do = inputs(b, h, hkv, sq, sk, d, seed=3)
    out_j, *grads_j = jax_vjp("flash_chunked", True, window, 0.0, scale)(
        q, k, v, do)
    _, lse_j = jax_lse(True, window, 0.0, scale)(q, k, v)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, window=window, scale=scale)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    dead = sk + window - 1
    assert bool((out[:, :, dead:] == 0).all())
    assert bool((grads[0][:, :, dead:] == 0).all())
    close(out, out_j, "out")
    for name, got, exp in zip("qkv", grads, grads_j):
        close(got, exp, f"d{name}")
    _, lse = ref.attention_ref(*map(torch.from_numpy, (q, k, v)),
                               causal=True, window=window, scale=scale,
                               return_lse=True)
    assert bool((lse[:, :, dead:] == ref.NEG_INF).all())
    np.testing.assert_array_equal(lse[:, :, dead:].numpy(),
                                  np.asarray(lse_j)[:, :, dead:, 0])


def test_grad_mode_selects_the_function():
    """Without grad the entry point is the forward alone (no log-sum-exp,
    no graph); with grad and an input that requires it, the Function."""
    q, k, v, do = (torch.from_numpy(a) for a in inputs(1, 2, 1, 8, 8, 16, 0))
    assert flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
    out = flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    (dq,) = torch.autograd.grad(out, (qg,), do)
    exp = ref.flash_attention_bwd_ref(
        q, k, v, *ref.attention_ref(q, k, v, return_lse=True), do)[0]
    assert torch.equal(dq, exp)


def test_backward_validates_its_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in inputs(1, 2, 1, 8, 8, 16, 0))
    out, lse = ref.attention_ref(q, k, v, return_lse=True)
    from repro_torch.kernels.flash_attention import _launch_bwd
    with pytest.raises(ValueError, match="lse"):
        _launch_bwd(q, k, v, out, lse[..., :4], do, True, 0, 0.0, 0.25)
    with pytest.raises(ValueError, match="dout"):
        _launch_bwd(q, k, v, out, lse, do[..., :8], True, 0, 0.0, 0.25)
    with pytest.raises(TypeError):
        _launch_bwd(q.double(), k, v, out, lse, do, True, 0, 0.0, 0.25)


def test_v_head_dim_other_than_qk_on_the_cpu():
    """MLA's layout, dv != d: the plain forward and backward (the CPU
    path of the Function) against ``flash_chunked``'s VJP.  The CUDA
    kernels take dv == d only (ROADMAP A13.8)."""
    rng = np.random.default_rng(0)
    b, h, s, d, dv = 1, 2, 96, 24, 16
    q, k = (rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    do = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    scale = d ** -0.5
    out_j, *grads_j = jax_vjp("flash_chunked", True, 0, 0.0, scale)(
        q, k, v, do)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, scale=scale)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    close(out, out_j, "out")
    for name, got, exp in zip("qkv", grads, grads_j):
        assert got.shape == exp.shape
        close(got, exp, f"d{name}")
