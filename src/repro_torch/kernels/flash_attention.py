"""Flash attention (online softmax) for the LM substrate.

Supports what the repo's architectures need:

* GQA (``n_kv_heads <= n_heads``; query head h reads KV head
  ``h // (H / Hkv)``);
* causal masking, or none;
* a causal sliding window (gemma2's local layers);
* gemma2 logit soft-capping ``softcap * tanh(s / softcap)``, after the
  scale and before the mask;
* any scale (``D ** -0.5`` by default).

Query and key positions both start at 0, also when ``Sq != Sk``; keys at
or beyond ``Sk`` are masked, and a row whose keys are all masked gives 0.
A CUDA tensor runs a hand-written kernel in ``csrc/flash_attention.cu``:
bf16 the tensor-core kernel (``mma.sync`` bf16 products with f32
accumulators, P kept in registers as a bf16 high part and remainder),
f32 the CUDA-core kernel (f32 throughout, exact enough for rtol 1e-4);
a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.attention_ref`.

Gradients: when grad mode is on and an input requires grad,
:func:`flash_attention` runs through an autograd Function whose forward
also writes each row's log-sum-exp and saves (q, k, v, out, lse), as the
JAX package's ``flash_chunked`` custom VJP does, and whose backward is
:func:`flash_attention_bwd`: on a CUDA tensor the hand-written kernel in
``csrc/flash_attention_bwd.cu``, on a CPU tensor its plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.  Without grad
the path is the forward alone, as before.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import LAUNCHES, build, ref

__all__ = ["flash_attention", "flash_attention_bwd"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, f, i, i, f, p, p]
        fn.restype = i
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_bwd_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i] + [p] * 10 + [i] * 6 + [f, i, i, f, p]
        fn.restype = i
    return lib


def _check(q, k, v):
    """Validate (B, H, Sq, D) q and (B, Hkv, Sk, D) k, v for the kernels;
    returns (b, h, hkv, sq, sk, d)."""
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.ndim != 4 or k.shape[0] != b or \
            k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, H, Sq, D) and "
                         "two (B, Hkv, Sk, D)")
    hkv, sk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV "
                         "heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dimension {d} is not in [1, {MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    return b, h, hkv, sq, sk, d


def _launch(q, k, v, causal, window, softcap, scale, with_lse=False):
    """The forward kernel on contiguous copies of q, k, v: out, and with
    ``with_lse`` also the f32 (B, H, Sq) log-sum-exp."""
    b, h, hkv, sq, sk, d = _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0 or sk == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(ref.NEG_INF)
        return (out, lse) if with_lse else out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_launch(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), b, h, hkv, sq, sk,
                            d, float(scale), int(bool(causal)), int(window),
                            float(softcap),
                            None if lse is None else lse.data_ptr(), stream)
    build.check(lib, code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, out, lse, dout, causal, window, softcap, scale):
    b, h, hkv, sq, sk, d = _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must be q's "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected f32 "
                         f"{(b, h, sq)}")
    if not all(t.device == q.device for t in (out, lse, dout)):
        raise ValueError("out, lse and dout must lie on q's device")
    q, k, v, out, lse, dout = (t.contiguous()
                               for t in (q, k, v, out, lse, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_bwd_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dout.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, sk, d,
        float(scale), int(bool(causal)), int(window), float(softcap), stream)
    build.check(lib, code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` from its output ``out`` and
    its f32 (B, H, Sq) log-sum-exp ``lse``, given the output's gradient
    ``dout`` (q's shape and dtype).  A CUDA tensor launches the kernel of
    ``csrc/flash_attention_bwd.cu`` (or raises); a CPU tensor takes
    :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.  Each
    gradient comes in its input's dtype."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if any(t.is_cuda for t in (q, k, v, out, lse, dout)):
        return _launch_bwd(q, k, v, out, lse, dout, causal, window, softcap,
                           scale)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       softcap=softcap, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward pass: the forward keeps q, k, v,
    the output and the log-sum-exp (nothing of size Sq x Sk)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        if q.is_cuda or k.is_cuda or v.is_cuda:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = _launch(q, k, v, causal, window, softcap, scale,
                               with_lse=True)
        else:
            out, lse = ref.attention_ref(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Flash attention over (B, H, S, D) tensors with GQA via head grouping.

    Args:
      q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with H % Hkv == 0; f32 or
        bf16 on the card, D <= 256.
      window: if > 0, sliding window of this many positions.
      softcap: if > 0, gemma2-style logit soft-capping.
      bq, bk: the TPU kernel's query and key tile sizes, kept so that its
        callers run unchanged.  They set nothing here: the CUDA kernels
        fix their tiles (64 query rows a block; 64 keys a tile, 32 for
        bf16 at D > 128), and the plain version has no tiles.  They must
        be positive.
    Returns (B, H, Sq, D) in q's dtype (accumulated in f32).  Under grad
    mode, with an input that requires grad, the result is differentiable
    through :func:`flash_attention_bwd`.
    """
    if bq < 1 or bk < 1:
        raise ValueError(f"tiles must be positive, got bq={bq}, bk={bk}")
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap,
                                     float(scale))
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return _launch(q, k, v, causal, window, softcap, scale)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
