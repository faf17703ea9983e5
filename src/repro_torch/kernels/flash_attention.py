"""Flash attention (online softmax) for the LM substrate.

Supports what the repo's architectures need:

* GQA (``n_kv_heads <= n_heads``; query head h reads KV head
  ``h // (H / Hkv)``);
* causal masking, or none;
* a causal sliding window (gemma2's local layers);
* gemma2 logit soft-capping ``softcap * tanh(s / softcap)``, after the
  scale and before the mask;
* any scale (``D ** -0.5`` by default);
* a V head dimension ``Dv <= D`` (deepseek-v2's multi-head latent
  attention: q and k 192 wide, v and the output 128).

Query and key positions both start at 0, also when ``Sq != Sk``; keys at
or beyond ``Sk`` are masked, and a row whose keys are all masked gives 0.
A CUDA tensor runs a hand-written kernel in ``csrc/flash_attention.cu``:
bf16 ``mma.sync`` bf16 products with f32 accumulators (P kept in
registers as a bf16 high part and remainder); f32 ``mma.sync`` products
in split TF32 (``csrc/mma_tf32.cuh``: each f32 operand a TF32 high part
and remainder, three TF32 products for each f32 product, small terms
first, accurate to rtol 1e-4 at the tensor cores' rate, where one TF32
product is not); a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.attention_ref`.

Gradients: when grad mode is on and an input requires grad,
:func:`flash_attention` runs through an autograd Function whose forward
also writes each row's log-sum-exp and saves (q, k, v, out, lse), as the
JAX package's ``flash_chunked`` custom VJP does, and whose backward is
:func:`flash_attention_bwd`: on a CUDA tensor the hand-written kernel in
``csrc/flash_attention_bwd.cu``, on a CPU tensor its plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.  Without grad
the path is the forward alone, as before.  The backward's kernels are
chosen by :func:`_bwd_route`, a rule on (dtype, D, Dv, alignment):
``wgmma-tma`` (bf16 at D <= 192: Hopper's warpgroup products fed by TMA
loads), ``wgmma-ldst`` (the same kernels fed by plain loads, for rows TMA
cannot describe), ``cuda-cores`` (bf16 at D > 192) or ``tf32x3`` (f32 at
every D: ``mma.sync`` products in split TF32, as the forward's).
:data:`ROUTE_LAUNCHES` counts the backward's launches by route.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from . import LAUNCHES, build, ref

__all__ = ["flash_attention", "flash_attention_bwd"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# The backward's routes, in the order of their codes in flash_bwd_launch.
BWD_ROUTES = ("cuda-cores", "wgmma-tma", "wgmma-ldst", "tf32x3")
WGMMA_MAX_HEAD_DIM = 192
# The backward's launches by route.
ROUTE_LAUNCHES = collections.Counter()


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, p, p]
        fn.restype = i
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_bwd_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i] + [p] * 10 + [i] * 7 + [f, i, i, f, i, p]
        fn.restype = i
    return lib


def _check(q, k, v):
    """Validate (B, H, Sq, D) q, (B, Hkv, Sk, D) k and (B, Hkv, Sk, Dv) v,
    Dv <= D, for the kernels; returns (b, h, hkv, sq, sk, d, dv)."""
    b, h, sq, d = q.shape
    if k.ndim != 4 or v.ndim != 4 or k.shape[0] != b or k.shape[3] != d \
            or v.shape[:3] != k.shape[:3] or not 1 <= v.shape[3] <= d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, H, Sq, D), "
                         "(B, Hkv, Sk, D) and (B, Hkv, Sk, Dv), Dv <= D")
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
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
    return b, h, hkv, sq, sk, d, dv


def _launch(q, k, v, causal, window, softcap, scale, with_lse=False):
    """The forward kernel on contiguous copies of q, k, v: out, and with
    ``with_lse`` also the f32 (B, H, Sq) log-sum-exp."""
    b, h, hkv, sq, sk, d, dv = _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty((b, h, sq, dv))
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
                            d, dv, float(scale), int(bool(causal)),
                            int(window), float(softcap),
                            None if lse is None else lse.data_ptr(), stream)
    build.check(lib, code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def _bwd_route(dtype: torch.dtype, d: int, dv: int, aligned: bool) -> str:
    """The backward's kernels for ``dtype`` at head dimension ``d`` and V
    width ``dv``; ``aligned`` says whether q, k, v and dO start on 16
    bytes.  bf16 at D <= 192 runs the wgmma kernels, fed by TMA where its
    rows are a multiple of 16 bytes (D and Dv multiples of 8) and the
    bases aligned, else by plain loads; bf16 at D > 192 the CUDA cores;
    f32 at any D and alignment the split-TF32 kernels.  Raises on a dtype
    or widths the kernels do not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"no backward kernel for {dtype}")
    if not 1 <= dv <= d <= MAX_HEAD_DIM:
        raise ValueError(f"D {d} and Dv {dv}: expected 1 <= Dv <= D <= "
                         f"{MAX_HEAD_DIM}")
    if dtype == torch.float32:
        return "tf32x3"
    if d > WGMMA_MAX_HEAD_DIM:
        return "cuda-cores"
    if aligned and d % 8 == 0 and dv % 8 == 0:
        return "wgmma-tma"
    return "wgmma-ldst"


def _launch_bwd(q, k, v, out, lse, dout, causal, window, softcap, scale):
    b, h, hkv, sq, sk, d, d_v = _check(q, k, v)
    if out.shape != (b, h, sq, d_v) or dout.shape != out.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must be "
                         f"{(b, h, sq, d_v)} in q's {q.dtype}")
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
    route = _bwd_route(q.dtype, d, d_v, all(t.data_ptr() % 16 == 0
                                            for t in (q, k, v, dout)))
    # The kernels' scratch: delta (b, h, sq) on the CUDA cores and tf32x3;
    # lse log2 e and delta in rows padded to 128 on the wgmma routes.
    rows = b * h * (2 * -(-sq // 128) * 128 if route.startswith("wgmma")
                    else sq)
    scratch = torch.empty(rows, dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_bwd_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dout.data_ptr(), scratch.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, sk, d,
        d_v, float(scale), int(bool(causal)), int(window), float(softcap),
        BWD_ROUTES.index(route), stream)
    build.check(lib, code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    ROUTE_LAUNCHES[route] += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` from its output ``out`` and
    its f32 (B, H, Sq) log-sum-exp ``lse``, given the output's gradient
    ``dout`` (the output's shape, q's dtype).  A CUDA tensor launches the kernel of
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
      q: (B, H, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv), Dv <= D,
        with H % Hkv == 0; f32 or bf16 on the card, D <= 256.  The
        kernels pad the head dimension to D's in shared memory, V's
        columns past Dv with zeros; no padded copy is made in memory.
      window: if > 0, sliding window of this many positions.
      softcap: if > 0, gemma2-style logit soft-capping.
      bq, bk: the TPU kernel's query and key tile sizes, kept so that its
        callers run unchanged.  They set nothing here: the CUDA kernels
        fix their tiles (64 query rows a block; 32 keys a tile, 16 for
        f32 at D > 128), and the plain version has no tiles.  They must
        be positive.
    Returns (B, H, Sq, Dv) in q's dtype (accumulated in f32).  Under grad
    mode, with an input that requires grad, the result is differentiable
    through :func:`flash_attention_bwd`.
    """
    if bq < 1 or bk < 1:
        raise ValueError(f"tiles must be positive, got bq={bq}, bk={bk}")
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] % k.shape[1]:
        # A GQA group cut in two (a head split over a model axis) lands
        # here on either device.
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         "expected (B, H, S, D) and (B, Hkv, S, D) with H "
                         "a multiple of Hkv")
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
