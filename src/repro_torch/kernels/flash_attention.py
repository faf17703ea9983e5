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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import LAUNCHES, build, ref

__all__ = ["flash_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, f, i, i, f, p]
        fn.restype = i
    return lib


def _launch(q, k, v, causal, window, softcap, scale) -> torch.Tensor:
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_launch(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), b, h, hkv, sq, sk,
                            d, float(scale), int(bool(causal)), int(window),
                            float(softcap), stream)
    build.check(lib, code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


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
    Returns (B, H, Sq, D) in q's dtype (accumulated in f32).
    """
    if bq < 1 or bk < 1:
        raise ValueError(f"tiles must be positive, got bq={bq}, bk={bk}")
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return _launch(q, k, v, causal, window, softcap, scale)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
