"""Batched semiring matrix product (paper Appendix B.1).

Three semirings, as in the JAX package's engine:

* ``"count"``   — (min(·+·, SAT), ×) over f32: saturating walk counting,
                  exact below 2**24;
* ``"bool"``    — (OR, AND): reachability; bool in, bool out;
* ``"minplus"`` — (min, +) over f32 with +inf as the additive identity.

Operands are 2-D or carry one leading batch dimension (a 2-D operand is
broadcast against a 3-D one).  A CUDA tensor runs the hand-written
kernel in ``csrc/semiring.cu``; a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build, ref

__all__ = ["semiring_matmul", "SEMIRINGS", "SAT"]

SAT = ref.SAT
SEMIRINGS = ("count", "bool", "minplus")
_MODE = {"count": 0, "minplus": 2}


def _lib():
    lib = build.load("semiring")
    fn = lib.semiring_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, p, i, i, i, i, ll, ll, ctypes.c_float, p]
        fn.restype = i
        fb = lib.semiring_bool_launch
        fb.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fb.restype = i
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor, semiring: str,
            sat: float) -> torch.Tensor:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    dtype = torch.bool if semiring == "bool" else torch.float32
    if semiring == "bool" and (a.dtype != torch.bool or b.dtype != torch.bool):
        raise TypeError("the bool semiring takes bool operands")
    batch = max(a.shape[0] if a.ndim == 3 else 1,
                b.shape[0] if b.ndim == 3 else 1)
    for x in (a, b):
        if x.ndim == 3 and x.shape[0] != batch:
            raise ValueError(f"batch sizes differ: {tuple(a.shape)} x "
                             f"{tuple(b.shape)}")
    a = a.to(dtype).contiguous()
    b = b.to(dtype).contiguous()
    m, k = a.shape[-2:]
    n = b.shape[-1]
    shape = ((batch,) if a.ndim == 3 or b.ndim == 3 else ()) + (m, n)
    out = torch.empty(shape, dtype=dtype, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.fill_(float("inf") if semiring == "minplus" else 0)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if semiring == "bool":
        # Bit-packed operands: scratch freed on return is safe, since the
        # caching allocator hands it only to work queued later on the
        # same stream.
        kw = (k + 31) // 32
        batch_a = a.shape[0] if a.ndim == 3 else 1
        batch_b = b.shape[0] if b.ndim == 3 else 1
        ap = torch.empty((batch_a, m, kw), dtype=torch.int32, device=a.device)
        bp = torch.empty((batch_b, kw, n), dtype=torch.int32, device=a.device)
        code = lib.semiring_bool_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), ap.data_ptr(),
            bp.data_ptr(), batch, batch_a, batch_b, m, k, n, stream)
    else:
        code = lib.semiring_launch(
            _MODE[semiring], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            batch, m, k, n, m * k if a.ndim == 3 else 0,
            k * n if b.ndim == 3 else 0, float(sat), stream)
    build.check(lib, code, f"semiring_matmul[{semiring}]")
    LAUNCHES["semiring"] += 1
    return out


def semiring_matmul(a: torch.Tensor, b: torch.Tensor, semiring: str = "count",
                    *, sat: float = SAT) -> torch.Tensor:
    """Semiring product ``A ⊗ B``; operands may carry one leading batch dim.

    ``bool`` takes and returns bool tensors; ``count`` and ``minplus``
    work in f32.  CUDA operands launch the CUDA kernel (or raise); CPU
    operands take the plain version."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; "
                         f"choose from {SEMIRINGS}")
    if a.is_cuda or b.is_cuda:
        return _launch(a, b, semiring, sat)
    return ref.semiring_matmul_ref(a, b, semiring, sat=sat)
