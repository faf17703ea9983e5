"""Batched semiring matrix product (paper Appendix B.1).

Three semirings, as in the JAX package's engine:

* ``"count"``   — (min(·+·, SAT), ×) over f32: saturating walk counting,
                  exact below 2**24 (above it the card rounds the exact
                  sum once, the plain version at every step);
* ``"bool"``    — (OR, AND): reachability; bool in, bool out;
* ``"minplus"`` — (min, +) over f32 with +inf as the additive identity.

Operands are 2-D or carry one leading batch dimension (a 2-D operand is
broadcast against a 3-D one).  A CUDA tensor runs the hand-written
kernel in ``csrc/semiring.cu``; a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`.

The kernel replaces the JAX package's TPU kernel
``repro.kernels.semiring._pallas_matmul``; per semiring, what bounds it
on the H100 and what its design does about it:

* ``bool`` would be bound by bytes at the int8 tensor rate: one launch
  packs both operands to bits along K, a second sums ``popc(a AND b)``
  over the words K has on the tensor cores' single-bit form (``mma.sync``
  m16n8k256 ``.and.popc``), an output being true where its sum is not
  zero.  Two launches a call, the packed operands in scratch.
* ``count`` is bound by operations, and at the path's shapes (single
  722^2 products) by latency: its sums are exact (f32 operands widened to
  fp64 for the fp64 tensor cores, exact for integer-valued operands below
  2^53, one rounding at the end), so K can be split across blocks
  (:func:`count_split`) into fp64 partials that a second pass adds in
  order; two launches give the same bits, and the result is
  ``f32(float64 product)`` clamped at ``sat``.
* ``minplus`` is bound by operations on the CUDA cores (no tensor-core
  form): 8x4 register tiles through a ``cp.async`` ring.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build, ref

__all__ = ["semiring_matmul", "count_split", "SEMIRINGS", "SAT"]

SAT = ref.SAT
SEMIRINGS = ("count", "bool", "minplus")
_MODE = {"count": 0, "minplus": 2}
_SMS = 132          # the H100's streaming multiprocessors
_COUNT_TILE = 64    # output rows and columns of a count block
_COUNT_STEP = 32    # K entries a count block stages a step
_BLOCKS_PER_SM = 3  # count blocks resident on an SM (registers)


def count_split(batch: int, m: int, n: int, k: int):
    """``(split, chunk)``: how the count kernel splits K, a function of the
    shapes alone.

    The rule: with ``tiles = batch * ceil(m / 64) * ceil(n / 64)`` output
    blocks, take ``floor(3 * 132 / tiles)`` K shares, the most that still
    run in one wave of the three blocks that fit each of the card's 132
    SMs; give every share at least four 32-entry steps, and keep
    ``batch * split`` within the grid's 65535.  ``chunk`` is each share's
    K length, a multiple of 32; ``split = ceil(k / chunk)``, so every
    share is non-empty.  A single 722^2 product gets (2, 384): 288
    blocks."""
    tiles = batch * -(-m // _COUNT_TILE) * -(-n // _COUNT_TILE)
    steps = -(-k // _COUNT_STEP)
    want = _BLOCKS_PER_SM * _SMS // max(1, tiles)
    split = max(1, min(want, steps // 4, 65535 // max(1, batch)))
    chunk = -(-steps // split) * _COUNT_STEP
    return -(-k // chunk), chunk


def _lib():
    lib = build.load("semiring")
    fn = lib.semiring_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, p, p, i, i, i, i, ll, ll, i, i,
                       ctypes.c_float, p]
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
        split, chunk = (count_split(batch, m, n, k) if semiring == "count"
                        else (1, k))
        # fp64 partial sums of the K shares, written before they are read
        # (safe to free on return, as above).
        part = (torch.empty((split, batch, m, n), dtype=torch.float64,
                            device=a.device) if split > 1 else None)
        code = lib.semiring_launch(
            _MODE[semiring], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), batch, m, k, n,
            m * k if a.ndim == 3 else 0, k * n if b.ndim == 3 else 0, split,
            chunk, float(sat), stream)
    build.check(lib, code, f"semiring_matmul[{semiring}]")
    LAUNCHES["semiring"] += 1
    return out


def semiring_matmul(a: torch.Tensor, b: torch.Tensor, semiring: str = "count",
                    *, sat: float = SAT) -> torch.Tensor:
    """Semiring product ``A ⊗ B``; operands may carry one leading batch dim.

    ``bool`` takes and returns bool tensors; ``count`` and ``minplus``
    work in f32 (``count`` rounds its exact sum once: integer-valued
    operands give ``min(f32(float64 product), sat)`` on the card).  CUDA operands launch the CUDA kernel (or raise); CPU
    operands take the plain version."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; "
                         f"choose from {SEMIRINGS}")
    if a.is_cuda or b.is_cuda:
        return _launch(a, b, semiring, sat)
    return ref.semiring_matmul_ref(a, b, semiring, sat=sat)
