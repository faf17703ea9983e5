"""Block-sparse semiring product: the semiring product with empty tiles
skipped.

Adjacency stacks on low-diameter topologies are sparse: a Slim Fly
router talks to about 3q/2 of its 2q^2 peers.  This variant takes the
operands of :func:`repro_torch.kernels.semiring.semiring_matmul`, builds
one occupancy bit per (bm, bk) tile of A and per (bk, bn) tile of B, and
skips every tile pair where either bit is 0.

Skipping is exact: an all-identity tile contributes exactly the additive
identity to the K reduction (0 to a count, +inf to a min), so the result
is bitwise the dense product's.  A CUDA tensor runs the hand-written
kernel in ``csrc/sparse.cu``, which builds the occupancy bitmaps itself
in one device pass over both operands; a CPU tensor runs the plain
version, which is the dense product (:func:`repro_torch.kernels.ref
.sparse_semiring_matmul_ref`).  :func:`tile_occupancy` is the bitmaps'
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build, ref
from .semiring import SAT, SEMIRINGS

__all__ = ["sparse_semiring_matmul", "tile_occupancy"]

_MODE = {"count": 0, "bool": 1, "minplus": 2}


def _live(x: torch.Tensor, semiring: str) -> torch.Tensor:
    return x < float("inf") if semiring == "minplus" else x != 0


def tile_occupancy(x: torch.Tensor, bm: int, bk: int,
                   semiring: str = "count") -> torch.Tensor:
    """Per-tile occupancy bitmap: ``occ[i, k] != 0`` iff block (i, k) of
    ``x`` holds any non-identity entry.  ``x`` must already be padded to
    tile multiples (the pad value is the additive identity, so pads never
    set a bit)."""
    m, k = x.shape
    if m % bm or k % bk:
        raise ValueError(f"{tuple(x.shape)} is not a multiple of the "
                         f"({bm}, {bk}) tile")
    return _occupancy(x, bm, bk, semiring)


def _occupancy(x: torch.Tensor, rows: int, cols: int,
               semiring: str) -> torch.Tensor:
    """:func:`tile_occupancy` of ``x`` (2-D or batched) as if padded with
    the identity to tile multiples: only its live mask is padded, never
    the operand."""
    live = _live(x, semiring)
    m, k = live.shape[-2:]
    pm, pk = -m % rows, -k % cols
    if pm or pk:
        live = torch.nn.functional.pad(live, (0, pk, 0, pm))
    tiles = live.reshape(live.shape[:-2] + ((m + pm) // rows, rows,
                                            (k + pk) // cols, cols))
    return tiles.any(dim=-1).any(dim=-2).to(torch.int32).contiguous()


def _lib():
    lib = build.load("sparse")
    fn = lib.sparse_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor, semiring: str, sat: float,
            bm: int, bn: int, bk: int) -> torch.Tensor:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if min(bm, bn, bk) < 1:
        raise ValueError(f"tiles must be positive, got ({bm}, {bn}, {bk})")
    if semiring == "bool":
        if a.dtype != torch.bool or b.dtype != torch.bool:
            raise TypeError("the bool semiring takes bool operands")
        dtype = torch.bool
    else:
        dtype = torch.float32
    batch_a = a.shape[0] if a.ndim == 3 else 1
    batch_b = b.shape[0] if b.ndim == 3 else 1
    batch = max(batch_a, batch_b)
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
    # Scratch the kernel writes before it reads: the occupancy bitmaps
    # and, for bool, the operands packed along K.  Freed on return, which
    # is safe: the caching allocator hands it only to work queued later
    # on the same stream.
    kt = -(-k // bk)
    dev = a.device
    a_occ = torch.empty((batch_a, -(-m // bm), kt), dtype=torch.int32,
                        device=dev)
    b_occ = torch.empty((batch_b, kt, -(-n // bn)), dtype=torch.int32,
                        device=dev)
    ap = bp = None
    if semiring == "bool":
        kw = -(-k // 32)
        ap = torch.empty((batch_a, m, kw), dtype=torch.int32, device=dev)
        bp = torch.empty((batch_b, kw, n), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.sparse_launch(
        _MODE[semiring], a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a_occ.data_ptr(), b_occ.data_ptr(),
        None if ap is None else ap.data_ptr(),
        None if bp is None else bp.data_ptr(), batch, batch_a, batch_b, m,
        k, n, bm, bn, bk, float(sat), stream)
    build.check(lib, code, f"sparse_semiring_matmul[{semiring}]")
    LAUNCHES["sparse"] += 1
    return out


def sparse_semiring_matmul(a: torch.Tensor, b: torch.Tensor,
                           semiring: str = "count", *, sat: float = SAT,
                           bm: int = 128, bn: int = 128,
                           bk: int = 128) -> torch.Tensor:
    """Block-sparse semiring product ``A ⊗ B``, bitwise equal to
    :func:`repro_torch.kernels.semiring.semiring_matmul`; operands may
    carry one leading batch dimension.

    ``bm``, ``bn`` and ``bk`` are the occupancy tiles: a (bm, bk) tile of
    A and a (bk, bn) tile of B are skipped together when either holds
    only the identity.  ``bool`` takes and returns bool tensors; ``count``
    and ``minplus`` work in f32.  CUDA operands launch the CUDA kernel
    (or raise); CPU operands take the plain version."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; "
                         f"choose from {SEMIRINGS}")
    if a.is_cuda or b.is_cuda:
        return _launch(a, b, semiring, sat, bm, bn, bk)
    return ref.sparse_semiring_matmul_ref(a, b, semiring, sat=sat)
