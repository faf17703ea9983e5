"""GF(p) modular matrix product for connectivity propagation.

The Cheung et al. edge-connectivity algorithm (paper Appendix B.3)
iterates ``M <- (M @ K + I) mod p`` over a finite field.
:func:`gf_matmul` computes one ``C = (A @ B) mod p``, reduced per K
tile, for inputs already reduced to [0, p).

The JAX package's TPU kernel has two arithmetic modes, kept here with
their limits:

* ``int32``: K-tile sums ``bk * p^2`` must stay below 2^31, so
  ``GF_P_INT32 = 1009`` with ``bk = 128``;
* ``f32``: exact while ``bk * p^2 < 2^24``, so ``GF_P_F32 = 251``.

Both return the same integers, and both modes differ only in that
check.  A CUDA tensor runs the hand-written kernel in ``csrc/gfmm.cu`` on
the int8 tensor cores (``bm``, ``bn`` and ``bk`` only enter the mode's
limit there): every residue splits into 8-bit limbs, ``r = lo + 256 hi``
(:func:`gf_plan`), and the product is four u8 x u8 -> s32 products (one
for p <= 256) reduced mod p every ``chunk`` K entries and combined as
``(S_ll + 256 S_x + 65536 S_hh) mod p``.  p - 1 must fit two bytes, so the
wrapper refuses p > 2^16 (the mode limits already do, for any bk >= 1).
A CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.gf_matmul_ref`.  The output is int32.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build, ref

__all__ = ["gf_matmul", "gf_plan", "GF_P_INT32", "GF_P_F32", "GF_P_MAX"]

GF_P_INT32 = 1009   # bk * p^2 = 128 * 1009^2 ~ 1.3e8 < 2^31
GF_P_F32 = 251      # bk * p^2 = 256 * 251^2 ~ 1.6e7 < 2^24
GF_P_MAX = 2 ** 16  # p - 1 must fit two 8-bit limbs
_LIMIT = {"int32": 2 ** 31, "f32": 2 ** 24}
_KSTEP = 128        # K entries the CUDA kernel stages a step


def gf_plan(p: int, k: int):
    """``(limbs, chunk)`` of the CUDA kernel for modulus ``p`` and inner
    dimension ``k``.

    ``limbs`` is 1 for p <= 256 (a residue is one byte) and 2 up to
    :data:`GF_P_MAX` (``r = lo + 256 hi``, both bytes).  ``chunk`` is how
    many K entries the kernel sums in s32 before reducing mod p: the
    largest multiple of its 128-entry step that keeps the residue carried
    in plus ``chunk`` terms below 2^31, where a term is at most 255^2, or
    2 * 255^2 in the cross sum lo_A hi_B + hi_A lo_B; capped at ``k``
    rounded up to the step (one chunk)."""
    if not 2 <= p <= GF_P_MAX:
        raise ValueError(f"the GF(p) kernel takes 2 <= p <= {GF_P_MAX}, "
                         f"got p={p}")
    limbs = 1 if p <= 256 else 2
    term = 255 ** 2 * limbs
    chunk = (2 ** 31 - 1 - (p - 1)) // term // _KSTEP * _KSTEP
    return limbs, min(chunk, -(-max(k, 1) // _KSTEP) * _KSTEP)


def _lib():
    lib = build.load("gfmm")
    fn = lib.gfmm_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (m, k) x (k, n), got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    a = a.to(torch.int32).contiguous()
    b = b.to(torch.int32).contiguous()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    limbs, chunk = gf_plan(p, k)
    kp = -(-k // _KSTEP) * _KSTEP
    # Limb planes the kernel writes before it reads; freed on return,
    # which is safe: the caching allocator hands them only to work queued
    # later on the same stream.
    ap = torch.empty((limbs, m, kp), dtype=torch.uint8, device=a.device)
    bp = torch.empty((limbs, n, kp), dtype=torch.uint8, device=a.device)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.gfmm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           ap.data_ptr(), bp.data_ptr(), m, k, n, p, limbs,
                           chunk, stream)
    build.check(lib, code, "gf_matmul")
    LAUNCHES["gfmm"] += 1
    return out


def gf_matmul(a: torch.Tensor, b: torch.Tensor, *, p: int = GF_P_INT32,
              mode: str = "int32", bm: int = 128, bn: int = 128,
              bk: int = 128) -> torch.Tensor:
    """(A @ B) mod p with per-tile modular reduction, as int32.

    Inputs must already be reduced mod p (values in [0, p)).  Raises
    where the mode's limit ``bk * p^2`` (2^31 for ``int32``, 2^24 for
    ``f32``) is not met, and for p > :data:`GF_P_MAX` (reachable only
    with bk <= 0), on any device.  CUDA operands launch the CUDA kernel
    (or raise); CPU operands take the plain version."""
    if mode not in _LIMIT:
        raise ValueError(mode)
    if bk * p * p >= _LIMIT[mode]:
        raise ValueError(f"mode {mode!r} needs bk * p^2 < {_LIMIT[mode]}, "
                         f"got bk={bk}, p={p}")
    if p > GF_P_MAX:
        raise ValueError(f"p - 1 must fit two 8-bit limbs: p <= {GF_P_MAX}, "
                         f"got p={p}")
    if a.is_cuda or b.is_cuda:
        return _launch(a, b, p)
    return ref.gf_matmul_ref(a, b, p)
