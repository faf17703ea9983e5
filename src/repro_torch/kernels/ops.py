"""Public wrappers around the kernels, as in the JAX package's
``repro.kernels.ops``: walk counts by repeated products, the Cheung
propagation sum over GF(p), and attention.

Each runs where its operands lie: CUDA tensors launch the CUDA kernels,
CPU tensors take the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .gfmm import GF_P_F32, GF_P_INT32, gf_matmul
from .pathcount import SAT, pathcount_matmul

__all__ = ["path_counts_power", "gf_power_sum", "attention", "SAT",
           "GF_P_INT32", "GF_P_F32"]


def path_counts_power(adj: torch.Tensor, l: int) -> torch.Tensor:
    """A^l walk counts via the path-count product (Theorem 1)."""
    a = adj.to(torch.float32)
    out = a
    for _ in range(l - 1):
        out = pathcount_matmul(out, a)
    return out


def gf_power_sum(k_mat: torch.Tensor, l: int, p: int = GF_P_INT32,
                 mode: str = "int32") -> torch.Tensor:
    """sum_{i=0}^{l-1} K^i mod p via Horner (M <- M K + I), the Cheung
    connectivity propagation matrix (Appendix B.3)."""
    e = k_mat.shape[0]
    eye = torch.eye(e, dtype=torch.int32, device=k_mat.device)
    m = eye
    for _ in range(l - 1):
        m = gf_matmul(m, k_mat, p=p, mode=mode)
        m = (m + eye) % p
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None, bq: int = 128,
              bk: int = 128) -> torch.Tensor:
    """Flash attention (GQA/causal/window/softcap); see
    :func:`repro_torch.kernels.flash_attention.flash_attention`."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, bq=bq, bk=bk)
