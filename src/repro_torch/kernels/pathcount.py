"""Saturating path-count product ``min(A @ B, SAT)`` (paper Appendix B.1).

The ``"count"`` instance of :func:`repro_torch.kernels.semiring
.semiring_matmul`, kept under its historical name: powers of an
adjacency matrix count walks (Theorem 1), exact in f32 below 2**24.
"""

from __future__ import annotations

import torch

from .semiring import SAT, semiring_matmul

__all__ = ["pathcount_matmul", "SAT"]


def pathcount_matmul(a: torch.Tensor, b: torch.Tensor, *,
                     sat: float = SAT) -> torch.Tensor:
    """min(A @ B, sat) in f32."""
    return semiring_matmul(a, b, "count", sat=sat)
