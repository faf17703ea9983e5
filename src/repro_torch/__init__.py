"""FatPaths on PyTorch and CUDA: the port of the JAX package ``repro``.

Module for module it mirrors ``repro`` (``core``, ``kernels``,
``experiments``), with every kernel of its path written by hand for the
H100 (``kernels/csrc``) beside a plain PyTorch version.  It imports
``torch``, numpy and scipy, never JAX.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on; ``cuda`` without a
    card raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
