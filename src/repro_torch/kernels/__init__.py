"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``semiring``  — batched semiring product (bool, count, minplus): the
                  APSP behind every forwarding table.
* ``waterfill`` — one max-min water-filling step: the flow simulator's
                  inner loop.
* ``sparse``    — the semiring product with identity tiles skipped
                  (bitwise equal to ``semiring``).
* ``pathcount`` — the ``count`` semiring under its historical name.
* ``gfmm``      — GF(p) modular product, Cheung connectivity (App. B.3).
* ``flash_attention`` — online-softmax attention (GQA, window, softcap)
                  for the LM substrate, and its backward pass
                  (``flash_attention_bwd``, behind an autograd Function).
* ``ops``       — walk-count powers, the GF(p) power sum, attention.
* ``ref``       — the plain PyTorch versions.
* ``build``     — nvcc build and ``ctypes`` loading of ``csrc/*.cu``.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
Each wrapper adds one to ``LAUNCHES[name]`` per kernel launch, which is
how a run proves that its main path went through the kernels.
"""

from typing import Dict

__all__ = ["LAUNCHES", "reset_launches", "semiring_matmul",
           "sparse_semiring_matmul", "tile_occupancy", "pathcount_matmul",
           "waterfill_step", "gf_matmul", "flash_attention",
           "flash_attention_bwd", "ops", "ref"]

LAUNCHES: Dict[str, int] = {"semiring": 0, "waterfill": 0, "sparse": 0,
                            "gfmm": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


from . import ops, ref  # noqa: E402
from .flash_attention import (flash_attention,  # noqa: E402
                              flash_attention_bwd)
from .gfmm import gf_matmul  # noqa: E402
from .pathcount import pathcount_matmul  # noqa: E402
from .semiring import semiring_matmul  # noqa: E402
from .sparse import sparse_semiring_matmul, tile_occupancy  # noqa: E402
from .waterfill import waterfill_step  # noqa: E402
