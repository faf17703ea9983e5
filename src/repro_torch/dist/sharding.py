"""The layout contract on one device: ``Runtime`` with ``mesh=None``.

The JAX package's ``Runtime`` (``dist/sharding.py``) resolves the logical
axes ``"fsdp"`` and ``"tp"`` to a device mesh and degrades to no-ops
without one.  The port runs on one device so far, where the only layout
knob any code reads is ``collective_dtype``, the wire dtype gradients are
cast to before the optimizer (the train step does so on one device too,
as the JAX package's does).  The model functions keep their ``rt``
argument, so that the multi-device slice (ROADMAP A13.5) adds the mesh,
the axis sizes, the sharding constraints and the sequence-sharded decode
together with the code that reads them, without new signatures; until
then a mesh raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["Runtime"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Frozen layout contract of one device; see the module docstring."""

    mesh: Optional[Any] = None
    collective_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port's Runtime takes mesh=None only (one device); "
                "meshes come with ROADMAP A13.5")
        if self.collective_dtype not in _DTYPES:
            raise ValueError(f"collective_dtype must be one of "
                             f"{sorted(_DTYPES)}, got "
                             f"{self.collective_dtype!r}")

    def astype(self, x: torch.Tensor) -> torch.Tensor:
        """Cast to the collective wire dtype (``collective_dtype``)."""
        return x.to(_DTYPES[self.collective_dtype])
