"""The layout contract on one device: ``Runtime`` with ``mesh=None``.

The JAX package's ``Runtime`` (``dist/sharding.py``) resolves the logical
axes ``"fsdp"`` and ``"tp"`` to a device mesh and degrades to no-ops
without one.  The port runs on one device so far, where no code reads a
layout knob, so ``Runtime`` is an empty marker.  The model functions keep
their ``rt`` argument, so that the multi-device slice (ROADMAP A13.5)
adds the mesh, the axis sizes, the sharding constraints and the
sequence-sharded decode together with the code that reads them, without
new signatures; until then a mesh raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["Runtime"]


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Frozen layout contract of one device; see the module docstring."""

    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port's Runtime takes mesh=None only (one device); "
                "meshes come with ROADMAP A13.5")
