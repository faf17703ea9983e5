"""repro_torch.dist — the mesh, the FatPaths-layered collectives, and
collective traffic on a modelled fabric.

* :mod:`repro_torch.dist.sharding`    — ``Runtime``, ``Mesh`` and ``P``:
  the LM substrate's layout contract, per-rank shards over the ranks of
  a ``torch.distributed`` world (no-ops on one device).
* :mod:`repro_torch.dist.collectives` — :func:`layer_strides` and the
  stride-ring collectives (``ring_reduce_scatter``, ``ring_all_gather``,
  ``multiring_all_reduce``) over ``torch.distributed`` point-to-point
  ops.
* :mod:`repro_torch.dist.fabric`      — ``ClusterFabric``: maps
  collective traffic onto :mod:`repro_torch.core` topologies under
  minimal-path ECMP vs FatPaths layered routing and reports bottleneck
  bytes, time and link-load spread.
"""

from . import collectives, fabric, sharding  # noqa: F401
from .collectives import (WireLog, layer_strides,  # noqa: F401
                          multiring_all_reduce, ring_all_gather,
                          ring_reduce_scatter)
from .fabric import ClusterFabric, CollectiveReport, collective_flows  # noqa: F401
from .sharding import Mesh, P, Runtime, host_device_runtime  # noqa: F401

__all__ = ["layer_strides", "ring_reduce_scatter", "ring_all_gather",
           "multiring_all_reduce", "WireLog", "Mesh", "P", "Runtime",
           "host_device_runtime", "ClusterFabric", "CollectiveReport",
           "collective_flows"]
