"""repro_torch.dist — collective traffic on a modelled fabric.

* :mod:`repro_torch.dist.collectives` — :func:`layer_strides`, the
  coprime ring strides of the FatPaths-layered collectives (the ring
  collectives themselves wait for the multi-device slice, ROADMAP A13.5).
* :mod:`repro_torch.dist.sharding`    — ``Runtime``, the LM substrate's
  layout contract on one device (a mesh waits for ROADMAP A13.5).
* :mod:`repro_torch.dist.fabric`      — ``ClusterFabric``: maps
  collective traffic onto :mod:`repro_torch.core` topologies under
  minimal-path ECMP vs FatPaths layered routing and reports bottleneck
  bytes, time and link-load spread.
"""

from . import collectives, fabric  # noqa: F401
from .collectives import layer_strides  # noqa: F401
from .fabric import ClusterFabric, CollectiveReport, collective_flows  # noqa: F401

__all__ = ["layer_strides", "ClusterFabric", "CollectiveReport",
           "collective_flows"]
