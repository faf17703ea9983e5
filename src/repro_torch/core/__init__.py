"""FatPaths core of the port: topologies, paths, layered routing, transport.

* :mod:`repro_torch.core.topology`  — SF / DF / JF / XP / HX / FT generators.
* :mod:`repro_torch.core.paths`     — adjacency-algebra APSP and forwarding.
* :mod:`repro_torch.core.diversity` — CDP / PI / TNL metrics (§4.2, App. B.3).
* :mod:`repro_torch.core.layers`    — FatPaths layered routing (§5.2–5.4).
* :mod:`repro_torch.core.routing`   — forwarding functions, table
  accounting (§5.5).
* :mod:`repro_torch.core.traffic`   — traffic patterns (§2.4).
* :mod:`repro_torch.core.arrivals`  — open-loop arrival processes.
* :mod:`repro_torch.core.transport` — flow-level transport simulator (§7).
* :mod:`repro_torch.core.throughput` — MAT multicommodity-flow LP (§6.4).
"""

from . import (arrivals, diversity, layers, paths, routing,  # noqa: F401
               throughput, topology, traffic, transport)
from .layers import LayeredRouting, build_layers  # noqa: F401
from .topology import Topology, by_name  # noqa: F401
from .traffic import FlowWorkload, make_workload  # noqa: F401
from .transport import (SimConfig, SimResult, ecmp_routing,  # noqa: F401
                        simulate, simulate_seeds)
