"""repro_torch.experiments — the declarative experiment API of the port.

A cell is a topology spec x a routing-scheme spec x a traffic-pattern
spec x an evaluator spec, run through a memoizing :class:`Session` on
one device (``"cuda"`` unless the caller asks for ``"cpu"``):

    from repro_torch.experiments import Session
    s = Session(device="cuda")
    rr = s.run("sf(q=5)", "fatpaths(n_layers=9,rho=0.6)", "adversarial",
               "transport(steps=1200)")
    print(rr.metrics["fct_p99_us"])

Grids go through :meth:`Session.sweep` or the CLI
(``python -m repro_torch.experiments sweep|run|list|diff``).  The
records are the JAX package's :class:`RunResult`, so artifacts of the
two packages compare with ``diff``.

* :mod:`repro_torch.experiments.specs`    — mini-spec grammar + ExperimentSpec.
* :mod:`repro_torch.experiments.registry` — decorator registries.
* :mod:`repro_torch.experiments.catalog`  — the registered axes.
* :mod:`repro_torch.experiments.session`  — artifact memoization + grid runner.
* :mod:`repro_torch.experiments.results`  — canonical RunResult JSON records.
"""

from .catalog import (EVALUATORS, ROUTINGS, TOPOLOGIES, TRAFFIC,  # noqa: F401
                      RoutingBundle, topo_spec)
from .results import (EXECUTION_META_KEYS, RunResult,  # noqa: F401
                      compare_results, order_results, results_from_json,
                      results_to_json, summary_table)
from .session import ResolvedCell, Session  # noqa: F401
from .specs import ExperimentSpec, Spec, SpecError, split_spec_list  # noqa: F401

__all__ = ["EVALUATORS", "ROUTINGS", "TOPOLOGIES", "TRAFFIC",
           "RoutingBundle", "topo_spec", "EXECUTION_META_KEYS", "RunResult",
           "compare_results", "order_results", "results_from_json",
           "results_to_json", "summary_table", "ResolvedCell", "Session",
           "ExperimentSpec", "Spec", "SpecError", "split_spec_list"]
