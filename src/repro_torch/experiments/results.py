"""Result layer: the canonical JSON-serializable experiment record.

Every evaluator reduces to one :class:`RunResult` per cell — a flat,
diffable record (cell identity strings, a ``metrics`` dict of plain
floats, a ``meta`` dict of bookkeeping, wall time) that round-trips
through JSON exactly.  The perf trajectory, the CI smoke artifact and
the CLI all speak this one format.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List

__all__ = ["RunResult", "results_to_json", "results_from_json",
           "summary_table", "order_results", "compare_results",
           "EXECUTION_META_KEYS"]


@dataclasses.dataclass(frozen=True)
class RunResult:
    """Outcome of one evaluated cell of the experiment matrix."""

    topo: str                  # canonical mini-spec, e.g. "sf(q=5)"
    routing: str               # e.g. "fatpaths(n_layers=9,rho=0.6)"
    pattern: str               # e.g. "adversarial"
    evaluator: str             # e.g. "transport(steps=400)"
    seed: int
    metrics: Dict[str, float]
    meta: Dict[str, Any]
    wall_s: float

    @property
    def cell_id(self) -> str:
        return (f"{self.topo}/{self.routing}/{self.pattern}/"
                f"{self.evaluator}@s{self.seed}")

    def to_dict(self) -> Dict[str, Any]:
        return {"topo": self.topo, "routing": self.routing,
                "pattern": self.pattern, "evaluator": self.evaluator,
                "seed": self.seed, "metrics": dict(self.metrics),
                "meta": dict(self.meta), "wall_s": self.wall_s}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunResult":
        return cls(topo=d["topo"], routing=d["routing"],
                   pattern=d["pattern"], evaluator=d["evaluator"],
                   seed=int(d["seed"]), metrics=dict(d["metrics"]),
                   meta=dict(d["meta"]), wall_s=float(d["wall_s"]))

    @classmethod
    def from_json(cls, text: str) -> "RunResult":
        return cls.from_dict(json.loads(text))


def results_to_json(results: Iterable[RunResult], indent: int = 1) -> str:
    return json.dumps([r.to_dict() for r in results], indent=indent,
                      sort_keys=True)


def results_from_json(text: str) -> List[RunResult]:
    return [RunResult.from_dict(d) for d in json.loads(text)]


# Meta keys that describe HOW a cell was executed (timings, cache
# hit/miss counters, batch bookkeeping), not WHAT it computed.  They
# legitimately differ between a sequential sweep and a distributed one
# (artifact builds land on different cells, walls differ), so the
# cell-identity comparison below ignores them.
EXECUTION_META_KEYS = frozenset({
    "build_s", "build_device_s", "cache_builds", "cache_hits",
    "sweep_bucket", "sweep_resumed", "sweep_chunks",
})


def order_results(results: Iterable[RunResult],
                  cell_ids: Iterable[str]) -> List[RunResult]:
    """Reorder ``results`` to match the canonical ``cell_ids`` sequence.

    The distributed sweep engine executes cells bucket-by-bucket (grouped
    by shape signature), so completion order depends on bucketing and
    device count; the emitted artifact must not.  Unknown ids raise —
    a sweep must account for every planned cell."""
    by_id: Dict[str, List[RunResult]] = {}
    for r in results:
        by_id.setdefault(r.cell_id, []).append(r)
    out: List[RunResult] = []
    for cid in cell_ids:
        bucket = by_id.get(cid)
        if not bucket:
            raise KeyError(f"no result for planned cell {cid!r}")
        out.append(bucket.pop(0))
    leftover = [cid for cid, rs in by_id.items() if rs]
    if leftover:
        raise KeyError(f"results for unplanned cells: {leftover[:3]!r}...")
    return out


def _close(a: float, b: float, rtol: float) -> bool:
    if a == b:                            # covers ints, exact floats, strings
        return True
    if isinstance(a, float) and isinstance(b, float):
        if a != a and b != b:             # NaN == NaN for identity purposes
            return True
        return rtol > 0 and abs(a - b) <= rtol * max(abs(a), abs(b))
    return False


def compare_results(a: Iterable[RunResult], b: Iterable[RunResult],
                    rtol: float = 0.0) -> List[str]:
    """Cell-for-cell identity check: returns a list of human-readable
    mismatch descriptions (empty == identical).

    Cells are matched by ``cell_id``; ``metrics`` and ``meta`` must agree
    exactly (``rtol`` > 0 allows a relative tolerance on float values,
    for cross-machine artifact comparison), except ``wall_s`` and the
    :data:`EXECUTION_META_KEYS` which describe execution, not results."""
    a, b = list(a), list(b)
    diffs: List[str] = []
    bi = {r.cell_id: r for r in b}
    if len(bi) != len(b):
        diffs.append("duplicate cell_ids in right-hand results")
    ai_ids = [r.cell_id for r in a]
    if sorted(ai_ids) != sorted(bi):
        only_a = set(ai_ids) - set(bi)
        only_b = set(bi) - set(ai_ids)
        diffs.append(f"cell sets differ: only-left={sorted(only_a)[:3]} "
                     f"only-right={sorted(only_b)[:3]}")
        return diffs
    for ra in a:
        rb = bi[ra.cell_id]
        for field, da, db in (("metrics", ra.metrics, rb.metrics),
                              ("meta", ra.meta, rb.meta)):
            ka = set(da) - EXECUTION_META_KEYS
            kb = set(db) - EXECUTION_META_KEYS
            if ka != kb:
                diffs.append(f"{ra.cell_id}: {field} keys differ "
                             f"{sorted(ka ^ kb)}")
                continue
            for k in sorted(ka):
                if not _close(da[k], db[k], rtol):
                    diffs.append(f"{ra.cell_id}: {field}[{k}] "
                                 f"{da[k]!r} != {db[k]!r}")
    return diffs


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if v != v:                       # nan
            return "nan"
        if abs(v) >= 1000 or (0 < abs(v) < 0.01):
            return f"{v:.3g}"
        return f"{v:.2f}"
    return str(v)


def summary_table(results: Iterable[RunResult]) -> str:
    """Aligned text table: one row per cell, metrics as k=v."""
    rows = []
    for r in results:
        cell = f"{r.topo} {r.routing} {r.pattern} {r.evaluator} s{r.seed}"
        mets = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(r.metrics.items()))
        rows.append((cell, mets, r.wall_s))
    if not rows:
        return "(no results)"
    w = max(len(c) for c, _, _ in rows)
    return "\n".join(f"{c:<{w}}  [{t:6.2f}s]  {m}" for c, m, t in rows)
