"""Resumable-sweep checkpoint store: one JSON file per completed cell.

A sweep over a big evaluation grid can die hours in (preemption, OOM on
one pathological cell, Ctrl-C).  :class:`SweepCheckpoint` makes the grid
restart-safe at cell granularity with the same crash-consistency idiom
as the JAX package's training checkpoints: each
completed cell's :class:`~repro_torch.experiments.results.RunResult` is
written to ``<dir>/cell_<sha1(cell_id)>.json`` via a ``.tmp-`` +
``os.replace`` rename, so a file either holds a complete record or does
not exist.  A re-run loads the directory, skips every finished cell and
only executes the remainder — the cell id (canonical topo/routing/
pattern/evaluator specs + seed) keys the record, so a *different* grid
sharing some cells reuses exactly the overlap and nothing else.

The store is deliberately schema-light (flat JSON per cell, no
manifest): concurrent sweeps over disjoint cells may share a directory,
and a partially-written directory is always safe to resume from.  Each
record does carry a ``schema`` version (:data:`SCHEMA`): resuming from
a directory written by an incompatible repo version raises instead of
silently reusing records whose metric/meta layout has since changed —
torn or foreign files are still skipped, only files that parse as
complete records with the wrong version reject the resume.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterator, Optional

__all__ = ["SweepCheckpoint", "SchemaMismatch", "SCHEMA"]

#: Per-cell record layout version.  Bump when RunResult serialization
#: changes incompatibly (metrics/meta structure, cell-id derivation).
SCHEMA = 1


class SchemaMismatch(RuntimeError):
    """A checkpoint directory holds records from another schema version."""


def _cell_path(base: str, cell_id: str) -> str:
    h = hashlib.sha1(cell_id.encode()).hexdigest()[:20]
    return os.path.join(base, f"cell_{h}.json")


class SweepCheckpoint:
    """Cell-granular sweep persistence (see module docstring)."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._cache: Optional[Dict[str, dict]] = None

    # ---- read side -----------------------------------------------------------
    def load(self) -> Dict[str, dict]:
        """cell_id -> RunResult dict for every committed cell on disk.

        Raises :class:`SchemaMismatch` if any complete record carries a
        ``schema`` other than :data:`SCHEMA` — a stale directory from an
        incompatible repo version must not be silently resumed."""
        out: Dict[str, dict] = {}
        for name in sorted(os.listdir(self.directory)):
            if not (name.startswith("cell_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    d = json.load(f)
                cell_id, result = d["cell_id"], d["result"]
            except (json.JSONDecodeError, KeyError, OSError):
                continue          # torn/foreign file: treat as not done
            if d.get("schema") != SCHEMA:
                raise SchemaMismatch(
                    f"checkpoint directory {self.directory!r} holds record "
                    f"{name} with schema {d.get('schema')!r} (this version "
                    f"writes schema {SCHEMA}); delete or move the stale "
                    "directory to resume")
            out[cell_id] = result
        self._cache = out
        return dict(out)

    def _loaded(self) -> Dict[str, dict]:
        if self._cache is None:
            self.load()
        return self._cache

    def __contains__(self, cell_id: str) -> bool:
        return cell_id in self._loaded()

    def __len__(self) -> int:
        return len(self._loaded())

    def __iter__(self) -> Iterator[str]:
        return iter(self._loaded())

    def get(self, cell_id: str) -> Optional[dict]:
        """The stored RunResult dict for ``cell_id``, or None."""
        return self._loaded().get(cell_id)

    # ---- write side ----------------------------------------------------------
    def put(self, cell_id: str, result_dict: dict) -> None:
        """Atomically commit one completed cell (write tmp, rename)."""
        path = _cell_path(self.directory, cell_id)
        tmp = path + ".tmp-" + str(os.getpid())
        with open(tmp, "w") as f:
            json.dump({"cell_id": cell_id, "schema": SCHEMA,
                       "result": result_dict}, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if self._cache is not None:
            self._cache[cell_id] = result_dict
