"""Spec layer: frozen experiment specs + the string mini-spec grammar.

A *mini-spec* is ``name`` or ``name(k=v,k=v,...)`` — e.g. ``"sf(q=19)"``,
``"fatpaths(n_layers=9,rho=0.6)"``, ``"ecmp(n=8)"``, ``"adversarial"``.
Values are parsed as int, float, bool (``true``/``false``) or bare
string; nested specs are allowed as values (``"jfeq(of=sf(q=5))"``).
:meth:`Spec.format` is the canonical form (keys sorted), and
``Spec.parse(spec.format()) == spec`` always holds.

An :class:`ExperimentSpec` names one cell of the evaluation matrix:
topology x routing scheme x traffic pattern x evaluator (+ seed).  It is
frozen and hashable, so it doubles as a cache / result key.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Tuple, Union

__all__ = ["Spec", "ExperimentSpec", "SpecError", "split_spec_list"]

SpecLike = Union[str, "Spec"]

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class SpecError(ValueError):
    """Malformed mini-spec string or unknown registry name/parameter."""


def _split_top_level(text: str) -> List[str]:
    """Split on commas not nested inside parentheses."""
    parts: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in text:
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise SpecError(f"unbalanced ')' in {text!r}")
        cur.append(ch)
    if depth != 0:
        raise SpecError(f"unbalanced '(' in {text!r}")
    parts.append("".join(cur))
    return parts


def split_spec_list(text: str) -> List[str]:
    """Split a comma-separated list of mini-specs, respecting parentheses
    (``"ecmp(n=4),fatpaths(n_layers=9,rho=0.6)"`` -> two items)."""
    return [p.strip() for p in _split_top_level(text) if p.strip()]


def _parse_value(text: str) -> Any:
    s = text.strip()
    if not s:
        raise SpecError("empty value")
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "none":
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _format_value(v: Any) -> str:
    if isinstance(v, Spec):
        return v.format()
    if v is None:
        return "none"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    return str(v)


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parsed mini-spec: a registry name + keyword overrides.

    ``kwargs`` is a tuple of (key, value) pairs, kept sorted by key so
    that equal specs compare (and hash) equal regardless of the order
    they were written in.
    """

    name: str
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise SpecError(f"invalid spec name {self.name!r}")
        object.__setattr__(
            self, "kwargs",
            tuple(sorted(tuple(self.kwargs), key=lambda kv: kv[0])))

    @property
    def kw(self) -> dict:
        return dict(self.kwargs)

    def format(self) -> str:
        """Canonical string form; ``Spec.parse`` round-trips it."""
        if not self.kwargs:
            return self.name
        inner = ",".join(f"{k}={_format_value(v)}" for k, v in self.kwargs)
        return f"{self.name}({inner})"

    def __str__(self) -> str:
        return self.format()

    @classmethod
    def parse(cls, text: str) -> "Spec":
        s = text.strip()
        if "(" not in s:
            if s.endswith(")"):
                raise SpecError(f"unbalanced ')' in {text!r}")
            return cls(name=s)
        if not s.endswith(")"):
            raise SpecError(f"missing closing ')' in {text!r}")
        name, inner = s[:-1].split("(", 1)
        items: List[Tuple[str, Any]] = []
        seen = set()
        if inner.strip():
            for part in _split_top_level(inner):
                if "=" not in part:
                    raise SpecError(
                        f"expected k=v in {text!r}, got {part.strip()!r}")
                k, v = part.split("=", 1)
                k = k.strip()
                if not _NAME_RE.match(k):
                    raise SpecError(f"invalid parameter name {k!r} in {text!r}")
                if k in seen:
                    raise SpecError(f"duplicate parameter {k!r} in {text!r}")
                seen.add(k)
                items.append((k, _parse_value(v)))
        return cls(name=name.strip(), kwargs=tuple(items))

    @classmethod
    def coerce(cls, obj: SpecLike) -> "Spec":
        if isinstance(obj, Spec):
            return obj
        if isinstance(obj, str):
            return cls.parse(obj)
        raise SpecError(f"cannot coerce {type(obj).__name__} to Spec")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One cell of the evaluation matrix, fully declarative."""

    topo: Spec
    routing: Spec
    pattern: Spec
    evaluator: Spec = Spec("transport")
    seed: int = 0

    @classmethod
    def make(cls, topo: SpecLike, routing: SpecLike, pattern: SpecLike,
             evaluator: SpecLike = "transport", seed: int = 0
             ) -> "ExperimentSpec":
        return cls(topo=Spec.coerce(topo), routing=Spec.coerce(routing),
                   pattern=Spec.coerce(pattern),
                   evaluator=Spec.coerce(evaluator), seed=int(seed))

    @property
    def cell_id(self) -> str:
        return (f"{self.topo.format()}/{self.routing.format()}/"
                f"{self.pattern.format()}/{self.evaluator.format()}"
                f"@s{self.seed}")
