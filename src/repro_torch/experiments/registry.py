"""Decorator-based registries for the experiment matrix axes.

Each registry maps a mini-spec name to a builder function plus its
declared defaults.  The defaults double as the parameter whitelist:
a spec naming an unknown entry or an undeclared parameter raises
:class:`~repro_torch.experiments.specs.SpecError` with the valid options, so
typos fail loudly at parse/resolve time, not deep inside a build.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from .specs import Spec, SpecError, SpecLike

__all__ = ["Registry"]


class Registry:
    """Name -> (builder, defaults) with spec resolution."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Tuple[Callable, Dict[str, Any]]] = {}

    def register(self, name: str, **defaults) -> Callable:
        """Decorator: register ``fn`` under ``name``; ``defaults`` declare
        every overridable parameter and its default value."""
        if name in self._entries:
            raise ValueError(f"{self.kind} {name!r} registered twice")

        def deco(fn: Callable) -> Callable:
            self._entries[name] = (fn, dict(defaults))
            return fn

        return deco

    def names(self):
        return sorted(self._entries)

    def defaults(self, name: str) -> Dict[str, Any]:
        return dict(self._entries[name][1])

    def doc(self, name: str) -> str:
        """First line of the builder's docstring ('' if undocumented) —
        the one-line description ``experiments list`` prints."""
        d = self._entries[name][0].__doc__ or ""
        return d.strip().splitlines()[0].strip() if d.strip() else ""

    def resolve(self, spec: SpecLike) -> Tuple[Callable, Dict[str, Any]]:
        """Spec -> (builder, merged kwargs); validates name + parameters."""
        spec = Spec.coerce(spec)
        if spec.name not in self._entries:
            raise SpecError(
                f"unknown {self.kind} {spec.name!r}; "
                f"known: {', '.join(self.names())}")
        fn, defaults = self._entries[spec.name]
        kw = dict(defaults)
        for k, v in spec.kwargs:
            if k not in defaults:
                raise SpecError(
                    f"{self.kind} {spec.name!r} has no parameter {k!r} "
                    f"(accepts: {', '.join(sorted(defaults)) or 'none'})")
            kw[k] = v
        return fn, kw

    def build(self, spec: SpecLike, *args, **extra):
        fn, kw = self.resolve(spec)
        return fn(*args, **kw, **extra)

    def canonical(self, spec: SpecLike) -> str:
        """Defaults-filled canonical form: ``"clique"`` and
        ``"clique(k=12)"`` map to the same string, so cache keys built
        from it never double-build equivalent specs."""
        spec = Spec.coerce(spec)
        _, kw = self.resolve(spec)
        return Spec(spec.name, tuple(kw.items())).format()
