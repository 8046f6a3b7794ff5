"""Unified topology registry of the PyTorch port (a copy of the reference
registry).

One addition: ``build(spec, device=...)`` hands ``device`` to the families
whose constructors compute on the device — the designed families ``xpander``
and ``rewired`` (:mod:`repro_torch.core.synthesis`), which search on the
card by default — and ignores it for the host-built families.

Every topology family of the survey (paper §4 + the LPS Ramanujan reference of
§3) registers itself here via the :func:`register` decorator applied to its
constructor in :mod:`repro_torch.core.topologies` / :mod:`repro_torch.core.ramanujan`.
A :class:`Family` record carries, in one place, what used to be scattered
across three call sites:

* the constructor (formerly the ``CASES`` lambdas of ``benchmarks/table1.py``),
* the parameter schema (formerly the if/elif ``build()`` chain of
  ``examples/topology_report.py``),
* the analytic Table-1 closed forms (formerly only reachable through
  ``bounds.TABLE1`` keyed by free-floating name strings).

Spec strings
------------
``build("slimfly(q=13)")``, ``build("torus(16,2)")`` and bare names with
defaultable parameters (``build("petersen")``) work from CLIs and config
files.  Positional arguments bind in schema order; values are Python literals
(ints, floats, bools, strings).

This module deliberately imports nothing from ``repro_torch.core`` at module scope
(only under ``TYPE_CHECKING``) so constructors can import the decorator
without a cycle; registration happens as a side effect of importing the
constructor modules, which :func:`_ensure_populated` triggers lazily.
"""
from __future__ import annotations

import ast
import dataclasses
import difflib
import inspect
import warnings
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, TYPE_CHECKING)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.graphs import Topology

__all__ = [
    "Family", "TopologyRegistry", "REGISTRY", "register", "get", "families",
    "build", "parse_spec", "closed_forms", "SpecError",
]


class SpecError(ValueError):
    """A topology spec string or parameter set that cannot be resolved."""


@dataclasses.dataclass(frozen=True)
class Family:
    """Everything the survey needs to know about one topology family."""
    name: str
    ctor: Callable[..., "Topology"]
    params: Tuple[Tuple[str, type], ...]      # ordered (name, type) schema
    defaults: Mapping[str, Any]
    closed_forms: Optional[Callable[..., Dict[str, float]]] = None
    aliases: Tuple[str, ...] = ()
    deprecated_aliases: Tuple[str, ...] = ()
    tags: frozenset = frozenset()
    variadic: bool = False                    # single param absorbs *args
    default_instance: Optional[str] = None    # canonical small spec string
    doc: str = ""

    # -- construction -----------------------------------------------------
    def bind(self, args: Sequence[Any] = (), kwargs: Optional[Mapping[str, Any]] = None
             ) -> Dict[str, Any]:
        """Resolve positional/keyword values against the schema → full kwargs."""
        kwargs = dict(kwargs or {})
        names = [p for p, _ in self.params]
        if self.variadic:
            if kwargs:
                raise SpecError(f"{self.name} takes positional values only "
                                f"(variadic '{names[0]}')")
            return {names[0]: tuple(args)}
        if len(args) > len(names):
            raise SpecError(f"{self.name} takes at most {len(names)} "
                            f"parameters {names}, got {len(args)} positional")
        bound = dict(zip(names, args))
        for k, v in kwargs.items():
            if k not in names:
                raise SpecError(f"{self.name} has no parameter '{k}' "
                                f"(schema: {names})")
            if k in bound:
                raise SpecError(f"{self.name}: parameter '{k}' given twice")
            bound[k] = v
        for k, v in self.defaults.items():
            bound.setdefault(k, v)
        missing = [n for n in names if n not in bound]
        if missing:
            raise SpecError(f"{self.name} missing required parameter(s) "
                            f"{missing} (schema: {names})")
        for (pname, ptype) in self.params:
            val = bound[pname]
            if ptype is int and isinstance(val, bool):
                raise SpecError(f"{self.name}.{pname}: expected int, got bool")
            if ptype in (int, float, str) and not isinstance(val, ptype):
                if ptype is float and isinstance(val, int):
                    bound[pname] = float(val)
                else:
                    raise SpecError(f"{self.name}.{pname}: expected "
                                    f"{ptype.__name__}, got {val!r}")
        return bound

    def build(self, *args: Any, device: Any = None,
              **kwargs: Any) -> "Topology":
        """Construct an instance (schema-checked), stamping ``family``/
        ``spec``/tag metadata onto the returned Topology.  ``device`` goes to
        constructors that take one (the synthesis families; None keeps their
        default, the card) and is ignored by the others."""
        bound = self.bind(args, kwargs)
        extra = {}
        if device is not None and \
                "device" in inspect.signature(self.ctor).parameters:
            extra["device"] = device
        if self.variadic:
            topo = self.ctor(*bound[self.params[0][0]], **extra)
        else:
            topo = self.ctor(**bound, **extra)
        topo.meta.setdefault("family", self.name)
        topo.meta.setdefault("spec", self.spec_string(bound))
        for tag in self.tags:
            topo.meta.setdefault(tag, True)
        return topo

    def forms(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, float]]:
        """Analytic closed forms (nodes/radix/rho2/bw) at these parameters."""
        if self.closed_forms is None:
            return None
        bound = self.bind(args, kwargs)
        if self.variadic:
            return self.closed_forms(*bound[self.params[0][0]])
        return self.closed_forms(**bound)

    def spec_string(self, bound: Mapping[str, Any]) -> str:
        if self.variadic:
            vals = ",".join(repr(v) for v in bound[self.params[0][0]])
            return f"{self.name}({vals})"
        if not self.params:
            return self.name
        vals = ",".join(repr(bound[p]) for p, _ in self.params)
        return f"{self.name}({vals})"


class TopologyRegistry:
    """Name → :class:`Family` map with alias resolution and spec parsing."""

    def __init__(self) -> None:
        self._families: Dict[str, Family] = {}
        self._alias: Dict[str, str] = {}
        self._deprecated: Dict[str, str] = {}

    # -- registration -----------------------------------------------------
    def register(self, name: str, *, params: Optional[Mapping[str, type]] = None,
                 defaults: Optional[Mapping[str, Any]] = None,
                 closed_forms: Optional[Callable[..., Dict[str, float]]] = None,
                 aliases: Sequence[str] = (),
                 deprecated_aliases: Sequence[str] = (),
                 tags: Sequence[str] = (),
                 variadic: bool = False,
                 default_instance: Optional[str] = None) -> Callable:
        """Decorator registering a constructor as a topology family."""
        def deco(ctor: Callable[..., "Topology"]) -> Callable[..., "Topology"]:
            if name in self._families or name in self._alias:
                raise ValueError(f"duplicate topology family {name!r}")
            fam = Family(
                name=name, ctor=ctor,
                params=tuple((params or {}).items()),
                defaults=dict(defaults or {}),
                closed_forms=closed_forms,
                aliases=tuple(aliases),
                deprecated_aliases=tuple(deprecated_aliases),
                tags=frozenset(tags),
                variadic=variadic,
                default_instance=default_instance,
                doc=(ctor.__doc__ or "").strip().splitlines()[0] if ctor.__doc__ else "",
            )
            self._families[name] = fam
            for a in fam.aliases:
                self._alias[a] = name
            for a in fam.deprecated_aliases:
                self._deprecated[a] = name
            return ctor
        return deco

    # -- lookup -----------------------------------------------------------
    def get(self, name: str) -> Family:
        _ensure_populated()
        if name in self._families:
            return self._families[name]
        if name in self._alias:
            return self._families[self._alias[name]]
        if name in self._deprecated:
            target = self._deprecated[name]
            warnings.warn(f"topology family {name!r} is deprecated; use "
                          f"{target!r}", DeprecationWarning, stacklevel=3)
            return self._families[target]
        known = sorted(set(self._families) | set(self._alias) | set(self._deprecated))
        hint = difflib.get_close_matches(name, known, n=1)
        suffix = f" — did you mean {hint[0]!r}?" if hint else ""
        raise SpecError(f"unknown topology family {name!r}{suffix} "
                        f"(known: {', '.join(known)})")

    def families(self) -> List[str]:
        _ensure_populated()
        return sorted(self._families)

    def __contains__(self, name: str) -> bool:
        _ensure_populated()
        return (name in self._families or name in self._alias
                or name in self._deprecated)

    def __iter__(self):
        _ensure_populated()
        return iter(sorted(self._families.values(), key=lambda f: f.name))

    # -- spec strings -----------------------------------------------------
    def parse(self, spec: str) -> Tuple[Family, Dict[str, Any]]:
        """``"slimfly(q=13)"`` → (Family, {"q": 13}).  Bare names allowed."""
        spec = spec.strip()
        if not spec:
            raise SpecError("empty topology spec")
        if "(" not in spec:
            fam = self.get(spec)
            return fam, fam.bind()
        try:
            node = ast.parse(spec, mode="eval").body
        except SyntaxError as e:
            raise SpecError(f"unparseable topology spec {spec!r}: {e}") from e
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Name):
            raise SpecError(f"topology spec must look like name(arg, key=val); "
                            f"got {spec!r}")
        fam = self.get(node.func.id)
        try:
            args = [ast.literal_eval(a) for a in node.args]
            kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
        except (ValueError, SyntaxError) as e:
            raise SpecError(f"spec arguments must be literals: {spec!r}") from e
        if None in kwargs:
            raise SpecError(f"**kwargs not allowed in spec {spec!r}")
        return fam, fam.bind(args, kwargs)

    def build(self, spec: str, *, device: Any = None) -> "Topology":
        """Parse a spec string and construct the instance it names
        (``device``: see :meth:`Family.build`)."""
        from repro_torch import obs
        fam, bound = self.parse(spec)
        with obs.span("registry/build", phase="build", spec=spec):
            if fam.variadic:
                return fam.build(*bound[fam.params[0][0]], device=device)
            return fam.build(**bound, device=device)


#: process-wide singleton — the registration target of ``@register``.
REGISTRY = TopologyRegistry()

_populated = False


def _ensure_populated() -> None:
    """Import the constructor modules so their ``@register`` decorators run."""
    global _populated
    if _populated:
        return
    _populated = True
    import repro_torch.core.topologies   # noqa: F401  (registration side effects)
    import repro_torch.core.ramanujan    # noqa: F401
    import repro_torch.core.synthesis    # noqa: F401


def register(name: str, **kwargs: Any) -> Callable:
    """Module-level shorthand for ``REGISTRY.register`` (the decorator)."""
    return REGISTRY.register(name, **kwargs)


def get(name: str) -> Family:
    """Look up a :class:`Family` by name or (deprecated) alias.

    Args: ``name`` — family name (``"slimfly"``), alias, or deprecated alias
    (which warns).  Returns the :class:`Family` record; raises
    :class:`SpecError` with a did-you-mean hint for unknown names.
    """
    return REGISTRY.get(name)


def families() -> List[str]:
    """Sorted canonical family names currently registered (no aliases)."""
    return REGISTRY.families()


def build(spec: str, *, device: Any = None) -> "Topology":
    """Construct a topology from a spec string (or bare family name).

    Args: ``spec`` — e.g. ``"slimfly(q=13)"``, ``"torus(16,2)"`` or
    ``"petersen"``; values are Python literals, positional args bind in
    schema order.  ``device`` — where the synthesis families
    (``xpander``, ``rewired``) search; default the card.  Returns the built :class:`~repro_torch.core.graphs.Topology`
    (with ``family``/``spec`` recorded in ``meta``); raises
    :class:`SpecError` on unknown families or malformed parameters.
    """
    return REGISTRY.build(spec, device=device)


def parse_spec(spec: str) -> Tuple[Family, Dict[str, Any]]:
    """Parse without building: ``"slimfly(q=13)"`` → (Family, bound params).

    Returns the family record plus the fully-defaulted parameter dict —
    what :func:`build` would construct with; raises :class:`SpecError` on
    malformed specs.
    """
    return REGISTRY.parse(spec)


def closed_forms(name: str, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Analytic Table-1 record for a family at given parameters.

    Raises :class:`SpecError` if the family has no registered closed forms.
    """
    fam = REGISTRY.get(name)
    forms = fam.forms(*args, **kwargs)
    if forms is None:
        raise SpecError(f"family {fam.name!r} has no registered closed forms")
    return forms
