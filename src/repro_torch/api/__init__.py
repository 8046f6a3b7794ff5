"""repro_torch.api — the survey API of the port: registry + lazy analysis +
fan-out survey, exporting only what is ported.

``analysis`` and ``survey`` are loaded lazily (PEP 562) so that importing the
registry from ``repro_torch.core.topologies`` (for the ``@register``
decorators) never pulls the numerics stack into the constructors' import
cycle.
"""
from .registry import (Family, REGISTRY, SpecError, TopologyRegistry, build,
                       closed_forms, families, get, parse_spec, register)

__all__ = [
    "Family", "REGISTRY", "SpecError", "TopologyRegistry", "build",
    "closed_forms", "families", "get", "parse_spec", "register",
    "Analysis", "survey", "SurveyResult", "DEFAULT_COLUMNS", "TABLE1_COLUMNS",
    "RAMANUJAN_COLUMNS", "ROUTING_COLUMNS", "SIM_COLUMNS", "FAULT_COLUMNS",
    "WORKLOAD_COLUMNS",
]

_LAZY = {
    "Analysis": ("repro_torch.api.analysis", "Analysis"),
    "survey": ("repro_torch.api.survey", "survey"),
    "SurveyResult": ("repro_torch.api.survey", "SurveyResult"),
    "COLUMNS": ("repro_torch.api.survey", "COLUMNS"),
    "DEFAULT_COLUMNS": ("repro_torch.api.survey", "DEFAULT_COLUMNS"),
    "TABLE1_COLUMNS": ("repro_torch.api.survey", "TABLE1_COLUMNS"),
    "RAMANUJAN_COLUMNS": ("repro_torch.api.survey", "RAMANUJAN_COLUMNS"),
    "ROUTING_COLUMNS": ("repro_torch.api.survey", "ROUTING_COLUMNS"),
    "SIM_COLUMNS": ("repro_torch.api.survey", "SIM_COLUMNS"),
    "FAULT_COLUMNS": ("repro_torch.api.survey", "FAULT_COLUMNS"),
    "WORKLOAD_COLUMNS": ("repro_torch.api.survey", "WORKLOAD_COLUMNS"),
}


def __getattr__(name):
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(modname)
    # pin every lazy name this module provides: importing the `survey`
    # SUBMODULE sets a package attribute of the same name, which would
    # otherwise shadow the survey() function on any later lookup
    for lazy_name, (lazy_mod, lazy_attr) in _LAZY.items():
        if lazy_mod == modname:
            globals()[lazy_name] = getattr(mod, lazy_attr)
    return globals()[name]


def __dir__():
    return sorted(set(__all__) | set(globals()))
