"""repro_torch.parallel — the parameter sharding rules of the reference's
``parallel`` package (PyTorch port).

Only the rule table is ported: :func:`sharding.param_pspecs` tells the
workload lowering (:mod:`repro_torch.core.workloads`) which parameter axes
are ``'model'``-sharded.  Not ported yet: placing arrays on a device mesh,
the batch / cache / optimizer rules and the sharded execution path, which
belong to the training slice.
"""
from . import sharding
from .sharding import P, param_pspecs

__all__ = ["P", "param_pspecs", "sharding"]
