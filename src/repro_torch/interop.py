"""Carry state from outside the port into it, as plain numpy.

The port imports nothing of the reference package; a caller that holds a
graph, start vectors or model weights made elsewhere (the parity tests hold
the reference's) passes their arrays through these helpers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.graphs import Topology
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["topology_from_arrays", "to_device", "params_from_reference"]


def topology_from_arrays(name: str, n: int, edges: np.ndarray,
                         loops: Optional[np.ndarray] = None,
                         meta: Optional[Dict] = None) -> Topology:
    """A port :class:`Topology` from plain arrays: ``edges`` (m, 2) integer
    endpoints, ``loops`` optional (n,) self-loop weights, ``meta`` copied
    (e.g. ``{"bipartite": True}``).  The arrays are copied, so the caller's
    object is never aliased."""
    return Topology(str(name), int(n), np.array(edges, dtype=np.int64),
                    loops=None if loops is None
                    else np.array(loops, dtype=np.float64),
                    meta=dict(meta or {}))


def to_device(array: np.ndarray,
              device: Union[str, torch.device, None] = DEFAULT_DEVICE,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A numpy array (e.g. Lanczos start vectors ``v0`` / ``v0s``) as a
    tensor of ``dtype`` on the port's ``device``."""
    return torch.as_tensor(np.asarray(array), dtype=dtype,
                           device=resolve_device(device))


#: ml_dtypes' extension types (numpy has none of them natively) -> the
#: torch type and the integer type their raw bit patterns move as
_RAW_TYPES = {"bfloat16": (torch.bfloat16, np.int16),
              "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
              "float8_e5m2": (torch.float8_e5m2, np.uint8)}


def _tensor_from_numpy(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``dev`` in the same dtype; bfloat16 and float8
    arrays (numpy has no native such types: they arrive as ml_dtypes'
    extension types) move as their raw bit patterns."""
    a = np.asarray(a)
    if a.dtype.name in _RAW_TYPES:
        dt, raw = _RAW_TYPES[a.dtype.name]
        bits = torch.from_numpy(np.ascontiguousarray(a).view(raw).copy())
        return bits.view(dt).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_reference(tree: Dict[str, Any], cfg,
                          device: Union[str, torch.device, None] = DEFAULT_DEVICE
                          ) -> Dict[str, Any]:
    """The port's LM parameters from the reference's parameter tree, given
    as numpy arrays with the same nesting (``{"embed", "blocks": [...],
    "final_norm", "head"}``, block leaves with their leading (R,) axis).
    Every leaf is copied path by path, in its dtype, to ``device``; the tree
    must have exactly the leaves of ``models.model.param_shapes(cfg)``."""
    from repro_torch.models.model import param_shapes

    dev = resolve_device(device)

    def walk(shapes, sub, path):
        if isinstance(shapes, dict):
            if not isinstance(sub, dict) or set(sub) != set(shapes):
                raise ValueError(f"params_from_reference: keys at {path!r} "
                                 f"are {sorted(sub) if isinstance(sub, dict) else type(sub)}, "
                                 f"expected {sorted(shapes)}")
            return {k: walk(shapes[k], sub[k], f"{path}/{k}") for k in shapes}
        if isinstance(shapes, list):
            if len(sub) != len(shapes):
                raise ValueError(f"params_from_reference: {path!r} has "
                                 f"{len(sub)} entries, expected {len(shapes)}")
            return [walk(s, x, f"{path}/{i}")
                    for i, (s, x) in enumerate(zip(shapes, sub))]
        t = _tensor_from_numpy(sub, dev)
        if tuple(t.shape) != tuple(shapes):
            raise ValueError(f"params_from_reference: {path!r} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shapes)}")
        return t

    return walk(param_shapes(cfg), tree, "")
