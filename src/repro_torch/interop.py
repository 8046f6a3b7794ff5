"""Carry state from outside the port into it, as plain numpy.

The port imports nothing of the reference package; a caller that holds a
graph or start vectors made elsewhere (the parity tests hold the
reference's) passes their arrays through these helpers.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.graphs import Topology
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["topology_from_arrays", "to_device"]


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
