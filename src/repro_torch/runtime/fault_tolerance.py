"""Fault-tolerance primitives: straggler monitor, elastic re-mesh and
reshard, and the discrepancy-based degraded-operation certificate
(paper §3).

The port of the reference's ``runtime/fault_tolerance.py``.  On a torus,
losing nodes forces re-packing into a contiguous sub-torus; on a Ramanujan
interconnect the discrepancy property certifies a bandwidth floor for
*whatever* nodes survive, so the scheduler can keep the job running with
only a re-shard.  On one card :func:`reshard` places a host-materialized
tree on a device (the restore path after a re-mesh); the certificate comes
from the port's ``core/placement``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.placement import ramanujan_placement_guarantee

__all__ = ["StragglerMonitor", "reshard", "degraded_operation_certificate",
           "ElasticPlan", "plan_elastic_remesh"]


# --------------------------------------------------------------------------
# straggler mitigation
# --------------------------------------------------------------------------

class StragglerMonitor:
    """Tracks per-step wall time; flags stragglers by robust z-score.

    A step is flagged when it exceeds the window's median by ``threshold``
    robust standard deviations (1.4826 MAD) and by 20 %.  In a multi-host
    deployment that would mark the slow host for the next elastic re-mesh,
    or skip its gradient contribution for the step; here it records the
    decisions (``flagged``: (step, duration, median))."""

    def __init__(self, window: int = 32, threshold: float = 3.0,
                 min_samples: int = 8):
        self.window: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.min_samples = min_samples
        self.flagged: List[Tuple[int, float, float]] = []
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int, duration: Optional[float] = None) -> bool:
        if duration is None:
            duration = time.monotonic() - (self._t0 or time.monotonic())
        is_straggler = False
        if len(self.window) >= self.min_samples:
            med = float(np.median(self.window))
            mad = float(np.median(np.abs(np.asarray(self.window) - med))) + 1e-9
            if duration > med + self.threshold * 1.4826 * mad and duration > 1.2 * med:
                is_straggler = True
                self.flagged.append((step, duration, med))
        self.window.append(duration)
        return is_straggler


# --------------------------------------------------------------------------
# elastic re-mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_devices: int
    new_devices: int
    new_mesh_shape: Tuple[int, ...]
    note: str


def reshard(state: Any, devices: Any) -> Any:
    """Place a (host-materialized or elsewhere placed) tree of arrays or
    tensors on ``devices``: one device for every leaf, or a tree of devices
    with ``state``'s structure — the restore path after an elastic
    re-mesh."""
    def place(x, dev):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(torch.device(dev))

    if isinstance(devices, (str, torch.device)):
        return T.tree_map(lambda x: place(x, devices), state)
    return T.tree_map(place, state, devices)


def plan_elastic_remesh(n_devices: int, lost: int, model_axis: int
                        ) -> ElasticPlan:
    """Largest (data, model) mesh on surviving devices, preserving the model
    axis (TP degree is a property of the compiled program; only DP shrinks)."""
    survive = n_devices - lost
    data = survive // model_axis
    if data < 1:
        raise ValueError("not enough devices to keep the model axis")
    return ElasticPlan(n_devices, data * model_axis, (data, model_axis),
                       note=f"dp {n_devices // model_axis}->{data}, tp kept")


def degraded_operation_certificate(n: int, radix: int, alpha: float):
    """The paper's §3 guarantee applied to the surviving alpha-fraction."""
    return ramanujan_placement_guarantee(n, radix, alpha)
