"""repro_torch.core — topologies, their bounds and spectra, lifts and the
Reduction Lemma, topology synthesis, path-level routing and traffic under
every routing scheme, the collective cost model, the link-level simulator,
training-workload lowering, fault sweeps and placement guarantees (PyTorch
port).
"""
from . import (bounds, collectives, faults, graphs, lifts, placement,
               properties, ramanujan, reduction, routing, simulate, spectral,
               topologies, traffic, workloads)
from .graphs import Topology

__all__ = ["Topology", "bounds", "collectives", "faults", "graphs", "lifts",
           "placement", "properties", "ramanujan", "reduction", "routing",
           "simulate", "spectral", "topologies", "traffic", "workloads"]
