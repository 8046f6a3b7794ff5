"""repro_torch.core — topologies, their bounds and spectra, lifts and the
Reduction Lemma, topology synthesis, and path-level routing / minimal-ECMP
traffic (PyTorch port).

Not ported yet: the reference's faults, collectives, placement, simulate and
workloads modules, and the non-minimal routing schemes of traffic.
"""
from . import (bounds, graphs, lifts, properties, ramanujan, reduction,
               routing, spectral, topologies, traffic)
from .graphs import Topology

__all__ = ["Topology", "bounds", "graphs", "lifts", "properties", "ramanujan",
           "reduction", "routing", "spectral", "topologies", "traffic"]
