"""repro_torch.core — topologies, their bounds and spectra (PyTorch port).

Only the modules of the main path are ported: graphs, bounds, topologies,
ramanujan, properties and spectral.
"""
from . import bounds, graphs, properties, ramanujan, spectral, topologies
from .graphs import Topology

__all__ = ["Topology", "bounds", "graphs", "properties", "ramanujan",
           "spectral", "topologies"]
