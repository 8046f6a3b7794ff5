"""Exact / witnessed structural properties: diameter, bisection cuts, e(X,Y).

The spectral *bounds* live in bounds.py; these are the combinatorial quantities
they bound, computed exactly (BFS) or witnessed (Fiedler sweep cuts give an
upper-bound bisection; Fiedler's theorem gives the lower bound).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .graphs import Topology
from .spectral import fiedler_vector

__all__ = ["diameter", "eccentricity", "bisection_witness", "bisection_fiedler"]


def eccentricity(topo: Topology, source: int = 0) -> int:
    """Max BFS distance from ``source`` (equals diameter for vertex-transitive G)."""
    n = topo.n
    dist = np.full(n, -1, dtype=np.int64)
    dist[source] = 0
    frontier = np.array([source])
    d = 0
    # CSR-ish adjacency for fast BFS
    order = np.argsort(topo.edges[:, 0], kind="stable")
    e_fwd = topo.edges[order]
    order2 = np.argsort(topo.edges[:, 1], kind="stable")
    e_bwd = topo.edges[order2][:, ::-1]
    alle = np.concatenate([e_fwd, e_bwd], axis=0)
    order3 = np.argsort(alle[:, 0], kind="stable")
    alle = alle[order3]
    starts = np.searchsorted(alle[:, 0], np.arange(n + 1))
    while frontier.size:
        d += 1
        nbrs = np.concatenate([alle[starts[u]:starts[u + 1], 1] for u in frontier]) \
            if frontier.size else np.array([], dtype=np.int64)
        nbrs = np.unique(nbrs)
        new = nbrs[dist[nbrs] < 0]
        if new.size == 0:
            break
        dist[new] = d
        frontier = new
    if np.any(dist < 0):
        raise ValueError("graph is disconnected")
    return int(dist.max())


def diameter(topo: Topology, vertex_transitive: Optional[bool] = None,
             sample: int = 16, seed: int = 0) -> int:
    """Exact diameter for small n; for vertex-transitive topologies a single
    eccentricity suffices; otherwise max over sampled sources (lower bound,
    flagged in meta)."""
    if vertex_transitive:
        return eccentricity(topo, 0)
    if topo.n <= 20000:
        rng = np.random.default_rng(seed)
        if topo.n <= 2000:
            sources = range(topo.n)
        else:
            sources = rng.choice(topo.n, size=min(sample * 8, topo.n), replace=False)
        return max(eccentricity(topo, int(s)) for s in sources)
    rng = np.random.default_rng(seed)
    sources = rng.choice(topo.n, size=sample, replace=False)
    return max(eccentricity(topo, int(s)) for s in sources)


def bisection_witness(topo: Topology, X_mask: np.ndarray) -> float:
    """Edges crossing the cut (X, ~X)."""
    u, v = topo.edges[:, 0], topo.edges[:, 1]
    return float(np.sum(X_mask[u] != X_mask[v]))


def bisection_fiedler(topo: Topology) -> Tuple[float, np.ndarray]:
    """Balanced sweep cut along the Fiedler vector: a certified *upper bound*
    on the bisection bandwidth (it is an actual bisection)."""
    f = fiedler_vector(topo)
    order = np.argsort(f, kind="stable")
    mask = np.zeros(topo.n, dtype=bool)
    mask[order[: topo.n // 2]] = True
    return bisection_witness(topo, mask), mask
