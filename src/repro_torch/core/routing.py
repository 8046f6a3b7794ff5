"""Path-level routing: batched BFS over the padded gather tables (PyTorch port
of the reference module).

The spectral layer bounds diameter and bisection from rho_2; this module
*measures* the path structure those bounds predict, by traversing the graph
on the device.  Everything runs on the (n, k) padded gather-table adjacency
of ``spectral.py`` (rows short of ``k`` edge-neighbors are padded with the
vertex's own index — harmless for reachability, masked out of path counting).

* :func:`bfs_distances` / :func:`shortest_path_counts` — S sources advance
  one frontier per step in one gather each (``reached[:, table]``); path
  counts run the layered pass over the BFS DAG in float64, one spmv per
  layer over the (S, n) block (kernel K1's f64 form on the card).  The
  reference's ``lax.while_loop`` is a Python loop with one host check per
  BFS layer (diameter-many).
* :func:`analyze_routing` — all-sources (or sampled-sources) analysis of one
  :class:`~repro_torch.core.graphs.Topology` → :class:`RoutingResult`.
* :func:`routing_stats_stacked` — per-graph BFS statistics for a
  ``(B, n, k)`` stack of padded tables, the batch written out.

Entry points take ``device=`` (default ``"cuda"``) and return host numpy
arrays, as the reference does.  Units: distances and diameters are in
**hops**; ``seconds`` fields are wall time; histograms count ordered
(source, target) pairs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import spmv as KS

from .graphs import Topology

__all__ = [
    "RoutingResult", "bfs_distances", "shortest_path_counts",
    "analyze_routing", "routing_stats_stacked", "sample_sources",
    "reverse_slot_index", "DEFAULT_SOURCE_CHUNK",
]

Device = Union[str, torch.device, None]

#: sources per BFS/path-count call — bounds the (chunk, n, k) gather
#: intermediate to a few MB at the survey's largest instances.
DEFAULT_SOURCE_CHUNK = 512


# --------------------------------------------------------------------------
# primitives: frontier BFS + layered path counting, batched over sources
# --------------------------------------------------------------------------

def _bfs_dist_chunk(table: torch.Tensor, dist0: torch.Tensor) -> torch.Tensor:
    """Frontier BFS for a (..., S, n) block of sources over (n, k) int64
    ``table`` (or a (B, n, k) stack matching a (B, S, n) block).

    ``dist0`` holds 0 at each row's source and -1 elsewhere; each iteration
    reaches every vertex with a reached neighbor (one gather over the whole
    block) until no row changes — diameter(G)-many iterations, each ending
    in one host check.  Self-padded table entries only ever re-reach the
    vertex itself.
    """
    dist = dist0.clone()
    d = 1
    while True:
        reached = dist >= 0
        if table.dim() == 2:
            nbr = reached[..., table].any(dim=-1)
        else:                                   # (B, n, k) tables, (B, S, n)
            Bt, n, k = table.shape
            S = reached.shape[1]
            idx = table.reshape(Bt, 1, n * k).expand(Bt, S, n * k)
            nbr = torch.gather(reached, 2, idx).reshape(Bt, S, n, k).any(-1)
        newly = nbr & ~reached
        if not bool(newly.any()):
            return dist
        dist = torch.where(newly, torch.full_like(dist, d), dist)
        d += 1


def _sigma_chunk(table: torch.Tensor, dist: torch.Tensor,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Minimal-path counts sigma(s, v) for a (S, n) block of BFS distances.

    Layered DP over the BFS DAG: sigma at layer d is the sum of sigma over
    neighbors at layer d-1 — one spmv per layer over the (S, n) block and
    the shared (n, k) int32 table (K1's f64 batch on the card).  Self-padded
    entries contribute nothing because a vertex is never in the layer
    preceding its own.  Always float64, on every device: float32 counts go
    inexact past 2^24 and int32 overflows past 2^31 — torus(32, 2)'s
    antipodal pairs have 4 * C(32, 16) = 2,404,321,560 minimal paths.
    """
    bk = KS.resolve_backend(backend, dist.device)
    dmax = max(int(dist.max()), 0)
    sigma = (dist == 0).to(torch.float64)
    for d in range(1, dmax + 1):
        prev = torch.where(dist == d - 1, sigma, 0.0)
        contrib = KS.spmv(prev, table, backend=bk)
        sigma = torch.where(dist == d, contrib, sigma)
    return sigma


def _gather_table(topo: Topology) -> np.ndarray:
    tab, _ = topo.gather_operands()
    return tab


def _chunks(S: int, chunk: int):
    for lo in range(0, S, chunk):
        yield lo, min(lo + chunk, S)


def _start_block(srcs: np.ndarray, n: int, dev: torch.device) -> torch.Tensor:
    """(S, n) int32 BFS start block: 0 at each row's source, -1 elsewhere."""
    dist0 = torch.full((srcs.size, n), -1, dtype=torch.int32, device=dev)
    dist0[torch.arange(srcs.size, device=dev),
          torch.as_tensor(srcs, device=dev)] = 0
    return dist0


@obs.traced("routing/bfs", phase="execute")
def bfs_distances(table: np.ndarray, sources: Optional[Sequence[int]] = None,
                  chunk: int = DEFAULT_SOURCE_CHUNK, *,
                  device: Device = DEFAULT_DEVICE) -> np.ndarray:
    """Shortest-path hop distances from each source over a padded table.

    Args:
        table: (n, k) int neighbor table (``Topology.gather_operands()[0]`` —
            self-padded rows are fine).
        sources: vertex ids to run BFS from; default all n (all-pairs).
        chunk: sources per device call (memory knob, result-invariant).
        device: where the BFS runs (default the card).

    Returns:
        (S, n) int32 matrix of hop distances; -1 marks unreachable targets.
    """
    dev = resolve_device(device)
    table = np.asarray(table)
    n = table.shape[0]
    srcs = np.arange(n, dtype=np.int64) if sources is None \
        else np.asarray(list(sources), dtype=np.int64)
    tab = torch.as_tensor(table, dtype=torch.int64, device=dev)
    out = np.empty((srcs.size, n), dtype=np.int32)
    for lo, hi in _chunks(srcs.size, chunk):
        out[lo:hi] = _bfs_dist_chunk(
            tab, _start_block(srcs[lo:hi], n, dev)).cpu().numpy()
    return out


@obs.traced("routing/sigma", phase="execute")
def shortest_path_counts(table: np.ndarray, dist: np.ndarray,
                         chunk: int = DEFAULT_SOURCE_CHUNK,
                         backend: Optional[str] = None, *,
                         device: Device = DEFAULT_DEVICE) -> np.ndarray:
    """Minimal-path counts sigma(s, t) for precomputed BFS distances.

    Args:
        table: (n, k) padded neighbor table (same one ``dist`` came from).
        dist: (S, n) int32 output of :func:`bfs_distances`.
        chunk: sources per device call.
        backend: spmv backend for the layered DP (default: the dispatcher's).
        device: where the DP runs (default the card).

    Returns:
        (S, n) float64 counts of distinct shortest s→t paths (parallel edges
        count as distinct paths); 0 for unreachable targets, 1 on the
        diagonal.  Exact integers up to 2^53.
    """
    dev = resolve_device(device)
    tab = torch.as_tensor(np.asarray(table), dtype=torch.int32, device=dev)
    out = np.empty(dist.shape, dtype=np.float64)
    for lo, hi in _chunks(dist.shape[0], chunk):
        out[lo:hi] = _sigma_chunk(
            tab, torch.as_tensor(dist[lo:hi], device=dev),
            backend=backend).cpu().numpy()
    return out


def reverse_slot_index(table: np.ndarray) -> np.ndarray:
    """Slot index of each directed edge's reverse: ``rev[v, j]`` is the slot
    ``j'`` in row ``u = table[v, j]`` with ``table[u, j'] == v``.

    The padded gather table stores each undirected edge as two directed slots;
    adaptive routing needs the load of the *incoming* link ``u → v`` while
    iterating slots of ``v``, i.e. ``loads[table[v, j], rev[v, j]]``.
    Parallel edges are paired copy-by-copy (the i-th slot of one endpoint
    with the i-th of the other), self-padded slots map to themselves.  Pure
    host-side numpy, O(nk log nk).
    """
    table = np.asarray(table)
    n, k = table.shape
    u = np.repeat(np.arange(n, dtype=np.int64), k)
    v = table.astype(np.int64).ravel()
    slots = np.tile(np.arange(k, dtype=np.int64), n)
    rev = np.empty(n * k, dtype=np.int64)
    pad = u == v
    rev[pad] = slots[pad]
    live = np.flatnonzero(~pad)
    ul, vl, sl = u[live], v[live], slots[live]
    lo, hi = np.minimum(ul, vl), np.maximum(ul, vl)
    # sort into runs per undirected edge {lo, hi}: the low-endpoint copies
    # first (slot-sorted), then the high-endpoint copies — pairing is then a
    # half-rotation within each run
    order = np.lexsort((sl, ul, hi, lo))
    key = lo[order] * n + hi[order]
    m = order.size
    if m:
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        sizes = np.diff(np.r_[starts, m])
        gid = np.cumsum(np.r_[0, key[1:] != key[:-1]])
        start_of, size_of = starts[gid], sizes[gid]
        if np.any(size_of % 2):
            raise ValueError("table is not symmetric: some directed edge "
                             "has no reverse slot")
        rank = np.arange(m) - start_of
        partner = start_of + (rank + size_of // 2) % size_of
        rev[live[order]] = sl[order[partner]]
    return rev.reshape(n, k)


def sample_sources(n: int, s: int, seed: int = 0) -> np.ndarray:
    """``s`` distinct BFS source vertices, uniform without replacement.

    Deterministic in ``(n, s, seed)`` (numpy, the reference's draws);
    returned sorted.  ``s >= n`` degenerates to *all* sources (``arange``),
    which is what makes ``sample_fraction=1.0`` reproduce the exact
    all-sources analysis bit-for-bit.
    """
    if s >= n:
        return np.arange(n, dtype=np.int64)
    if s < 1:
        raise ValueError(f"need at least one source (got s={s})")
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=s, replace=False)).astype(np.int64)


# --------------------------------------------------------------------------
# one-topology analysis
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RoutingResult:
    """Measured path structure of one topology (all units in hops).

    ``dist``/``sigma`` keep the full (S, n) matrices so the traffic layer can
    route demands without re-running BFS.  When ``sources`` is a proper subset
    of the vertices, ``diameter`` is the max eccentricity over that sample —
    a certified *lower* bound on the true diameter (``exact`` is False).
    """
    name: str
    n: int
    sources: np.ndarray            # (S,) vertex ids BFS ran from
    exact: bool                    # True iff sources cover all n vertices
    dist: np.ndarray               # (S, n) int32 hops, -1 = unreachable
    sigma: np.ndarray              # (S, n) float64 minimal-path counts
    diameter: int                  # max finite hops over sampled pairs
    avg_path_length: float         # mean hops over reachable ordered pairs
    hop_histogram: np.ndarray      # (diameter+1,) ordered-pair counts by hops
    unreachable_pairs: int         # ordered pairs with no path (s != t)
    path_diversity_mean: float     # mean sigma over reachable pairs (s != t)
    path_diversity_min: float      # min sigma over reachable pairs (s != t)
    eccentricity: np.ndarray       # (S,) max finite hops per source
    seconds: float                 # wall time of the analysis
    diameter_lb: int = 0           # certified lower bound (== diameter)
    avg_hops_ci: Tuple[float, float] = (0.0, 0.0)  # 95% bootstrap CI
    seed: Optional[int] = None     # source-sampling seed (None = explicit/all)

    def to_dict(self) -> Dict:
        """JSON-ready summary (drops the (S, n) matrices)."""
        return dict(
            name=self.name, n=self.n, sources=int(self.sources.size),
            exact=self.exact, diameter=int(self.diameter),
            diameter_lb=int(self.diameter_lb),
            avg_path_length=round(float(self.avg_path_length), 6),
            avg_hops_ci=[round(float(c), 6) for c in self.avg_hops_ci],
            hop_histogram=self.hop_histogram.tolist(),
            unreachable_pairs=int(self.unreachable_pairs),
            path_diversity_mean=round(float(self.path_diversity_mean), 4),
            path_diversity_min=float(self.path_diversity_min),
            seconds=round(self.seconds, 3))

    def report(self) -> str:
        """Compact text block for CLI reports."""
        kind = "exact (all sources)" if self.exact else \
            f"sampled ({self.sources.size}/{self.n} sources, diameter is a LB)"
        lines = [
            f"routing         : {kind}",
            f"diameter (BFS)  : {self.diameter} hops",
            f"avg path length : {self.avg_path_length:.4f} hops",
            f"path diversity  : mean {self.path_diversity_mean:.2f} / "
            f"min {self.path_diversity_min:.0f} minimal paths per pair",
        ]
        if not self.exact:
            lo, hi = self.avg_hops_ci
            lines.append(f"avg hops 95% CI : [{lo:.4f}, {hi:.4f}] (bootstrap)")
        if self.unreachable_pairs:
            lines.append(f"unreachable     : {self.unreachable_pairs} ordered pairs")
        return "\n".join(lines)


def _bootstrap_avg_hops_ci(dist: np.ndarray, srcs: np.ndarray,
                           seed: Optional[int], bootstrap: int,
                           confidence: float) -> Tuple[float, float]:
    """Percentile bootstrap CI for avg hops, resampling *source rows*.

    Sources are the sampling unit (targets within a row are a census), so the
    bootstrap resamples whole rows with replacement and recomputes the ratio
    estimator sum(hops)/count(reachable) per replicate.  Deterministic in the
    routing seed (numpy, the reference's draws).  Slightly conservative: it
    ignores the variance reduction from drawing sources *without*
    replacement.
    """
    S = dist.shape[0]
    finite = dist >= 0
    offdiag = finite.copy()
    offdiag[np.arange(S), srcs] = False
    row_sum = np.where(offdiag, dist, 0).sum(axis=1).astype(np.float64)
    row_cnt = offdiag.sum(axis=1).astype(np.float64)
    rng = np.random.default_rng((0 if seed is None else seed) + 0x5EED)
    idx = rng.integers(0, S, size=(bootstrap, S))
    sums = row_sum[idx].sum(axis=1)
    cnts = row_cnt[idx].sum(axis=1)
    est = sums / np.maximum(cnts, 1.0)
    alpha = (1.0 - confidence) / 2.0
    return float(np.quantile(est, alpha)), float(np.quantile(est, 1.0 - alpha))


@obs.traced("routing/analyze", phase="execute")
def analyze_routing(topo: Union[Topology, Tuple[np.ndarray, int]],
                    sources: Optional[Sequence[int]] = None,
                    chunk: int = DEFAULT_SOURCE_CHUNK, *,
                    sample_fraction: Optional[float] = None,
                    seed: int = 0,
                    bootstrap: int = 256,
                    confidence: float = 0.95,
                    backend: Optional[str] = None,
                    device: Device = DEFAULT_DEVICE) -> RoutingResult:
    """Path-level analysis of one topology via batched BFS, exact or sampled.

    Args:
        topo: a :class:`Topology`, or a ``(table, n)`` pair of an already-built
            padded gather table (the degraded-operation entry point).
        sources: explicit BFS source vertices; default all n → exact diameter /
            distribution.  Mutually exclusive with ``sample_fraction``.
        chunk: sources per device call (memory knob).
        sample_fraction: if set, BFS runs from ``round(fraction * n)`` sources
            drawn by :func:`sample_sources` with ``seed``.  ``1.0`` selects
            every vertex and reproduces the exact analysis bit-for-bit;
            anything less returns estimates: ``diameter`` becomes the
            certified lower bound ``diameter_lb`` and ``avg_path_length``
            carries the bootstrap ``avg_hops_ci``.
        seed: source-sampling seed (also seeds the bootstrap resampler).
        bootstrap: bootstrap replicates for the CI.
        confidence: CI coverage level (default 95%).
        backend: spmv backend for the sigma DP (default: the dispatcher's).
        device: where BFS and the sigma DP run (default the card).

    Returns:
        :class:`RoutingResult` with distances, path counts, and summary stats.
    """
    t0 = time.time()
    dev = resolve_device(device)
    if isinstance(topo, Topology):
        name, n, table = topo.name, topo.n, _gather_table(topo)
    else:
        table, n = np.asarray(topo[0]), int(topo[1])
        name = f"table(n={n})"
    used_seed: Optional[int] = None
    if sample_fraction is not None:
        if sources is not None:
            raise ValueError("pass either sources= or sample_fraction=, not both")
        if not 0.0 < sample_fraction <= 1.0:
            raise ValueError(f"sample_fraction must be in (0, 1] "
                             f"(got {sample_fraction})")
        srcs = sample_sources(n, max(1, int(round(sample_fraction * n))), seed)
        used_seed = seed
    elif sources is None:
        srcs = np.arange(n, dtype=np.int64)
    else:
        srcs = np.asarray(list(sources), dtype=np.int64)
    obs.count("routing/bfs_sources", int(srcs.size))
    dist = bfs_distances(table, srcs, chunk=chunk, device=dev)
    sigma = shortest_path_counts(table, dist, chunk=chunk, backend=backend,
                                 device=dev)
    finite = dist >= 0
    offdiag = finite.copy()
    offdiag[np.arange(srcs.size), srcs] = False   # drop s == t pairs
    hops = dist[offdiag]
    diameter = int(hops.max()) if hops.size else 0
    hist = np.bincount(hops, minlength=diameter + 1) if hops.size else \
        np.zeros(1, dtype=np.int64)
    div = sigma[offdiag]
    ecc = np.where(finite, dist, -1).max(axis=1)
    exact = bool(srcs.size == n)
    avg = float(hops.mean()) if hops.size else 0.0
    if exact:
        ci = (avg, avg)
    else:
        obs.count("routing/bootstrap_reps", int(bootstrap))
        ci = _bootstrap_avg_hops_ci(dist, srcs, used_seed, bootstrap,
                                    confidence)
    return RoutingResult(
        name=name, n=n, sources=srcs, exact=exact,
        dist=dist, sigma=sigma, diameter=diameter,
        avg_path_length=avg,
        hop_histogram=hist.astype(np.int64),
        unreachable_pairs=int((~finite).sum()),
        path_diversity_mean=float(div.mean()) if div.size else 0.0,
        path_diversity_min=float(div.min()) if div.size else 0.0,
        eccentricity=ecc.astype(np.int64),
        seconds=time.time() - t0,
        diameter_lb=diameter, avg_hops_ci=ci, seed=used_seed)


# --------------------------------------------------------------------------
# degraded-operation path: stats over a (B, n, k) stack of padded tables
# --------------------------------------------------------------------------

def _bfs_dist_stacked(tables: torch.Tensor, dist0: torch.Tensor
                      ) -> torch.Tensor:
    """Frontier BFS of one (S, n) start block over B stacked (B, n, k) int64
    tables → (B, S, n): the reference's ``vmap`` as a batch dimension."""
    B = tables.shape[0]
    return _bfs_dist_chunk(tables, dist0.unsqueeze(0).expand(B, -1, -1))


def routing_stats_stacked(tables: np.ndarray,
                          sources: Optional[Sequence[int]] = None, *,
                          device: Device = DEFAULT_DEVICE) -> List[Dict]:
    """Per-graph BFS statistics for B stacked padded tables in one batched
    BFS on ``device``.

    ``tables`` is the (B, n, k) block of a batch of degraded samples, so a
    fault sweep measures degraded diameters the way it measures degraded
    rho_2 — one device call for all B samples.

    Args:
        tables: (B, n, k) int padded neighbor tables (self-padded rows OK).
        sources: BFS sources shared by every graph; default all n vertices.
        device: where the BFS runs (default the card).

    Returns:
        One dict per graph: ``diameter`` (hops; max over sampled pairs — exact
        when sources cover all vertices and the graph is connected),
        ``avg_path_length`` (hops over reachable ordered pairs),
        ``reachable_frac`` (reachable fraction of sampled ordered s != t
        pairs), ``unreachable_pairs``.
    """
    dev = resolve_device(device)
    tables = np.asarray(tables)
    B, n, _ = tables.shape
    srcs = np.arange(n, dtype=np.int64) if sources is None \
        else np.asarray(list(sources), dtype=np.int64)
    dist = _bfs_dist_stacked(
        torch.as_tensor(tables, dtype=torch.int64, device=dev),
        _start_block(srcs, n, dev)).cpu().numpy()
    out = []
    for b in range(B):
        d = dist[b]
        finite = d >= 0
        offdiag = finite.copy()
        offdiag[np.arange(srcs.size), srcs] = False
        hops = d[offdiag]
        pairs = srcs.size * (n - 1)
        out.append(dict(
            diameter=int(hops.max()) if hops.size else 0,
            avg_path_length=float(hops.mean()) if hops.size else 0.0,
            reachable_frac=float(hops.size / pairs) if pairs else 1.0,
            unreachable_pairs=int(pairs - hops.size),
        ))
    return out
