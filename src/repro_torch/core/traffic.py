"""Synthetic traffic patterns + minimal-routing (ECMP) link-load accounting
(PyTorch port of the reference module, the ``minimal`` scheme).

The routing layer (:mod:`repro_torch.core.routing`) measures where shortest
paths *are*; this module loads them.  Each traffic pattern is a demand
matrix ``D[s, t]`` normalized so every node injects at most 1 unit of
traffic (``sum_t D[s, t] <= 1``).  The ``minimal`` scheme routes over all
minimal paths with equal weight per path (ECMP, the SpectralFly evaluation
model): the flow from s to t crossing edge (u, v) on a shortest-path DAG is
``D[s,t] * sigma(s,u) * sigma(v,t) / sigma(s,t)``, computed by a
Brandes-style backward accumulation over BFS layers — one spmv per layer
over a (chunk, n) block of sources, in float64 on every device (kernel K1's
f64 form on the card; the reference casts sigma and the demands to float32
at this call, the port keeps float64 throughout).

The reference's other schemes (``valiant``, ``ugal``, ``ksp``) and its
multi-commodity-flow ceiling :func:`mcf_throughput_ub` are not ported yet
(ROADMAP Queue 1 item 8): they raise ``NotImplementedError``.

Units
-----
* demands and link loads are in *injection units*: load 1.0 on a directed
  link means it carries exactly one node's full injection rate;
* ``saturation_throughput`` = 1 / max link load (unit link capacity);
* conservation: the sum of all directed link loads equals
  ``sum_{s,t} D[s,t] * hops(s,t)`` exactly.

Patterns (:data:`TRAFFIC_PATTERNS`)
-----------------------------------
* ``uniform``        — all-to-all, ``D[s, t] = 1/(n-1)``
* ``bit_complement`` — permutation ``t = (n-1) - s``
* ``transpose``      — permutation ``(a, b) → (b, a)`` for n = m*m; raises
  for non-square n
* ``neighbor``       — half a unit to each of ``s ± 1 (mod n)``
* ``adversarial``    — vertices sorted by Fiedler value are matched
  first-to-last, forcing every flow across the Fiedler cut
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import spmv as KS

from .graphs import Topology
from .routing import DEFAULT_SOURCE_CHUNK, RoutingResult, analyze_routing

__all__ = [
    "TRAFFIC_PATTERNS", "ROUTING_SCHEMES", "TrafficResult", "demand_matrix",
    "demand_rows", "ecmp_link_loads", "scheme_link_loads",
    "mcf_throughput_ub", "evaluate_traffic", "spectral_throughput_estimate",
]

Device = Union[str, torch.device, None]

TRAFFIC_PATTERNS = ("uniform", "bit_complement", "transpose", "neighbor",
                    "adversarial")

#: the reference's routing schemes; only ``minimal`` is ported
ROUTING_SCHEMES = ("minimal", "valiant", "ugal", "ksp")

#: bytes of the per-source (sources, n, k) float64 load intermediate one
#: ECMP device call may hold; the source chunk shrinks to fit (result-
#: invariant up to float64 summation order)
ECMP_TILE_BYTES = 256 << 20


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item 8: "
        "Valiant, UGAL, KSP and the MCF ceiling)")


def _check_scheme(scheme: str) -> None:
    """ValueError for an unknown scheme, NotImplementedError for the
    reference's schemes that are not ported."""
    if scheme not in ROUTING_SCHEMES:
        raise ValueError(f"unknown routing scheme {scheme!r} "
                         f"(known: {ROUTING_SCHEMES})")
    if scheme != "minimal":
        raise _not_ported(f"routing scheme {scheme!r}")


# --------------------------------------------------------------------------
# demand matrices
# --------------------------------------------------------------------------

def _permutation_demands(perm: np.ndarray) -> np.ndarray:
    """Demand matrix of a permutation: one unit from s to perm[s] (fixed
    points send nothing — a node never loads the network talking to itself)."""
    n = perm.size
    D = np.zeros((n, n))
    s = np.arange(n)
    keep = perm != s
    D[s[keep], perm[keep]] = 1.0
    return D


def _pattern_permutation(pattern: str, n: int, *,
                         fiedler: Optional[np.ndarray] = None) -> np.ndarray:
    """The permutation behind a permutation-type pattern (O(n log n), no
    (n, n) matrix — the scalable core shared by matrix and row builders)."""
    if pattern == "bit_complement":
        return n - 1 - np.arange(n)
    if pattern == "transpose":
        m = math.isqrt(n)
        if m * m != n:
            raise ValueError(f"transpose traffic needs square n, got {n}")
        s = np.arange(n)
        return (s % m) * m + s // m
    if pattern == "adversarial":
        if fiedler is None:
            raise ValueError("adversarial traffic needs the Fiedler vector")
        f = np.asarray(fiedler, dtype=np.float64)
        # Canonicalize before pairing: on degenerate Fiedler eigenspaces the
        # raw eigenvector differs across eigensolver paths / BLAS builds, and
        # argsort ties make the permutation (hence thpt_adversarial) drift.
        # Quantizing to 6 decimals of the max-normalized vector collapses
        # cross-backend jitter (~1e-13) into identical keys; the index
        # tie-break then makes the ordering fully deterministic, and the
        # leading-sign flip removes the eigenvector's sign ambiguity.
        amax = np.max(np.abs(f)) if f.size else 0.0
        q = np.round(f / amax, 6) if amax > 0 else np.zeros_like(f)
        nz = np.flatnonzero(q)
        if nz.size and q[nz[0]] < 0:
            q = -q
        order = np.lexsort((np.arange(n), q))
        perm = np.empty(n, dtype=np.int64)
        perm[order] = order[::-1]
        return perm
    raise ValueError(f"unknown traffic pattern {pattern!r} "
                     f"(known: {TRAFFIC_PATTERNS})")


def demand_rows(pattern: str, n: int, sources: Sequence[int], *,
                fiedler: Optional[np.ndarray] = None) -> np.ndarray:
    """The ``sources`` rows of :func:`demand_matrix` without materializing it.

    This is the datacenter-scale entry point: an (n, n) float64 demand matrix
    at n = 65536 is 32 GiB, but a sampled traffic evaluation only ever routes
    the S sampled source rows.  Row order follows ``sources``.  Exactly equal
    to ``demand_matrix(pattern, n)[sources]`` (tested), so the sampled path
    inherits every pattern's semantics.
    """
    srcs = np.asarray(list(sources), dtype=np.int64)
    S = srcs.size
    rows = np.arange(S)
    if pattern == "uniform":
        if n < 2:
            raise ValueError("uniform traffic needs n >= 2")
        D = np.full((S, n), 1.0 / (n - 1))
        D[rows, srcs] = 0.0
        return D
    if pattern == "neighbor":
        D = np.zeros((S, n))
        np.add.at(D, (rows, (srcs + 1) % n), 0.5)
        np.add.at(D, (rows, (srcs - 1) % n), 0.5)
        D[rows, srcs] = 0.0
        return D
    perm = _pattern_permutation(pattern, n, fiedler=fiedler)
    D = np.zeros((S, n))
    keep = perm[srcs] != srcs
    D[rows[keep], perm[srcs[keep]]] = 1.0
    return D


def demand_matrix(pattern: str, n: int, *,
                  fiedler: Optional[np.ndarray] = None) -> np.ndarray:
    """Build the (n, n) demand matrix of a named synthetic pattern.

    Args:
        pattern: one of :data:`TRAFFIC_PATTERNS`.
        n: number of nodes.
        fiedler: (n,) Fiedler vector, required by ``adversarial`` (it defines
            the cut the permutation stresses).

    Returns:
        (n, n) float64 demands in injection units; row sums are <= 1 and the
        diagonal is 0.
    """
    if pattern == "uniform":
        if n < 2:
            raise ValueError("uniform traffic needs n >= 2")
        D = np.full((n, n), 1.0 / (n - 1))
        np.fill_diagonal(D, 0.0)
        return D
    if pattern == "neighbor":
        D = np.zeros((n, n))
        s = np.arange(n)
        D[s, (s + 1) % n] += 0.5
        D[s, (s - 1) % n] += 0.5
        np.fill_diagonal(D, 0.0)   # n <= 2 degenerates to self-traffic
        return D
    return _permutation_demands(_pattern_permutation(pattern, n,
                                                     fiedler=fiedler))


# --------------------------------------------------------------------------
# ECMP link loads (Brandes-style backward accumulation, batched over sources)
# --------------------------------------------------------------------------

def _source_tile(chunk: int, n: int, k: int) -> int:
    """Sources per ECMP device call: ``chunk``, capped so the per-source
    (sources, n, k) float64 intermediate fits :data:`ECMP_TILE_BYTES`."""
    return max(1, min(chunk, ECMP_TILE_BYTES // max(8 * n * k, 1)))


def _ecmp_source_loads(table: torch.Tensor, dist: torch.Tensor,
                       sigma: torch.Tensor, w: torch.Tensor,
                       backend: Optional[str]) -> torch.Tensor:
    """Per-source ECMP loads (S, n, k) for a (S, n) block of sources.

    Backward accumulation over BFS layers d = dmax..1 of
    ``g(v) = w(v) + sigma(v) * sum_{v' in succ(v)} g(v')/sigma(v')`` (the
    demand subtree routed through v) — the per-layer neighbor sum is one
    spmv over the (S, n) block and the shared (n, k) int32 table — then the
    per-slot directed loads ``load[u, j] = sigma(u) * g(v)/sigma(v)`` for
    ``v = table[u, j]`` one hop further out.  Self-padded slots have equal
    dist and drop out of the mask.  Float64 throughout.
    """
    bk = KS.resolve_backend(backend, dist.device)
    dmax = max(int(dist.max()), 0)
    sigma_safe = torch.where(sigma > 0, sigma, 1.0)
    g = w
    for d in range(dmax, 0, -1):
        h = torch.where(dist == d, g / sigma_safe, 0.0)
        inc = KS.spmv(h, table, backend=bk)
        g = torch.where(dist == d - 1, g + sigma * inc, g)
    ratio = torch.where(dist > 0, g / sigma_safe, 0.0)
    tl = table.long()
    succ = dist[:, tl] == (dist[:, :, None] + 1)
    return sigma[:, :, None] * torch.where(succ, ratio[:, tl], 0.0)


def _ecmp_loads_chunk(table: torch.Tensor, dist: torch.Tensor,
                      sigma: torch.Tensor, w: torch.Tensor,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Summed per-edge ECMP loads (n, k) for a (S, n) block of sources."""
    return _ecmp_source_loads(table, dist, sigma, w, backend).sum(dim=0)


def _block(dist: np.ndarray, sigma: np.ndarray, demands: np.ndarray,
           lo: int, hi: int, dev: torch.device) -> tuple:
    """One source block's (dist, sigma, demands) on ``dev``; float64."""
    return (torch.as_tensor(dist[lo:hi], device=dev),
            torch.as_tensor(sigma[lo:hi], dtype=torch.float64, device=dev),
            torch.as_tensor(demands[lo:hi], dtype=torch.float64, device=dev))


@obs.traced("traffic/ecmp", phase="execute")
def ecmp_link_loads(table: np.ndarray, dist: np.ndarray, sigma: np.ndarray,
                    demands: np.ndarray,
                    chunk: int = DEFAULT_SOURCE_CHUNK,
                    backend: Optional[str] = None, *,
                    device: Device = DEFAULT_DEVICE) -> np.ndarray:
    """Directed link loads under minimal-path ECMP routing of ``demands``.

    Args:
        table: (n, k) padded neighbor table (``gather_operands()[0]``).
        dist: (S, n) BFS distances from
            :func:`repro_torch.core.routing.bfs_distances`.
        sigma: (S, n) minimal-path counts matching ``dist``.
        demands: (S, n) demand rows in injection units, one per BFS source
            (row s holds D[s, :]).  Demands to unreachable targets are ignored
            (dropped, reported by :func:`evaluate_traffic`).
        chunk: sources per device call (capped by :data:`ECMP_TILE_BYTES`).
        backend: spmv backend for the accumulation (default: the
            dispatcher's).
        device: where the accumulation runs (default the card).

    Returns:
        (n, k) float64 directed loads aligned with the table slots: entry
        ``[u, j]`` is the load on directed link u → table[u, j] (padding slots
        stay 0; parallel edges each get their ECMP share).
    """
    dev = resolve_device(device)
    table = np.asarray(table)
    n, k = table.shape
    tab = torch.as_tensor(table, dtype=torch.int32, device=dev)
    # a demand to an unreachable target would otherwise sit in g forever
    demands = np.where(dist >= 0, demands, 0.0)
    loads = torch.zeros((n, k), dtype=torch.float64, device=dev)
    inner = _source_tile(chunk, n, k)
    for lo in range(0, dist.shape[0], inner):
        hi = min(lo + inner, dist.shape[0])
        loads += _ecmp_loads_chunk(tab, *_block(dist, sigma, demands, lo, hi,
                                                dev), backend=backend)
    return loads.cpu().numpy()


def _ecmp_loads_cand_chunk(table: torch.Tensor, dist: torch.Tensor,
                           sigma: torch.Tensor, w: torch.Tensor,
                           cand: torch.Tensor,
                           backend: Optional[str] = None) -> torch.Tensor:
    """*Per-source* ECMP loads at M candidate flat slots — (S, M).

    Same backward accumulation as :func:`_ecmp_loads_chunk`, but it gathers
    each source's contribution to the M candidate ``(u, j)`` slots (flat
    indices into the (n, k) load table) instead of summing over the block:
    the second pass of the sampled max-load bootstrap.
    """
    full = _ecmp_source_loads(table, dist, sigma, w, backend)
    return full.reshape(full.shape[0], -1)[:, cand]


@obs.traced("traffic/ucb", phase="execute")
def _max_link_load_ucb(table: np.ndarray, routing: RoutingResult,
                       served: np.ndarray, loads_scaled: np.ndarray, *,
                       chunk: int, backend: Optional[str],
                       bootstrap: int = 200, confidence: float = 0.95,
                       candidates: int = 256,
                       device: Device = DEFAULT_DEVICE) -> float:
    """One-sided bootstrap upper confidence bound for the full-census max
    directed-link load under sampled-source routing.

    The n/S correction is unbiased per-slot, but ``max`` over slots of an
    estimate is biased low.  This reruns the load accumulation restricted to
    the ``candidates`` hottest slots of the point estimate, keeping
    *per-source* contributions, then bootstrap-resamples source rows (numpy,
    the reference's draws) and takes the ``confidence`` quantile of the
    replicate maxima.  Links outside the candidate set are invisible to the
    bound.
    """
    dev = resolve_device(device)
    n, k = table.shape
    S = routing.dist.shape[0]
    flat = loads_scaled.ravel()
    M = int(min(candidates, flat.size))
    cand = np.argsort(flat)[-M:]
    tab = torch.as_tensor(table, dtype=torch.int32, device=dev)
    cand_t = torch.as_tensor(cand, dtype=torch.int64, device=dev)
    demands = np.where(routing.dist >= 0, served, 0.0)
    inner = _source_tile(chunk, n, k)
    C = np.zeros((S, M), dtype=np.float64)
    for lo in range(0, S, inner):
        hi = min(lo + inner, S)
        C[lo:hi] = _ecmp_loads_cand_chunk(
            tab, *_block(routing.dist, routing.sigma, demands, lo, hi, dev),
            cand_t, backend=backend).cpu().numpy()
    rng = np.random.default_rng((routing.seed or 0) + 0x10AD)
    idx = rng.integers(0, S, size=(bootstrap, S))
    rep_max = (n / S) * C[idx].sum(axis=1).max(axis=1)
    ucb = float(np.quantile(rep_max, confidence))
    return max(ucb, float(loads_scaled.max()))


def scheme_link_loads(table: np.ndarray, routing: RoutingResult,
                      served: np.ndarray, scheme: str = "minimal", *,
                      chunk: int = DEFAULT_SOURCE_CHUNK,
                      backend: Optional[str] = None,
                      device: Device = DEFAULT_DEVICE
                      ) -> Tuple[np.ndarray, float, int]:
    """Route served demand rows under one of :data:`ROUTING_SCHEMES` (only
    ``minimal`` is ported; the others raise ``NotImplementedError``).

    ``served`` is (S, n) demand rows aligned with ``routing.sources``
    (diagonal zeroed, unreachable targets dropped).  Returns ``(loads,
    hops_weighted, max_hops)``: (n, k) float64 directed slot loads *before*
    any n/S sampling correction, the demand-weighted hop total (equals the
    load sum — conservation), and the worst per-flow hop count.
    """
    _check_scheme(scheme)
    table = np.asarray(table)
    dist = routing.dist
    loads = ecmp_link_loads(table, dist, routing.sigma, served,
                            chunk=chunk, backend=backend, device=device)
    reach = dist >= 0
    dpos = np.where(reach, dist, 0)
    sm = np.where(reach, served, 0.0)
    hops = float((sm * dpos).sum())
    mh = int(dpos[sm > 0].max()) if bool((sm > 0).any()) else 0
    return loads, hops, mh


def mcf_throughput_ub(topo: Union[Topology, Tuple[np.ndarray, int]],
                      pattern: str = "uniform", *,
                      fiedler: Optional[np.ndarray] = None,
                      demands: Optional[np.ndarray] = None,
                      groups: Optional[int] = None) -> float:
    """The reference's multi-commodity-flow LP throughput ceiling — not
    ported yet; raises ``NotImplementedError``."""
    raise _not_ported("mcf_throughput_ub")


# --------------------------------------------------------------------------
# evaluation driver
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TrafficResult:
    """Link-load accounting of one pattern on one topology.

    ``max_link_load``/``mean_link_load`` are per *directed* link in injection
    units (each undirected edge is two directed links, loaded independently);
    ``saturation_throughput`` = 1/max load; ``conservation_error`` is the
    relative gap between the load sum and the demand-weighted hop count
    (float64-roundoff small in the port).
    """
    name: str
    pattern: str
    n: int
    total_demand: float            # injection units offered (reachable pairs)
    dropped_demand: float          # injection units to unreachable targets
    avg_hops: float                # demand-weighted mean shortest-path hops
    link_loads: np.ndarray         # (n, k) directed loads (gather-table slots)
    max_link_load: float
    mean_link_load: float          # over loaded (non-padding) directed slots
    saturation_throughput: float   # 1 / max_link_load (inf if no load)
    conservation_error: float
    seconds: float
    exact: bool = True             # False = sampled-source estimate
    sample_correction: float = 1.0  # n/S factor applied to loads and totals
    scheme: str = "minimal"        # routing scheme the loads were routed by
    max_link_load_ucb: float = 0.0  # bootstrap UCB (== max when exact)

    def to_dict(self) -> Dict:
        """JSON-ready summary (drops the (n, k) load table)."""
        return dict(
            name=self.name, pattern=self.pattern, scheme=self.scheme,
            n=self.n, exact=self.exact,
            total_demand=round(self.total_demand, 6),
            dropped_demand=round(self.dropped_demand, 6),
            avg_hops=round(self.avg_hops, 6),
            max_link_load=round(self.max_link_load, 6),
            max_link_load_ucb=round(self.max_link_load_ucb, 6),
            mean_link_load=round(self.mean_link_load, 6),
            saturation_throughput=round(self.saturation_throughput, 6),
            conservation_error=self.conservation_error,
            seconds=round(self.seconds, 3))

    def report(self) -> str:
        """Compact text block for CLI reports."""
        return "\n".join([
            f"traffic         : {self.pattern} via {self.scheme} "
            f"({self.total_demand:.1f} units offered, "
            f"{self.avg_hops:.3f} avg hops)",
            f"max link load   : {self.max_link_load:.4f} "
            f"(mean {self.mean_link_load:.4f}) injection units",
            f"saturation thpt : {self.saturation_throughput:.4f} "
            f"injection fraction/node",
        ])


@obs.traced("traffic/evaluate", phase="execute")
def evaluate_traffic(topo: Union[Topology, Tuple[np.ndarray, int]],
                     pattern: str = "uniform", *,
                     scheme: str = "minimal",
                     routing: Optional[RoutingResult] = None,
                     fiedler: Optional[np.ndarray] = None,
                     demands: Optional[np.ndarray] = None,
                     chunk: int = DEFAULT_SOURCE_CHUNK,
                     backend: Optional[str] = None,
                     device: Device = DEFAULT_DEVICE) -> TrafficResult:
    """Route one synthetic pattern over a topology and account link loads.

    Args:
        topo: a :class:`Topology` or ``(table, n)`` padded-table pair.
        pattern: name from :data:`TRAFFIC_PATTERNS` (ignored when ``demands``
            is given, which then also names the result's pattern ``custom``).
        scheme: routing scheme; only ``minimal`` (ECMP) is ported, the
            reference's others raise ``NotImplementedError``.
        routing: reuse a :class:`RoutingResult` (e.g. the one a lazy Analysis
            session already computed); computed here if absent.  A *sampled*
            routing result (``exact=False``) is accepted: only its S source
            rows are routed and every extensive figure (loads, totals) is
            scaled by the unbiasedness correction n/S.  ``max_link_load`` is
            then a noisy order statistic (biased low), so a bootstrap upper
            confidence bound ``max_link_load_ucb`` is computed over
            candidate hot slots and ``saturation_throughput`` uses *it*.
        fiedler: Fiedler vector for the ``adversarial`` pattern.
        demands: explicit (n, n) demand matrix in injection units, overriding
            ``pattern`` (sampled routing uses its S source rows).
        chunk: sources per device call.
        backend: spmv backend for the load accumulation (default: the
            dispatcher's).
        device: where routing and the accumulation run (default the card).

    Returns:
        :class:`TrafficResult` with per-directed-link loads and the
        max-load / saturation-throughput summary.
    """
    t0 = time.time()
    _check_scheme(scheme)
    dev = resolve_device(device)
    if isinstance(topo, Topology):
        name, n = topo.name, topo.n
        table = topo.gather_operands()[0]
    else:
        table, n = np.asarray(topo[0]), int(topo[1])
        name = f"table(n={n})"
    if routing is None:
        routing = analyze_routing((table, n), chunk=chunk, device=dev)
    srcs = routing.sources
    S = srcs.size
    scale = 1.0 if routing.exact else n / S
    if demands is None:
        D = demand_rows(pattern, n, srcs, fiedler=fiedler)
    else:
        D = np.asarray(demands, dtype=np.float64)
        if D.shape != (n, n):
            raise ValueError(f"demands must be ({n}, {n}), got {D.shape}")
        D = D[srcs]
        pattern = "custom"
    reachable = routing.dist >= 0
    served = np.where(reachable, D, 0.0)
    served[np.arange(S), srcs] = 0.0
    total = float(served.sum())
    dropped = float(D.sum() - D[np.arange(S), srcs].sum() - total)
    loads, hops_weighted, _ = scheme_link_loads(
        table, routing, served, scheme, chunk=chunk,
        backend=backend, device=dev)
    load_sum = float(loads.sum())
    # conservation holds per source row, so check it *before* the n/S scale
    conservation = abs(load_sum - hops_weighted) / max(hops_weighted, 1e-12)
    loads = loads * scale
    max_load = float(loads.max()) if loads.size else 0.0
    ucb = max_load
    if not routing.exact and max_load > 0:
        ucb = _max_link_load_ucb(table, routing, served, loads,
                                 chunk=chunk, backend=backend, device=dev)
    sat_denom = max_load if routing.exact else ucb
    loaded = loads[loads > 0]
    return TrafficResult(
        name=name, pattern=pattern, n=n, total_demand=total * scale,
        dropped_demand=dropped * scale,
        avg_hops=hops_weighted / total if total > 0 else 0.0,
        link_loads=loads, max_link_load=max_load,
        mean_link_load=float(loaded.mean()) if loaded.size else 0.0,
        saturation_throughput=1.0 / sat_denom if sat_denom > 0
        else float("inf"),
        conservation_error=conservation,
        seconds=time.time() - t0,
        exact=routing.exact, sample_correction=scale,
        scheme=scheme, max_link_load_ucb=ucb)


def spectral_throughput_estimate(n: int, rho2: float) -> float:
    """Uniform-traffic saturation throughput predicted from the spectral gap.

    Uniform all-to-all pushes ``|X| * |Y| / (n-1)`` injection units across any
    (X, Y) cut per direction; supporting that over the Fiedler bisection floor
    (Theorem 2, ``rho2 * n / 4`` links at unit capacity) needs
    ``theta = BW * (n-1) / (n/2)^2 ≈ rho2`` — the spectral prediction the
    measured ECMP figure is compared against.  Deliberately uncapped, exactly
    like :attr:`TrafficResult.saturation_throughput` (both can exceed 1: a
    node injects over all ``radix`` links at once).  Dimensionless, same
    units as the measured figure.
    """
    lo, hi = n // 2, n - n // 2
    bw = rho2 * n / 4.0
    return bw * (n - 1) / float(lo * hi)
