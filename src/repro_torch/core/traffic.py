"""Synthetic traffic patterns + routing-scheme link-load accounting
(PyTorch port of the reference module).

The routing layer (:mod:`repro_torch.core.routing`) measures where shortest
paths *are*; this module loads them.  Each traffic pattern is a demand
matrix ``D[s, t]`` normalized so every node injects at most 1 unit of
traffic (``sum_t D[s, t] <= 1``).  Four routing schemes
(:data:`ROUTING_SCHEMES`) turn demands into directed link loads:

* ``minimal`` — all minimal paths, equal weight per path (ECMP, the
  SpectralFly evaluation model): the flow from s to t crossing edge (u, v)
  on a shortest-path DAG is ``D[s,t] * sigma(s,u) * sigma(v,t) / sigma(s,t)``,
  computed by a Brandes-style backward accumulation over BFS layers — one
  spmv per layer over a (chunk, n) block of sources, in float64 on every
  device (kernel K1's f64 form on the card; the reference casts sigma and
  the demands to float32 at this call, the port keeps float64 throughout);
* ``valiant`` — Valiant load balancing: every unit s → t detours through a
  uniformly random intermediate w (two minimal-ECMP legs s → w, w → t),
  evaluated in expectation over all intermediates;
* ``ugal`` — UGAL-style adaptive selection: each pair routes minimally
  unless the estimated minimal-channel load exceeds the Valiant
  alternative's (``d_min * q_min > h_val * q_val``), in which case it
  diverts to Valiant; the peak load on a pair's minimal DAG is a layered
  gather-and-max over the table on the device;
* ``ksp`` — k-shortest-path non-minimal ECMP: equal splitting over every
  path of length at most ``dist(s, t) + slack`` (a float64 walk-count DP,
  one signed spmv per length layer: K1's f64 signed batch on the card).

:func:`mcf_throughput_ub` bounds all of them from above with a
multi-commodity-flow LP on the directed link-capacity polytope (scipy
linprog on the host; optional dependency).

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
from .routing import (DEFAULT_SOURCE_CHUNK, RoutingResult, analyze_routing,
                      reverse_slot_index)

try:                                   # optional: only the MCF LP bound
    from scipy import sparse as _scipy_sparse
    from scipy.optimize import linprog as _scipy_linprog
except ImportError:                    # pragma: no cover - scipy-less hosts
    _scipy_sparse = None
    _scipy_linprog = None

__all__ = [
    "TRAFFIC_PATTERNS", "ROUTING_SCHEMES", "TrafficResult", "demand_matrix",
    "demand_rows", "ecmp_link_loads", "scheme_link_loads",
    "valiant_link_loads", "ugal_link_loads", "ksp_link_loads",
    "mcf_throughput_ub", "evaluate_traffic", "spectral_throughput_estimate",
]

Device = Union[str, torch.device, None]

TRAFFIC_PATTERNS = ("uniform", "bit_complement", "transpose", "neighbor",
                    "adversarial")

#: routing schemes understood by :func:`evaluate_traffic` /
#: :func:`scheme_link_loads` (and, through them, the simulator's schedule
#: compiler and the survey's thpt_* columns).
ROUTING_SCHEMES = ("minimal", "valiant", "ugal", "ksp")

#: bytes of the per-source working set one ECMP / UGAL / KSP device call
#: may hold (the (sources, n, k) load intermediate; for KSP also the walk
#: stack, the reference's budget); the source chunk shrinks to fit
#: (result-invariant up to float64 summation order)
ECMP_TILE_BYTES = 256 << 20


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


# --------------------------------------------------------------------------
# non-minimal & adaptive schemes: Valiant, UGAL, k-shortest-path ECMP
# --------------------------------------------------------------------------

def _hops_summary(dist: np.ndarray, served: np.ndarray) -> Tuple[float, int]:
    """(demand-weighted hop total, worst served hop count) of demand rows
    routed along shortest paths."""
    reach = dist >= 0
    dpos = np.where(reach, dist, 0)
    sm = np.where(reach, served, 0.0)
    mh = int(dpos[sm > 0].max()) if bool((sm > 0).any()) else 0
    return float((sm * dpos).sum()), mh


def valiant_link_loads(table: np.ndarray, routing: RoutingResult,
                       served: np.ndarray, *,
                       chunk: int = DEFAULT_SOURCE_CHUNK,
                       backend: Optional[str] = None,
                       device: Device = DEFAULT_DEVICE
                       ) -> Tuple[np.ndarray, float, int]:
    """Valiant load balancing in expectation over all intermediates.

    Every unit s → t is routed s → w → t for a uniformly random intermediate
    w, each leg minimal-ECMP.  Rather than sampling w, both legs are routed
    in expectation: leg 1 sends ``out(s)/n`` from s to every w; leg 2 sends
    ``in(t)/S`` from every *sampled* source row (the intermediate pool under
    sampling — all n rows when exact, so both legs reduce to the exact
    ``/n`` split) to every t.  The caller's single n/S correction then makes
    both legs unbiased estimators of the full-census Valiant loads.

    Returns ``(loads (n, k) float64 — unscaled, hops_weighted, max_hops)``
    where ``hops_weighted`` counts both legs (conservation: equals the load
    sum) and ``max_hops`` = worst leg-1 distance + worst leg-2 distance (the
    simulator's round-latency bound).
    """
    dist = routing.dist
    S, n = served.shape
    out_s = served.sum(axis=1)
    in_t = served.sum(axis=0)
    D1 = np.broadcast_to(out_s[:, None] / n, (S, n)).copy()
    D2 = np.broadcast_to(in_t[None, :] / S, (S, n)).copy()
    loads = ecmp_link_loads(table, dist, routing.sigma, D1, chunk=chunk,
                            backend=backend, device=device)
    loads += ecmp_link_loads(table, dist, routing.sigma, D2, chunk=chunk,
                             backend=backend, device=device)
    reach = dist >= 0
    dpos = np.where(reach, dist, 0)
    hops = float((np.where(reach, D1, 0.0) * dpos).sum()
                 + (np.where(reach, D2, 0.0) * dpos).sum())
    h1 = int(dpos[out_s > 0].max()) if bool((out_s > 0).any()) else 0
    h2 = int(dpos[:, in_t > 0].max()) if bool((in_t > 0).any()) else 0
    return loads, hops, h1 + h2


def _ugal_qmin_chunk(table: torch.Tensor, load_in: torch.Tensor,
                     dist: torch.Tensor) -> torch.Tensor:
    """Peak minimal-DAG link load q_min(s, t) for a (S, n) block of sources.

    Layered max-DP over the BFS DAG: ``M(v)`` at layer d is the max over
    predecessor slots (neighbors one layer closer) of
    ``max(M(pred), load(pred → v))`` — the largest link load anywhere on the
    union of minimal paths s → v.  ``load_in[v, j]`` is the load of the
    incoming directed link ``table[v, j] → v``.  One gather and one max over
    the (S, n, k) block per layer (no spmv: a max, not a sum).  Self-padded
    slots never qualify as predecessors (their dist equals the row's own).
    """
    tl = table.long()
    dmax = max(int(dist.max()), 0)
    M = torch.zeros(dist.shape, dtype=load_in.dtype, device=dist.device)
    for d in range(1, dmax + 1):
        pred = dist[:, tl] == (d - 1)
        cand = torch.where(pred, torch.maximum(M[:, tl], load_in), 0.0)
        M = torch.where(dist == d, cand.amax(dim=2), M)
    return M


def _ugal_decision(table: np.ndarray, routing: RoutingResult,
                   served: np.ndarray, *, chunk: int,
                   backend: Optional[str],
                   device: Device = DEFAULT_DEVICE
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """UGAL's per-pair choice: ``(minimal_mask (S, n) bool, L_min (n, k))``.

    One-shot UGAL-L-style estimate: channel loads are estimated from routing
    the *entire* offered demand all-minimal (q_min = peak load on the pair's
    minimal DAG) vs all-Valiant (q_val = global peak).  A pair stays minimal
    iff ``d_min * q_min <= h_val * q_val`` with ``h_val = E_w[d(s,w)] +
    E_w[d(w,t)]`` the expected Valiant path length; ties route minimal.
    Both sides scale identically under the sampled n/S correction, so the
    decision is taken on unscaled loads.  The loads are float64 here (the
    reference compares its float32 ECMP loads).
    """
    dev = resolve_device(device)
    dist = routing.dist
    S, n = served.shape
    k = table.shape[1]
    L_min = ecmp_link_loads(table, dist, routing.sigma, served, chunk=chunk,
                            backend=backend, device=dev)
    rev = reverse_slot_index(table)
    load_in = L_min[table, rev]        # (n, k): load on link table[v,j] -> v
    L_val, _, _ = valiant_link_loads(table, routing, served, chunk=chunk,
                                     backend=backend, device=dev)
    q_val = float(L_val.max())
    reach = dist >= 0
    dpos = np.where(reach, dist, 0)
    n_reach_row = np.maximum(reach.sum(axis=1), 1)
    n_reach_col = np.maximum(reach.sum(axis=0), 1)
    a_s = (dpos * reach).sum(axis=1) / n_reach_row   # E_w d(s, w)
    b_t = (dpos * reach).sum(axis=0) / n_reach_col   # E_w d(w, t)
    tab = torch.as_tensor(table, dtype=torch.int32, device=dev)
    lin = torch.as_tensor(load_in, dtype=torch.float64, device=dev)
    qmin = np.zeros((S, n), dtype=np.float64)
    inner = _source_tile(chunk, n, k)
    for lo in range(0, S, inner):
        hi = min(lo + inner, S)
        qmin[lo:hi] = _ugal_qmin_chunk(
            tab, lin, torch.as_tensor(dist[lo:hi], device=dev)).cpu().numpy()
    lhs = dpos * qmin
    rhs = (a_s[:, None] + b_t[None, :]) * q_val
    return (lhs <= rhs) | ~reach, L_min


def ugal_link_loads(table: np.ndarray, routing: RoutingResult,
                    served: np.ndarray, *,
                    chunk: int = DEFAULT_SOURCE_CHUNK,
                    backend: Optional[str] = None,
                    device: Device = DEFAULT_DEVICE
                    ) -> Tuple[np.ndarray, float, int]:
    """UGAL adaptive routing: per-pair minimal vs Valiant by estimated load.

    Splits the served demand by :func:`_ugal_decision`, routes the minimal
    share ECMP and the diverted share Valiant, and sums the loads.  When
    nothing diverts (e.g. uniform traffic on every symmetric family — the
    minimal channel estimate never exceeds the doubled-hop Valiant one) the
    all-minimal loads computed for the decision are reused as-is, making
    UGAL degenerate to ``minimal`` exactly.

    Returns ``(loads, hops_weighted, max_hops)`` as
    :func:`valiant_link_loads`.
    """
    dist = routing.dist
    minimal_mask, L_min = _ugal_decision(table, routing, served, chunk=chunk,
                                         backend=backend, device=device)
    D_min = np.where(minimal_mask, served, 0.0)
    D_val = served - D_min
    hops_min, mh_min = _hops_summary(dist, D_min)
    if not D_val.any():
        return L_min, hops_min, mh_min
    loads = ecmp_link_loads(table, dist, routing.sigma, D_min, chunk=chunk,
                            backend=backend, device=device)
    lv, hv, mhv = valiant_link_loads(table, routing, D_val, chunk=chunk,
                                     backend=backend, device=device)
    return loads + lv, hops_min + hv, max(mh_min, mhv)


def _ksp_loads_chunk(table: torch.Tensor, nopad: torch.Tensor,
                     dist: torch.Tensor, demand: torch.Tensor,
                     Lmax: int, slack: int,
                     backend: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near-minimal path ECMP loads for a (S, n) block — forward/backward
    walk DP over length layers, float64.

    Forward: ``W[h]`` = walks of length h from the source (one signed spmv
    per layer over the (S, n) block, the shared 0/1 mask ``nopad`` as the
    signs so pad slots drop out), stacked to (Lmax+1, S, n).  Every walk to
    t of length in ``[dist(t), dist(t)+slack]`` is an admitted path with
    equal weight ``D[t] / P(t)`` (``P`` = total admitted walks).  For
    ``slack <= 1`` every admitted walk is a simple path; larger slacks admit
    backtracking walks — a derouting model.  Backward: ``G[h](v)`` =
    downstream credit of being at v at step h; the load on slot (u, j)
    accumulates ``W[h][u] * G[h+1][table[u,j]]``.  ``slack=0`` reproduces
    minimal ECMP exactly.

    The reference scans Lmax+1 spmvs each way and drops the last of each;
    here the forward stops at W[Lmax] and the backward skips the spmv of
    G[Lmax+1] = 0 and the unused G[0], so a chunk launches 2*Lmax - 1 spmvs
    (the same values).  Returns (summed (n, k) loads, summed hop total).
    """
    bk = KS.resolve_backend(backend, dist.device)
    tl = table.long()
    W = (dist == 0).to(nopad.dtype)
    Ws = [W]
    for _ in range(Lmax):
        W = KS.spmv(W, table, None, nopad, backend=bk)
        Ws.append(W)
    Ws = torch.stack(Ws)                                # (Lmax+1, S, n)
    dpos = dist.clamp(min=0).long()
    P = torch.zeros_like(demand)
    wsum = torch.zeros_like(demand)     # sum_e (d+e) * W[d+e]
    for e in range(slack + 1):
        idx = (dpos + e).clamp(max=Lmax)
        cnt = torch.where((dist >= 0) & (dpos + e <= Lmax),
                          torch.gather(Ws, 0, idx[None])[0], 0.0)
        P = P + cnt
        wsum = wsum + (dpos + e) * cnt
    credit = demand / torch.where(P > 0, P, 1.0)
    hops = (credit * wsum).sum()
    loads = torch.zeros(table.shape, dtype=demand.dtype, device=dist.device)
    g_next = None                       # G[h+1]; G[Lmax+1] = 0
    for h in range(Lmax, -1, -1):
        if g_next is not None:
            loads = loads + nopad * (Ws[h][:, :, None]
                                     * g_next[:, tl]).sum(dim=0)
        if h == 0:
            break
        admit = (dist >= 0) & (h >= dist) & (h <= dist + slack)
        g = torch.where(admit, credit, 0.0)
        if g_next is not None:
            g = g + KS.spmv(g_next, table, None, nopad, backend=bk)
        g_next = g
    return loads, hops


def ksp_link_loads(table: np.ndarray, routing: RoutingResult,
                   served: np.ndarray, *, slack: int = 1,
                   chunk: int = DEFAULT_SOURCE_CHUNK,
                   backend: Optional[str] = None,
                   device: Device = DEFAULT_DEVICE
                   ) -> Tuple[np.ndarray, float, int]:
    """k-shortest-path non-minimal ECMP: equal split over every path of
    length <= ``dist(s, t) + slack``.

    Returns ``(loads (n, k) float64 — unscaled, hops_weighted, max_hops)``.
    The DP runs in float64 (walk counts overflow float32 fast) with the
    source chunk re-sized so the per-source walk stack and load table stay
    within :data:`ECMP_TILE_BYTES`.
    """
    if slack < 0:
        raise ValueError(f"slack must be >= 0 (got {slack})")
    dev = resolve_device(device)
    table = np.asarray(table)
    n, k = table.shape
    dist = routing.dist
    served = np.where(dist >= 0, served, 0.0)
    if not served.any():
        return np.zeros((n, k), dtype=np.float64), 0.0, 0
    Lmax = int(dist[served > 0].max()) + int(slack)
    nopad = table != np.arange(n)[:, None]
    per_src = 8 * n * (Lmax + 2 + k)   # walk stack + load table, f64
    inner = max(1, min(chunk, ECMP_TILE_BYTES // max(per_src, 1)))
    tab = torch.as_tensor(table, dtype=torch.int32, device=dev)
    npd = torch.as_tensor(nopad, dtype=torch.float64, device=dev)
    loads = torch.zeros((n, k), dtype=torch.float64, device=dev)
    hops = 0.0
    for lo in range(0, dist.shape[0], inner):
        hi = min(lo + inner, dist.shape[0])
        lc, hc = _ksp_loads_chunk(
            tab, npd, torch.as_tensor(dist[lo:hi], device=dev),
            torch.as_tensor(served[lo:hi], dtype=torch.float64, device=dev),
            Lmax=Lmax, slack=int(slack), backend=backend)
        loads += lc
        hops += float(hc)
    return loads.cpu().numpy(), hops, Lmax


def scheme_link_loads(table: np.ndarray, routing: RoutingResult,
                      served: np.ndarray, scheme: str = "minimal", *,
                      slack: int = 1, chunk: int = DEFAULT_SOURCE_CHUNK,
                      backend: Optional[str] = None,
                      device: Device = DEFAULT_DEVICE
                      ) -> Tuple[np.ndarray, float, int]:
    """Route served demand rows under one of :data:`ROUTING_SCHEMES`.

    The shared dispatch used by :func:`evaluate_traffic` and the simulator's
    schedule compiler.  ``served`` is (S, n) demand rows aligned with
    ``routing.sources`` (diagonal zeroed, unreachable targets dropped).

    Returns ``(loads, hops_weighted, max_hops)``: (n, k) float64 directed
    slot loads *before* any n/S sampling correction, the demand-weighted hop
    total (equals the load sum — conservation), and the worst per-flow hop
    count (the simulator's round-latency bound).
    """
    table = np.asarray(table)
    kw = dict(chunk=chunk, backend=backend, device=device)
    if scheme == "minimal":
        loads = ecmp_link_loads(table, routing.dist, routing.sigma, served,
                                **kw)
        return (loads,) + _hops_summary(routing.dist, served)
    if scheme == "valiant":
        return valiant_link_loads(table, routing, served, **kw)
    if scheme == "ugal":
        return ugal_link_loads(table, routing, served, **kw)
    if scheme == "ksp":
        return ksp_link_loads(table, routing, served, slack=slack, **kw)
    raise ValueError(f"unknown routing scheme {scheme!r} "
                     f"(known: {ROUTING_SCHEMES})")


# --------------------------------------------------------------------------
# multi-commodity-flow LP throughput ceiling
# --------------------------------------------------------------------------

@obs.traced("traffic/mcf_throughput_ub", phase="execute")
def mcf_throughput_ub(topo: Union[Topology, Tuple[np.ndarray, int]],
                      pattern: str = "uniform", *,
                      fiedler: Optional[np.ndarray] = None,
                      demands: Optional[np.ndarray] = None,
                      groups: Optional[int] = None) -> float:
    """LP upper bound on saturation throughput over *all* routings (host).

    Maximize theta s.t. theta-scaled demands admit a fractional
    multi-commodity flow respecting unit capacity on every directed link
    (one capacity unit per non-padding gather-table slot — parallel edges
    each count, matching the ECMP slot semantics).  Commodities are grouped
    by source into ``groups`` buckets (contiguous in Fiedler order when
    ``fiedler`` is given, index order otherwise): merging commodities only
    *relaxes* the flow polytope, so the grouped optimum is a valid upper
    bound on the true per-commodity MCF optimum — which in turn dominates
    every realizable routing scheme — for any group count.  ``groups >= n``
    is the exact per-commodity LP.

    The LP has ``1 + groups * E`` variables (scipy sparse + HiGHS); the
    default caps at 8 groups — HiGHS wall time grows super-linearly with the
    group count on these highly-degenerate instances while the bound barely
    tightens, and a coarse grouping is still a certified (just looser)
    ceiling.  Tiny instances (``n <= 8``) get the exact per-commodity LP
    under the same cap.  Assumes a connected topology (demand between
    disconnected components makes the LP infeasible).  Raises
    ``RuntimeError`` with a clear message when scipy is unavailable —
    callers (survey, benches) catch it and skip the column.

    Returns theta* (``inf`` when there is no demand).
    """
    if _scipy_linprog is None:
        raise RuntimeError(
            "mcf_throughput_ub needs scipy (scipy.optimize.linprog) which is "
            "not installed — the MCF LP bound is skipped; install scipy to "
            "enable it")
    if isinstance(topo, Topology):
        n = topo.n
        table = topo.gather_operands()[0]
    else:
        table, n = np.asarray(topo[0]), int(topo[1])
    if demands is None:
        D = demand_rows(pattern, n, np.arange(n), fiedler=fiedler)
    else:
        D = np.asarray(demands, dtype=np.float64).copy()
        if D.shape != (n, n):
            raise ValueError(f"demands must be ({n}, {n}), got {D.shape}")
        D[np.arange(n), np.arange(n)] = 0.0
    if D.sum() <= 0:
        return float("inf")
    mask = (table != np.arange(n)[:, None]).ravel()
    tail = np.repeat(np.arange(n), table.shape[1])[mask]
    head = table.ravel()[mask]
    E = tail.size
    if groups is None:
        groups = max(2, min(n, 25_000 // max(E, 1), 8))
    G = max(1, min(int(groups), n))
    order = np.arange(n)
    if fiedler is not None and G < n:
        f = np.asarray(fiedler, dtype=np.float64)
        amax = np.max(np.abs(f))
        q = np.round(f / amax, 6) if amax > 0 else np.zeros_like(f)
        order = np.lexsort((order, q))
    buckets = np.array_split(order, G)
    out = D.sum(axis=1)
    sup = np.zeros((G, n))
    for g, b in enumerate(buckets):
        sup[g, b] += out[b]
        sup[g] -= D[b].sum(axis=0)
    e_idx = np.arange(E)
    inc = _scipy_sparse.coo_matrix(
        (np.r_[np.ones(E), -np.ones(E)],
         (np.r_[tail, head], np.r_[e_idx, e_idx])), shape=(n, E)).tocsr()
    A_eq = _scipy_sparse.hstack(
        [_scipy_sparse.csr_matrix(-sup.reshape(G * n, 1)),
         _scipy_sparse.block_diag([inc] * G, format="csr")], format="csr")
    eye = _scipy_sparse.eye(E, format="csr")
    A_ub = _scipy_sparse.hstack(
        [_scipy_sparse.csr_matrix((E, 1))] + [eye] * G, format="csr")
    c = np.zeros(1 + G * E)
    c[0] = -1.0
    res = _scipy_linprog(c, A_ub=A_ub, b_ub=np.ones(E),
                         A_eq=A_eq, b_eq=np.zeros(G * n), method="highs")
    if res.status == 3:                # unbounded: no capacity ever binds
        return float("inf")
    if not res.success:
        raise RuntimeError(f"MCF LP failed (status {res.status}): "
                           f"{res.message}")
    return float(-res.fun)


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
                     slack: int = 1,
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
        scheme: routing scheme from :data:`ROUTING_SCHEMES` (default
            ``minimal`` — ECMP).
        slack: extra hops the ``ksp`` scheme admits beyond minimal
            (``dist + slack`` path budget); ignored by the other schemes.
        routing: reuse a :class:`RoutingResult` (e.g. the one a lazy Analysis
            session already computed); computed here if absent.  A *sampled*
            routing result (``exact=False``) is accepted: only its S source
            rows are routed and every extensive figure (loads, totals) is
            scaled by the unbiasedness correction n/S.  ``max_link_load`` is
            then a noisy order statistic (biased low); for the ``minimal``
            scheme a bootstrap upper confidence bound ``max_link_load_ucb``
            is computed over candidate hot slots and
            ``saturation_throughput`` uses *it* (the other schemes keep the
            point estimate as the bound, as the reference does).
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
    if scheme not in ROUTING_SCHEMES:
        raise ValueError(f"unknown routing scheme {scheme!r} "
                         f"(known: {ROUTING_SCHEMES})")
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
        table, routing, served, scheme, slack=slack, chunk=chunk,
        backend=backend, device=dev)
    load_sum = float(loads.sum())
    # conservation holds per source row, so check it *before* the n/S scale
    conservation = abs(load_sum - hops_weighted) / max(hops_weighted, 1e-12)
    loads = loads * scale
    max_load = float(loads.max()) if loads.size else 0.0
    ucb = max_load
    if not routing.exact and scheme == "minimal" and max_load > 0:
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
