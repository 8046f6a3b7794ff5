"""Analytic spectral bounds: Theorems 1-3, §3 expansion bounds, and the full
Table 1 of per-topology rho_2 / bisection-bandwidth bounds.

Everything here is a closed-form function of topology parameters — the
numerical validation (tests/benchmarks) checks the *constructed* graphs against
these expressions.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np

__all__ = [
    "alon_milman_diameter_ub", "mohar_diameter_lb", "fiedler_bw_lb",
    "cheeger_bw_ub", "first_moment_bw_ub", "fiedler_vertex_connectivity_lb",
    "tanner_isoperimetric_lb", "alon_milman_gap_lb", "discrepancy_edge_bound",
    "active_subset_bw_lb", "ramanujan_rho2", "ramanujan_bw_lb",
    "interlacing_degraded_rho2_ub", "weyl_degraded_rho2_lb",
    "expected_degraded_rho2", "TABLE1",
]


# --------------------------------------------------------------------------
# §2.1 general eigenvalue bounds
# --------------------------------------------------------------------------

def alon_milman_diameter_ub(n: int, max_deg: float, rho2: float) -> float:
    """Theorem 1: diam(G) <= 2 ceil( sqrt(2*Delta/rho2) * log2(n) )."""
    return 2 * math.ceil(math.sqrt(2.0 * max_deg / rho2) * math.log2(n))


def mohar_diameter_lb(n: int, rho2: float) -> float:
    """McKay/Mohar: diam(G) >= 4 / (n * rho2)."""
    return 4.0 / (n * rho2)


def fiedler_bw_lb(n: int, rho2: float) -> float:
    """Theorem 2 (Fiedler): BW(G) >= rho2 * n / 4."""
    return rho2 * n / 4.0


def cheeger_bw_ub(n: int, k: float, rho2: float) -> float:
    """Theorem 3: BW(G) <= sqrt(2 k rho2) * k * n / 2 (loose for large rho2)."""
    return math.sqrt(2.0 * k * rho2) * k * n / 2.0


def first_moment_bw_ub(m: int) -> float:
    """BW(G) <= m/2 for any graph with m edges (first-moment method)."""
    return m / 2.0


def fiedler_vertex_connectivity_lb(rho2: float) -> float:
    """kappa(G) >= rho2 — the fault-tolerance guarantee."""
    return rho2


def tanner_isoperimetric_lb(k: float, lambda2: float) -> float:
    """Tanner: h(G) >= 1 - k / (2k - 2*lambda2)."""
    return 1.0 - k / (2.0 * k - 2.0 * lambda2)


def alon_milman_gap_lb(h: float) -> float:
    """Alon–Milman: k - lambda2 >= h^2 / (4 + 2 h^2)."""
    return h * h / (4.0 + 2.0 * h * h)


# --------------------------------------------------------------------------
# §3 Ramanujan reference values + discrepancy
# --------------------------------------------------------------------------

def ramanujan_rho2(k: float) -> float:
    """rho2 of a Ramanujan graph is >= k - 2 sqrt(k-1)."""
    return k - 2.0 * math.sqrt(k - 1.0)


def ramanujan_bw_lb(n: int, k: float) -> float:
    """Fiedler lower bound at the Ramanujan rho2: (k - 2 sqrt(k-1)) n / 4."""
    return ramanujan_rho2(k) * n / 4.0


def discrepancy_edge_bound(n: int, k: float, sx: int, sy: int) -> float:
    """|e(X,Y) - k|X||Y|/n| <= (2 sqrt(k-1)/n) sqrt(|X|(n-|X|)|Y|(n-|Y|))."""
    return (2.0 * math.sqrt(k - 1.0) / n) * math.sqrt(sx * (n - sx) * sy * (n - sy))


def active_subset_bw_lb(alpha: float, n: int, k: float) -> float:
    """Guaranteed bisection bandwidth on ANY alpha*n active nodes of a
    Ramanujan topology (§3):  (alpha k n / 2) (alpha/2 - (2 sqrt(k-1)/k)(1 - alpha/2)).
    """
    return (alpha * k * n / 2.0) * (alpha / 2.0 - (2.0 * math.sqrt(k - 1.0) / k) * (1.0 - alpha / 2.0))


# --------------------------------------------------------------------------
# degraded operation: analytic bounds on rho_2 after link faults
# --------------------------------------------------------------------------

def interlacing_degraded_rho2_ub(rho2_healthy: float) -> float:
    """Removing links never raises rho_2: L(G - F) ⪯ L(G) in the Loewner
    order (each removed edge subtracts a PSD rank-1 term), so by eigenvalue
    monotonicity every sampled degraded gap sits at or below the healthy one.
    Valid for link faults; node faults change the vertex set and can RAISE
    rho_2 (e.g. pruning a pendant path), so no such cap applies there."""
    return rho2_healthy


def weyl_degraded_rho2_lb(rho2_healthy: float, links_removed: int) -> float:
    """Weyl: each removed edge's Laplacian has spectral norm 2, so
    rho_2(G - F) >= rho_2(G) - 2 |F| (clipped at 0).  Loose but certified."""
    return max(0.0, rho2_healthy - 2.0 * links_removed)


def expected_degraded_rho2(rho2_healthy: float, fault_rate: float) -> float:
    """E[L_degraded] = (1 - r) L under iid link failure at rate r, so the
    first-order expected gap is (1 - r) rho_2 — the scaling the collective
    cost model's ``degrade`` view uses for its guaranteed-bisection figure."""
    return rho2_healthy * (1.0 - fault_rate)


# --------------------------------------------------------------------------
# Table 1: per-topology closed forms.  Each entry maps parameters to
# dict(nodes, radix, rho2_ub, bw_ub) exactly as printed in the paper.
#
# NOTE: the registry (repro_torch.api.registry) is now the canonical home of these
# expressions — each Family record carries its closed_forms callable, wired up
# at registration time in core/topologies.py.  TABLE1 remains as the shared
# implementation + a backwards-compatible name-keyed view.
# --------------------------------------------------------------------------

def _butterfly(k: int, s: int) -> Dict:
    n = s * k ** s
    return dict(nodes=n, radix=2 * k,
                # Proposition 1: rho2 <= 2k - 2k cos(2 pi / s)
                rho2_ub=2 * k - 2 * k * math.cos(2 * math.pi / s),
                bw_ub=(k + 1) * k ** s / 2.0)


def _ccc(d: int) -> Dict:
    # Proposition 3 is an *order* bound ("at most on the order of"); the
    # paper's closed-form Rayleigh evaluation has a small algebra slip (its
    # printed lower bound on lambda_1(A') exceeds the true lambda_1 by ~4e-4
    # at d=4; we verified Lemma 2 itself holds EXACTLY — see
    # tests/test_topologies.py::test_ccc_lemma2_exact).  We encode the
    # asymptotic statement with its measured constant envelope (ratio <= 1.15
    # for d >= 3, decreasing to 1).
    return dict(nodes=d * 2 ** d, radix=3,
                rho2_ub=1.15 * 2.0 * (1 - math.cos(math.pi / (d + 2))),
                bw_ub=2.0 ** (d - 1))


def _clex(k: int, ell: int) -> Dict:
    return dict(nodes=k ** ell, radix=2 * ell * k - k - 1,
                # Proposition 5: gap <= t + 3k + 1 with t = k-1 -> 4k - 2... the
                # paper's table prints 4k - 2 (t + 3k + 1 at t = k - 1 = 4k).
                # We use the table value.
                rho2_ub=4.0 * k - 2.0,
                bw_ub=float(k) ** (ell + 1))


def _data_vortex(A: int, C: int) -> Dict:
    return dict(nodes=A * C * 2 ** (C - 1), radix=4,
                # Proposition 2
                rho2_ub=min(2 - 2 * math.cos(math.pi / C),
                            2 - 2 * math.cos(2 * math.pi / A)),
                bw_ub=A * 2.0 ** (C - 2))


def _dragonfly(h_nodes: int, h_edges: int, h_bw: float) -> Dict:
    r = 2.0 * h_edges / h_nodes
    return dict(nodes=h_nodes * h_nodes + h_nodes, radix=r + 1,
                # Corollary 2
                rho2_ub=1.0 + h_nodes / (2.0 * h_edges),
                bw_ub=((h_nodes + 1) / 2.0) ** 2 + h_bw)


def _hypercube(d: int) -> Dict:
    return dict(nodes=2 ** d, radix=d, rho2_ub=2.0, bw_ub=2.0 ** (d - 1),
                diameter=d)


def _petersen_torus(a: int, b: int) -> Dict:
    return dict(nodes=10 * a * b, radix=4,
                # Corollary 1
                rho2_ub=(4 - 3 * math.cos(4 * math.pi / a) - math.cos(2 * math.pi / a)) / 5.0,
                bw_ub=6.0 * b + a * b + 5.0)


def _slimfly(q: int) -> Dict:
    return dict(nodes=2 * q * q, radix=(3 * q - 1) / 2.0,
                rho2_ub=float(q),                 # Proposition 9 (exact)
                bw_ub=(q ** 3 + q) / 2.0,         # Proposition 10
                diameter=2)                       # MMS graphs have diameter 2


def _torus(k: int, d: int) -> Dict:
    return dict(nodes=k ** d, radix=2 * d,
                rho2_ub=2.0 * (1 - math.cos(2 * math.pi / k)),
                bw_ub=2.0 * k ** (d - 1),
                diameter=d * (k // 2))


class _Table1(Dict[str, Callable[..., Dict]]):
    """Table-1 record lookup that names removed/renamed keys in its KeyError
    (a plain dict would just echo the missing key)."""

    #: removed key -> its replacement (kept so the error can say *why*)
    _REMOVED = {"peterson_torus": "petersen_torus"}

    def __missing__(self, key):
        if key in self._REMOVED:
            raise KeyError(
                f"TABLE1 key {key!r} was removed after its deprecation "
                f"cycle; use {self._REMOVED[key]!r}")
        raise KeyError(f"unknown TABLE1 topology {key!r} "
                       f"(known: {', '.join(sorted(self))})")


TABLE1: Dict[str, Callable[..., Dict]] = _Table1({
    "butterfly": _butterfly,
    "ccc": _ccc,
    "clex": _clex,
    "data_vortex": _data_vortex,
    "dragonfly": _dragonfly,
    "hypercube": _hypercube,
    "petersen_torus": _petersen_torus,
    "slimfly": _slimfly,
    "torus": _torus,
})
