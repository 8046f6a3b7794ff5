"""Ramanujan graphs: the LPS construction X^{p,q} (§3.1.1) and certificates.

Definition 1: a k-regular G is Ramanujan iff lambda(G) <= 2 sqrt(k-1), where
lambda(G) is the largest-magnitude adjacency eigenvalue != ±k.

LPS (Lubotzky-Phillips-Sarnak): for distinct primes p, q ≡ 1 (mod 4), X^{p,q}
is the (q+1)-regular Cayley graph of PSL(2, F_p) (if q is a QR mod p; n =
p(p^2-1)/2, non-bipartite) or PGL(2, F_p) (otherwise; n = p(p^2-1), bipartite)
with generators built from the q+1 integer quaternion solutions of
a0^2+a1^2+a2^2+a3^2 = q with a0 odd positive, a1..a3 even.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np

from ..api.registry import register
from .graphs import Topology

__all__ = ["lps", "lps_size", "is_ramanujan", "ramanujan_bound", "alon_boppana_lb",
           "legendre"]

Mat = Tuple[int, int, int, int]  # row-major 2x2 over F_p


def legendre(a: int, p: int) -> int:
    """Legendre symbol (a/p) for odd prime p."""
    a %= p
    if a == 0:
        return 0
    return 1 if pow(a, (p - 1) // 2, p) == 1 else -1


def _sqrt_minus_one(p: int) -> int:
    """An integer i with i^2 ≡ -1 (mod p), p ≡ 1 (mod 4)."""
    for a in range(2, p):
        if legendre(a, p) == -1:
            return pow(a, (p - 1) // 4, p)
    raise ValueError("no quadratic non-residue found")


def _quaternion_solutions(q: int) -> List[Tuple[int, int, int, int]]:
    """All (a0,a1,a2,a3), a0 odd > 0, a1..a3 even, with sum of squares = q.

    Jacobi's four-square theorem gives exactly q+1 of them for prime
    q ≡ 1 (mod 4).
    """
    sols = set()
    r = int(math.isqrt(q))
    evens = [v for v in range(-r, r + 1) if v % 2 == 0]
    for a0 in range(1, r + 1, 2):
        for a1 in evens:
            s01 = q - a0 * a0 - a1 * a1
            if s01 < 0:
                continue
            for a2 in evens:
                rem = s01 - a2 * a2
                if rem < 0:
                    continue
                a3 = int(math.isqrt(rem))
                if a3 * a3 == rem and a3 % 2 == 0:
                    sols.add((a0, a1, a2, a3))
                    if a3:
                        sols.add((a0, a1, a2, -a3))
    out = sorted(sols)
    assert len(out) == q + 1, f"expected q+1={q + 1} solutions, got {len(out)}"
    return out


def _mul(m: Mat, g: Mat, p: int) -> Mat:
    a, b, c, d = m
    e, f, gg, h = g
    return ((a * e + b * gg) % p, (a * f + b * h) % p,
            (c * e + d * gg) % p, (c * f + d * h) % p)


def _canon(m: Mat, p: int) -> Mat:
    """Canonical PGL(2,p) representative: scale so first nonzero entry is 1."""
    for v in m:
        if v:
            inv = pow(v, p - 2, p)
            return tuple((x * inv) % p for x in m)  # type: ignore
    raise ValueError("zero matrix")


def lps_size(p: int, q: int) -> int:
    return p * (p * p - 1) // 2 if legendre(q, p) == 1 else p * (p * p - 1)


def _cf_lps(p: int, q: int) -> dict:
    """Registry closed forms: exact size/radix + the Ramanujan rho2 floor
    (Definition 1 gives lambda <= 2 sqrt(q), hence rho2 >= q + 1 - 2 sqrt(q))."""
    k = q + 1
    return dict(nodes=lps_size(p, q), radix=k,
                rho2_lb=k - 2.0 * math.sqrt(k - 1.0))


@register("lps", params=dict(p=int, q=int), closed_forms=_cf_lps,
          tags=("vertex_transitive",), aliases=("ramanujan",),
          default_instance="lps(5,13)")
def lps(p: int, q: int) -> Topology:
    """The LPS Ramanujan graph X^{p,q} (Definition 2)."""
    for x, nm in ((p, "p"), (q, "q")):
        if x % 4 != 1 or any(x % f == 0 for f in range(2, int(math.isqrt(x)) + 1)):
            raise ValueError(f"{nm}={x} must be a prime ≡ 1 (mod 4)")
    if p == q:
        raise ValueError("p and q must be distinct")
    i = _sqrt_minus_one(p)
    gens: List[Mat] = []
    for a0, a1, a2, a3 in _quaternion_solutions(q):
        gens.append(((a0 + i * a1) % p, (a2 + i * a3) % p,
                     (-a2 + i * a3) % p, (a0 - i * a1) % p))
    ident: Mat = (1, 0, 0, 1)
    index = {ident: 0}
    reps: List[Mat] = [ident]
    directed: Counter = Counter()
    head = 0
    while head < len(reps):
        m = reps[head]
        u = head
        for g in gens:
            key = _canon(_mul(m, g, p), p)
            v = index.get(key)
            if v is None:
                v = len(reps)
                index[key] = v
                reps.append(key)
            directed[(u, v)] += 1
        head += 1
    n = len(reps)
    expected = lps_size(p, q)
    assert n == expected, f"LPS({p},{q}): enumerated {n} != expected {expected}"
    # S is symmetric (the conjugate quaternion is the inverse generator), so the
    # directed multiset satisfies directed[(u,v)] == directed[(v,u)]; the
    # undirected multiplicity of {u,v} is directed[(u,v)] (one generator per
    # incident edge-end, Cayley degree = |S| = q+1).
    edges = []
    loops = np.zeros(n)
    for (u, v), c in sorted(directed.items()):
        if u == v:
            loops[u] += c        # identity generators (rare; only if p^2 | q - a0^2)
        elif u < v:
            assert directed[(v, u)] == c, "generator set not symmetric"
            edges.extend([(u, v)] * c)
    topo = Topology(f"lps({p},{q})", n, np.array(edges, dtype=np.int64),
                    loops=loops if loops.any() else None,
                    meta=dict(p=p, q=q, bipartite=legendre(q, p) == -1, k=q + 1))
    return topo


def ramanujan_bound(k: int) -> float:
    """2 sqrt(k-1): the Alon–Boppana asymptotic optimum."""
    return 2.0 * math.sqrt(k - 1)


def alon_boppana_lb(k: int, diam: int) -> float:
    """lambda >= 2 sqrt(k-1) (1 - 2/D) - 2/D  (§3, Alon–Boppana theorem)."""
    return 2.0 * math.sqrt(k - 1) * (1 - 2.0 / diam) - 2.0 / diam


def is_ramanujan(topo: Topology, spectrum: Optional[np.ndarray] = None,
                 tol: float = 1e-8) -> Tuple[bool, float]:
    """Certificate: returns (is_ramanujan, lambda(G)).

    ``spectrum``: optional precomputed adjacency spectrum (ascending).
    Excludes eigenvalues equal to ±k (trivial / bipartite-trivial).
    """
    k = topo.radix
    if spectrum is None:
        spectrum = np.linalg.eigvalsh(topo.adjacency())
    nontriv = spectrum[np.abs(np.abs(spectrum) - k) > 1e-6]
    lam = float(np.max(np.abs(nontriv)))
    return bool(lam <= ramanujan_bound(k) + tol), lam
