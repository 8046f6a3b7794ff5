"""Graph lifts (Bilu–Linial) — the machinery behind Xpander (paper §3.2);
the PyTorch port's copy of the reference module (numpy, host).

A 2-lift of G doubles the vertices; each edge is either "parallel" (straight)
or "crossing" per a ±1 signing.  Bilu–Linial: the lift's new eigenvalues are
exactly the eigenvalues of the *signed* adjacency A_s, so a signing with small
spectral radius yields a near-Ramanujan double cover — repeated lifting grows
expanders of any size from a small seed (the Xpander construction).

``best_random_signing`` searches random signings for small lambda(A_s);
``k_lift`` generalizes to permutation lifts.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE

from .graphs import Topology

__all__ = ["two_lift", "signed_spectral_radius", "best_random_signing",
           "xpander_like", "k_lift"]


def two_lift(topo: Topology, signing: np.ndarray) -> Topology:
    """2-lift: vertex v -> (v, 0), (v, 1).  Edge e={u,v} with signing +1 stays
    parallel ((u,i)~(v,i)); with -1 it crosses ((u,i)~(v,1-i))."""
    signing = np.asarray(signing)
    assert signing.shape == (topo.m,)
    n = topo.n
    e = topo.edges
    par = signing > 0
    edges = []
    # parallel copies
    edges.append(np.stack([e[par, 0], e[par, 1]], axis=1))                # layer 0
    edges.append(np.stack([e[par, 0] + n, e[par, 1] + n], axis=1))        # layer 1
    # crossing copies
    edges.append(np.stack([e[~par, 0], e[~par, 1] + n], axis=1))
    edges.append(np.stack([e[~par, 0] + n, e[~par, 1]], axis=1))
    return Topology(f"2lift({topo.name})", 2 * n, np.concatenate(edges, axis=0),
                    meta=dict(base=topo.name))


def _signed_adjacency(topo: Topology, signing: np.ndarray) -> np.ndarray:
    A = np.zeros((topo.n, topo.n))
    np.add.at(A, (topo.edges[:, 0], topo.edges[:, 1]), signing)
    np.add.at(A, (topo.edges[:, 1], topo.edges[:, 0]), signing)
    return A


def _signed_eigvals(topo: Topology, signing: np.ndarray) -> np.ndarray:
    return np.linalg.eigvalsh(_signed_adjacency(topo, signing))


def signed_spectral_radius(topo: Topology, signing: np.ndarray) -> float:
    """lambda(A_s): the largest |eigenvalue| of the signed adjacency — exactly
    the set of NEW eigenvalues introduced by the 2-lift (Bilu–Linial)."""
    return float(np.max(np.abs(_signed_eigvals(topo, signing))))


def _signing_objective(ev: np.ndarray, objective: str) -> float:
    # "radius": Ramanujan criterion, max |eigenvalue|.  "gap": only the top
    # positive eigenvalue binds rho2 = k - lambda_2 of the lift, so minimizing
    # it maximizes the grown graph's algebraic connectivity.
    if objective == "gap":
        return float(ev[-1])
    return float(max(abs(ev[0]), ev[-1]))


def best_random_signing(topo: Topology, trials: int = 64, seed: int = 0,
                        objective: str = "radius", refine: bool = False
                        ) -> Tuple[np.ndarray, float]:
    """Search for a signing with small lambda(A_s).  Bilu–Linial prove
    a signing with lambda <= O(sqrt(k log^3 k)) always exists; random signings
    concentrate near 2 sqrt(k-1) already for modest sizes.

    ``objective``: "radius" minimizes max|eig(A_s)| (the Ramanujan criterion);
    "gap" minimizes the top positive eigenvalue (the one binding the lift's
    rho2).  ``refine=True`` follows the random search with greedy single-edge
    sign flips until a local optimum (dense eigensolves; small graphs only).
    Returns (signing, signed spectral radius) — the radius is reported even
    under the "gap" objective, for Ramanujan-style accounting.
    """
    rng = np.random.default_rng(seed)
    best, best_obj = None, np.inf
    for _ in range(trials):
        s = rng.choice([-1.0, 1.0], size=topo.m)
        obj = _signing_objective(_signed_eigvals(topo, s), objective)
        if obj < best_obj:
            best, best_obj = s, obj
    if refine and topo.n <= 512:
        # incremental flips: a sign flip of edge e={u,v} is a two-entry
        # -/+2s update of the signed adjacency, so keep A current and
        # revert rejected flips instead of rebuilding from the edge list
        A = _signed_adjacency(topo, best)
        improved = True
        while improved:
            improved = False
            for e, (u, v) in enumerate(topo.edges):
                s = best[e]
                A[u, v] -= 2 * s
                A[v, u] -= 2 * s
                obj = _signing_objective(np.linalg.eigvalsh(A), objective)
                if obj < best_obj - 1e-12:
                    best[e] = -s
                    best_obj = obj
                    improved = True
                else:
                    A[u, v] += 2 * s
                    A[v, u] += 2 * s
    return best, signed_spectral_radius(topo, best)


#: above this order, ``xpander_like`` switches from the dense per-signing
#: eigensolve to the batched gather-table search of ``repro.core.synthesis``
DENSE_LIFT_CUTOFF = 256


def xpander_like(seed_topo: Topology, doublings: int, trials: int = 64,
                 seed: int = 0, *,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE
                 ) -> Topology:
    """Xpander-style growth: repeatedly 2-lift with the best random signing.

    Keeps the radix of the seed while doubling nodes each step; the spectral
    gap degrades only by the worst signed radius encountered (tracked in
    meta['lift_lams']).  Signings are selected on the "gap" objective with
    refinement — the grown graph's rho2 is what Xpander cares about.  Levels
    at or below ``DENSE_LIFT_CUTOFF`` vertices use the dense float64
    eigensolve; larger levels run the batched Lanczos search of
    :func:`repro_torch.core.synthesis.best_signing_batched` on ``device``
    (same objective, one solve for all candidates), so growth to
    device-scale n never pays a per-signing dense eigendecomposition.
    """
    g = seed_topo
    lams = []
    for i in range(doublings):
        if g.n <= DENSE_LIFT_CUTOFF:
            s, lam = best_random_signing(g, trials=trials, seed=seed + i,
                                         objective="gap", refine=True)
        else:
            from .synthesis import best_signing_batched

            # mirrors the dense branch: winner picked on "gap", radius reported
            s, _top, lam = best_signing_batched(
                g, batch=min(trials, 32), steps=8 * trials,
                seed=seed + i, objective="gap", device=device)
        lams.append(lam)
        g = two_lift(g, s)
    g.meta["lift_lams"] = lams
    g.meta["seed"] = seed_topo.name
    return g


def k_lift(topo: Topology, k: int, seed: int = 0) -> Topology:
    """Random k-lift: vertex v -> (v, 0..k-1); edge {u,v} becomes the matching
    (u,i)~(v, pi(i)) for a uniform permutation pi per edge."""
    rng = np.random.default_rng(seed)
    n = topo.n
    edges = []
    for (u, v) in topo.edges:
        pi = rng.permutation(k)
        for i in range(k):
            edges.append((u * k + i, v * k + pi[i]))
    return Topology(f"{k}lift({topo.name})", n * k,
                    np.array(edges, dtype=np.int64), meta=dict(base=topo.name))
