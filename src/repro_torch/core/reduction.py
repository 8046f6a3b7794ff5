"""The Reduction Lemma (Lemma 1): orbit quotients whose spectrum embeds in G's
(the PyTorch port's copy of the reference module; numpy, host).

Given a partition of V(G) into orbits of a subgroup of Aut(G), the weighted,
directed, looped quotient H — H[sigma, tau] = total edge weight from any vertex
of sigma into tau — has spec(H) ⊆ spec(G).  We *verify* the orbit property
numerically (all rows of a block must have equal sums into every block) instead
of trusting the caller, so misuse fails loudly.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from .graphs import Topology

__all__ = ["quotient", "spectrum_subset", "orbit_quotient_spectrum"]


def quotient(topo: Union[Topology, np.ndarray], orbits: Sequence[int],
             check: bool = True, atol: float = 1e-9) -> np.ndarray:
    """Quotient adjacency matrix H (generally non-symmetric).

    orbits: length-n array of orbit ids (0..r-1).
    """
    A = topo.adjacency() if isinstance(topo, Topology) else np.asarray(topo, dtype=np.float64)
    orbits = np.asarray(orbits)
    n = A.shape[0]
    ids = np.unique(orbits)
    r = len(ids)
    remap = {int(o): i for i, o in enumerate(ids)}
    lab = np.array([remap[int(o)] for o in orbits])
    # row sums of A into each orbit, per vertex: (n, r)
    M = np.zeros((n, r))
    for t in range(r):
        M[:, t] = A[:, lab == t].sum(axis=1)
    H = np.zeros((r, r))
    for s in range(r):
        rows = M[lab == s]
        if check and not np.allclose(rows, rows[0], atol=atol):
            raise ValueError(f"partition is not an automorphism-orbit partition "
                             f"(block {s} has unequal row sums)")
        H[s] = rows[0]
    return H


def spectrum_subset(spec_h: np.ndarray, spec_g: np.ndarray,
                    atol: float = 1e-6) -> bool:
    """Every eigenvalue of H appears in spec(G) (as sets, per the lemma)."""
    sg = np.sort(np.real(spec_g))
    for lam in np.real(spec_h):
        i = np.searchsorted(sg, lam)
        near = []
        if i < len(sg):
            near.append(abs(sg[i] - lam))
        if i > 0:
            near.append(abs(sg[i - 1] - lam))
        if min(near) > atol:
            return False
    return True


def orbit_quotient_spectrum(topo: Topology, orbits: Sequence[int]) -> np.ndarray:
    """Eigenvalues of the quotient (may be complex for non-normal H; the lemma
    guarantees they are real since they live in spec(G))."""
    H = quotient(topo, orbits)
    return np.linalg.eigvals(H)
