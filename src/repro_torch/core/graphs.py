"""Core graph representation for interconnect topologies (PyTorch port's
copy of the reference module; host numpy, no torch).

Graphs are small host-side objects (numpy edge lists).  All *device-scale*
numerics (Lanczos, matvec) consume the derived ``neighbor_table`` which is the
gather-friendly form used by the torch/CUDA spectral layer.

Conventions
-----------
* Undirected multigraphs with optional weighted self-loops.  Self-loops
  contribute their weight once to the adjacency diagonal (paper convention:
  a self-loop regularizes the degree but never affects bisection/diameter).
* ``edges``  : (m, 2) int64 array of undirected edges (u, v), u != v.
             Parallel edges are repeated rows.  (``__post_init__`` casts to
             int64; the int32 narrowing happens only in ``neighbor_table`` /
             ``gather_operands``, the device-facing forms.)
* ``loops``  : (n,) float64 array of self-loop weights (usually 0/1, may be -1
             for the signed graphs of the CCC analysis).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["Topology"]


@dataclasses.dataclass
class Topology:
    name: str
    n: int
    edges: np.ndarray                      # (m, 2) int64, u != v
    loops: Optional[np.ndarray] = None     # (n,) float64 self-loop weights
    meta: Dict = dataclasses.field(default_factory=dict)

    # -- construction -----------------------------------------------------
    def __post_init__(self):
        self.edges = np.asarray(self.edges, dtype=np.int64).reshape(-1, 2)
        if np.any(self.edges[:, 0] == self.edges[:, 1]):
            raise ValueError("self-loops must go in `loops`, not `edges`")
        if self.edges.size and (self.edges.min() < 0 or self.edges.max() >= self.n):
            raise ValueError("edge endpoint out of range")
        if self.loops is not None:
            self.loops = np.asarray(self.loops, dtype=np.float64).reshape(self.n)

    # -- basic invariants --------------------------------------------------
    @property
    def m(self) -> int:
        """Number of undirected non-loop edges (parallel edges counted)."""
        return int(self.edges.shape[0])

    def degrees(self, include_loops: bool = True) -> np.ndarray:
        deg = np.bincount(self.edges.reshape(-1), minlength=self.n).astype(np.float64)
        if include_loops and self.loops is not None:
            deg = deg + np.abs(self.loops)
        return deg

    def is_regular(self) -> bool:
        d = self.degrees()
        return bool(np.all(d == d[0]))

    @property
    def radix(self) -> int:
        d = self.degrees()
        if not np.all(d == d[0]):
            raise ValueError(f"{self.name} is irregular (deg {d.min()}..{d.max()})")
        return int(d[0])

    # -- matrix forms -------------------------------------------------------
    def adjacency(self) -> np.ndarray:
        """Dense (n, n) float64 adjacency (small graphs / oracles only)."""
        A = np.zeros((self.n, self.n), dtype=np.float64)
        np.add.at(A, (self.edges[:, 0], self.edges[:, 1]), 1.0)
        np.add.at(A, (self.edges[:, 1], self.edges[:, 0]), 1.0)
        if self.loops is not None:
            A[np.arange(self.n), np.arange(self.n)] += self.loops
        return A

    def laplacian(self) -> np.ndarray:
        """Combinatorial Laplacian L = D - A.  Self-loops cancel (standard)."""
        A = self.adjacency()
        if self.loops is not None:       # loops do not change L: D and A both get w
            np.fill_diagonal(A, np.diag(A) - self.loops)
        D = np.diag(A.sum(axis=1))
        return D - A

    def normalized_laplacian(self) -> np.ndarray:
        L = self.laplacian()
        d = np.clip(L.diagonal().copy(), 1e-12, None)
        dinv = 1.0 / np.sqrt(d)
        return L * dinv[:, None] * dinv[None, :]

    # -- gather form for device-scale spectral work --------------------------
    def _slot_fill(self):
        """Vectorized slot assignment shared by the table builders.

        Returns ``(src, dst, slot, deg, k)`` where slot (i) runs over each
        vertex's table row in *edge-scan order* — the order a Python loop over
        ``self.edges`` would fill (u's slot before v's within one edge):
        row-major flattening of ``edges`` is exactly that scan order, and the
        stable argsort groups by vertex while preserving it.  O(m log m)
        instead of the former O(m) Python-level loop (the constant matters:
        datacenter-scale graphs have ~10^6 edges).
        """
        deg = np.bincount(self.edges.reshape(-1), minlength=self.n)
        k = int(deg.max()) if deg.size else 0
        src = self.edges.reshape(-1)                       # u0,v0,u1,v1,...
        dst = self.edges[:, ::-1].reshape(-1)              # v0,u0,v1,u1,...
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
        slot = np.arange(src.size) - starts[src]
        return src, dst, slot, deg, k

    def neighbor_table(self) -> np.ndarray:
        """(n, k) int32 table: row i lists the neighbors of i (with multiplicity).

        Requires regularity *excluding* loop weights; loop weights are handled
        separately by the matvec.  This is the operand format of the CUDA
        spmv kernel: ``(A x)[i] = sum_j x[table[i, j]] + loops[i]*x[i]``.
        Cached per instance (edge lists never mutate after construction).
        """
        cached = self.__dict__.get("_neighbor_table_cache")
        if cached is not None:
            return cached
        src, dst, slot, deg, k = self._slot_fill()
        if not np.all(deg == k):
            raise ValueError(f"{self.name}: neighbor_table needs edge-regularity;"
                             " use gather_operands() for loop-regularized graphs")
        table = np.empty((self.n, k), dtype=np.int32)
        table[src, slot] = dst.astype(np.int32)
        self.__dict__["_neighbor_table_cache"] = table
        return table

    def gather_operands(self):
        """(table, loop_weights) valid for ANY multigraph: rows with fewer
        edge-neighbors are padded with the vertex's own index and the padding
        is compensated in the returned loop weights, so
        ``(A x)[i] = sum_j x[table[i,j]] + w[i] * x[i]`` holds exactly.
        Cached per instance (edge lists never mutate after construction)."""
        cached = self.__dict__.get("_gather_operands_cache")
        if cached is not None:
            return cached
        src, dst, slot, deg, k = self._slot_fill()
        table = np.repeat(np.arange(self.n, dtype=np.int32)[:, None], k, axis=1)
        table[src, slot] = dst.astype(np.int32)
        pad = (k - deg).astype(np.float64)
        w = (self.loops if self.loops is not None else np.zeros(self.n)) - pad
        self.__dict__["_gather_operands_cache"] = (table, w)
        return table, w

    # -- misc ---------------------------------------------------------------
    def edge_count_between(self, X: np.ndarray, Y: np.ndarray) -> float:
        """e(X, Y) of the paper's discrepancy property (loops ignored).

        Counts edges with one endpoint in X and the other in Y; edges inside
        X ∩ Y are counted twice, matching the spectral convention.
        """
        inX = np.zeros(self.n, dtype=bool)
        inX[X] = True
        inY = np.zeros(self.n, dtype=bool)
        inY[Y] = True
        u, v = self.edges[:, 0], self.edges[:, 1]
        return float(np.sum(inX[u] & inY[v]) + np.sum(inY[u] & inX[v]))

    def __repr__(self) -> str:  # pragma: no cover
        return f"Topology({self.name}, n={self.n}, m={self.m})"
