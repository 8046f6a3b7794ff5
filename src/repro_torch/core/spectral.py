"""Spectral solvers: dense oracles (numpy, float64) + device-scale Lanczos (torch).

The dense path is the test oracle and handles n <= ~4096; it stays on the
host in float64, as in the reference.  The Lanczos path is the production
solver: it never materializes the n x n matrix — the adjacency operator of a
regular (multi)graph is applied through the (n, k) neighbor table,
``(A x)[i] = sum_j x[table[i, j]] + loops[i] * x[i]``, routed through the
spmv dispatcher (:mod:`repro_torch.kernels.spmv`): kernel K1 on the card,
the plain PyTorch gather-sum on the CPU.

Every Lanczos recurrence here is one batched loop over (B, n) vectors (a
single graph is B = 1): the reference's ``vmap`` is a batch dimension written
out.  The loop never waits for the device — the breakdown test is a
``torch.where`` — and alpha/beta come to the host once per solve, for the
float64 tridiagonal eigensolve.  Start vectors are the reference's own
``jax.random.normal(PRNGKey(seed), shape)`` draws, recomputed without JAX
(:mod:`.threefry`) on every device: an argmin over unconverged scores (the
lift tower's signed solves) then picks what the reference picks, and the
CPU and the card start from the same vectors.

The batched solvers stream their (B, n, k) operand stacks in memory-bounded
batch tiles (:data:`DEFAULT_BATCH_TILE_BYTES`), each through
``launch.mesh.shard_batch`` where the reference calls it (the identity
within one process: one rank drives one device).

Relations used throughout (k-regular G):  rho_2 = k * mu_2 = k - lambda_2.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse import csgraph

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import spmv as KS
from repro_torch.launch import mesh as _mesh

from . import threefry
from .graphs import Topology

__all__ = [
    "adjacency_spectrum", "laplacian_spectrum", "normalized_laplacian_spectrum",
    "algebraic_connectivity", "spectral_gap", "lambda_nontrivial",
    "fiedler_vector", "canonical_fiedler", "table_matvec", "lanczos_tridiag",
    "lanczos_extremes", "lanczos_top_ritz", "rho2_lanczos",
    "rho2_lanczos_batched", "rho2_laplacian_batched", "signed_extremes_batched",
    "fiedler_lanczos", "trivial_deflation", "DENSE_THRESHOLD",
    "DEFAULT_BATCH_TILE_BYTES",
]

Device = Union[str, torch.device, None]

#: graphs at or below this order use the dense float64 oracle; larger ones go
#: through the matrix-free Lanczos path.  The Analysis/survey API reads this
#: as its default auto-selection cutover.
DENSE_THRESHOLD = 4096

#: memory budget per batched-Lanczos tile: the batch axis of a (B, n, k)
#: operand stack is chunked so one tile's working set (per-sample Lanczos
#: basis (m+1, n) f32 + gather operands) stays under this many bytes.
DEFAULT_BATCH_TILE_BYTES = 256 << 20


def _batch_tile(B: int, n: int, k: int, m: int,
                batch_chunk: Optional[int]) -> int:
    """Samples per batched-Lanczos tile (explicit override or byte budget)."""
    if batch_chunk is not None:
        return max(1, min(int(batch_chunk), B))
    per_sample = 4 * n * (m + 2 * k + 16)   # V basis + operands + workspace
    return max(1, min(B, DEFAULT_BATCH_TILE_BYTES // max(per_sample, 1)))


# --------------------------------------------------------------------------
# dense oracles (host, float64)
# --------------------------------------------------------------------------

def adjacency_spectrum(topo: Topology) -> np.ndarray:
    return np.linalg.eigvalsh(topo.adjacency())


def laplacian_spectrum(topo: Topology) -> np.ndarray:
    return np.linalg.eigvalsh(topo.laplacian())


def normalized_laplacian_spectrum(topo: Topology) -> np.ndarray:
    return np.linalg.eigvalsh(topo.normalized_laplacian())


def algebraic_connectivity(topo: Topology, method: str = "auto",
                           iters: int = 200, seed: int = 0,
                           device: Device = DEFAULT_DEVICE) -> float:
    """rho_2: second-smallest Laplacian eigenvalue."""
    if method == "dense" or (method == "auto" and topo.n <= DENSE_THRESHOLD):
        return float(laplacian_spectrum(topo)[1])
    return rho2_lanczos(topo, iters=iters, seed=seed, device=device)


def spectral_gap(topo: Topology) -> float:
    """lambda_1 - lambda_2 of the adjacency matrix."""
    s = adjacency_spectrum(topo)
    return float(s[-1] - s[-2])


def lambda_nontrivial(topo: Topology) -> float:
    """lambda(G): largest |eigenvalue| != ±k (Definition 1)."""
    k = topo.radix
    s = adjacency_spectrum(topo)
    nontriv = s[np.abs(np.abs(s) - k) > 1e-6]
    return float(np.max(np.abs(nontriv)))


def fiedler_vector(topo: Topology) -> np.ndarray:
    """Eigenvector of L for rho_2 (dense path) — the bisection sweep witness."""
    w, v = np.linalg.eigh(topo.laplacian())
    return v[:, 1]


def _sign_canonical(vec: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """Flip ``vec`` so its first entry with |value| > tol is positive."""
    nz = np.flatnonzero(np.abs(vec) > tol)
    if nz.size and vec[nz[0]] < 0:
        return -vec
    return vec


def canonical_fiedler(topo: Topology, vector: Optional[np.ndarray] = None,
                      *, tol: float = 1e-6) -> np.ndarray:
    """A *deterministic* representative of the rho_2 Laplacian eigenspace.

    Dense path (``n <= DENSE_THRESHOLD``): recompute the full eigensystem,
    select every eigenvector with ``|w - rho_2| <= tol * max(1, |rho_2|)``
    (excluding the constant mode), and return the normalized projection of a
    fixed deterministic probe onto that eigenspace.  The projection is
    basis-invariant, so any eigensolver producing the same eigenspace yields
    the same vector — the input ``vector`` is ignored here by design.

    Above the dense threshold an exact eigenspace is unavailable; the provided
    Lanczos ``vector`` is returned sign-canonicalized.
    """
    n = topo.n
    if n > DENSE_THRESHOLD:
        if vector is None:
            raise ValueError("canonical_fiedler above DENSE_THRESHOLD needs "
                             "an explicit (Lanczos) vector")
        vec = np.asarray(vector, dtype=np.float64)
        nrm = np.linalg.norm(vec)
        if nrm > 0:
            vec = vec / nrm
        return _sign_canonical(vec)
    w, v = np.linalg.eigh(topo.laplacian())
    rho2 = w[1]
    member = np.abs(w - rho2) <= tol * max(1.0, abs(rho2))
    member[0] = False                      # never the constant mode
    basis = v[:, member]                   # (n, m) orthonormal eigenspace
    idx = np.arange(n, dtype=np.float64)
    probes = [idx / n, np.cos(idx), idx * idx / (n * n)]
    for probe in probes:
        rep = basis @ (basis.T @ probe)
        nrm = np.linalg.norm(rep)
        if nrm > tol:
            return _sign_canonical(rep / nrm)
    return _sign_canonical(v[:, 1])        # probes all orthogonal: fall back


# --------------------------------------------------------------------------
# bipartiteness (scipy BFS 2-colouring; the reference used networkx)
# --------------------------------------------------------------------------

def _two_colouring(topo: Topology) -> Tuple[np.ndarray, bool]:
    """(colour in {0, 1} per vertex, bipartite?) by level-synchronous BFS.

    Every connected component is coloured from its lowest-numbered vertex,
    which gets colour 1 (an isolated vertex gets 0) — the colours networkx's
    ``bipartite.color`` gives a bipartite graph.  The colouring is proper iff
    the graph is bipartite (self-loop weights are not edges and are ignored,
    as in the reference's networkx view of ``edges``).
    """
    n = topo.n
    u, v = topo.edges[:, 0], topo.edges[:, 1]
    A = sp.csr_matrix((np.ones(2 * u.size, dtype=np.int32),
                       (np.concatenate([u, v]), np.concatenate([v, u]))),
                      shape=(n, n))
    _, labels = csgraph.connected_components(A, directed=False)
    _, starts = np.unique(labels, return_index=True)
    colour = np.full(n, -1, dtype=np.int8)
    colour[starts] = np.diff(A.indptr)[starts] > 0
    frontier, level = starts, 0
    while frontier.size:
        level += 1
        nbrs = np.unique(A[frontier].indices)
        frontier = nbrs[colour[nbrs] < 0]
        colour[frontier] = (level + 1) & 1
    return colour, bool(np.all(colour[u] != colour[v]))


def _bipartite_sign(topo: Topology) -> np.ndarray:
    colour, ok = _two_colouring(topo)
    if not ok:
        raise ValueError(f"{topo.name} is not bipartite")
    return np.where(colour == 0, 1.0, -1.0)


def _is_bipartite(topo: Topology) -> bool:
    return _two_colouring(topo)[1]


def trivial_deflation(topo: Topology) -> list:
    """Deflation basis removing the trivial adjacency eigenpairs: the all-ones
    (+k) vector, plus the 2-coloring sign vector (-k) for bipartite graphs.

    Bipartiteness is detected (O(m) 2-coloring) rather than read from meta —
    even-k tori, hypercubes, etc. are bipartite without declaring it.
    """
    defl = [np.ones(topo.n)]
    if topo.meta.get("bipartite") or _is_bipartite(topo):
        defl.append(_bipartite_sign(topo))
    return defl


# --------------------------------------------------------------------------
# device-scale Lanczos
# --------------------------------------------------------------------------

def table_matvec(table: np.ndarray, loops: Optional[np.ndarray] = None,
                 backend: Optional[str] = None, *,
                 device: Device = DEFAULT_DEVICE
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Adjacency operator from an (n, k) neighbor table, routed through the
    spmv dispatcher (``backend`` ``"ref"`` / ``"cuda"``, resolved once)."""
    return KS.spmv_matvec(table, loops, backend=backend, device=device)


def _lanczos_scan(op: Callable[[torch.Tensor], torch.Tensor],
                  v0: torch.Tensor, m: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """m-step Lanczos recurrence with full (two-pass) reorthogonalization,
    over a batch of B independent recurrences.

    ``op`` maps (B, n) -> (B, n); ``v0`` is (B, n).  Returns
    (alpha (B, m), beta (B, m), V (B, m+1, n)), all on ``v0``'s device.
    At step j the reorthogonalization GEMVs read ``V[:, :j+1]``: the
    reference's masked product over all m+1 rows adds only exact zeros from
    the rows past j, so both give the same result.  A breakdown
    (beta <= 1e-7) zeroes the next basis vector and beta through
    ``torch.where`` on the device, as in the reference — no host sync.
    """
    B, n = v0.shape
    dev = v0.device
    v = v0.to(torch.float32)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    V = torch.zeros((B, m + 1, n), dtype=torch.float32, device=dev)
    V[:, 0] = v
    alphas = torch.empty((B, m), dtype=torch.float32, device=dev)
    betas = torch.empty((B, m), dtype=torch.float32, device=dev)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    for j in range(m):
        w = op(v) - beta_prev * v_prev
        alpha = (w * v).sum(dim=1, keepdim=True)
        w = w - alpha * v
        Vj = V[:, :j + 1]                                 # (B, j+1, n)
        for _ in range(2):  # two-pass full reorthogonalization
            coeff = torch.bmm(Vj, w.unsqueeze(2))         # (B, j+1, 1)
            w = w - torch.bmm(Vj.transpose(1, 2), coeff).squeeze(2)
        beta = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        ok = beta > 1e-7
        v_next = torch.where(ok, w / torch.where(ok, beta, 1.0),
                             torch.zeros_like(w))
        beta = torch.where(ok, beta, 0.0)
        V[:, j + 1] = v_next
        alphas[:, j] = alpha[:, 0]
        betas[:, j] = beta[:, 0]
        v_prev, v, beta_prev = v, v_next, beta
    return alphas, betas, V


def _lanczos_with_basis(matvec: Callable, v0: torch.Tensor, m: int,
                        deflate: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-operator Lanczos (P A P with P = I - D^T D when ``deflate``
    (d, n) is given).  ``v0``: (n,).  Returns (alpha (m,), beta (m,),
    V (m+1, n))."""
    def project(x):
        if deflate is not None:
            x = x - (x @ deflate.T) @ deflate
        return x

    def op(x):
        return project(matvec(project(x)))

    v = project(v0.to(torch.float32).unsqueeze(0))
    alphas, betas, V = _lanczos_scan(op, v, m)
    return alphas[0], betas[0], V[0]


def lanczos_tridiag(matvec: Callable, v0: torch.Tensor, m: int,
                    deflate: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """m-step Lanczos with full (two-pass) reorthogonalization.

    ``matvec`` maps (B, n) -> (B, n) (the closures of :func:`table_matvec`
    do); ``deflate``: optional (d, n) orthonormal rows projected out of the
    operator (P A P with P = I - D^T D), used to remove the trivial ±k
    eigenpairs.  Returns (alpha[m], beta[m-1]) of the symmetric tridiagonal T.
    """
    alphas, betas, _ = _lanczos_with_basis(matvec, v0, m, deflate)
    return alphas, betas[:-1]


def _tridiag_eigvals(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    m = len(alphas)
    T = np.zeros((m, m))
    T[np.arange(m), np.arange(m)] = np.asarray(alphas, dtype=np.float64)
    T[np.arange(m - 1), np.arange(1, m)] = np.asarray(betas, dtype=np.float64)
    T[np.arange(1, m), np.arange(m - 1)] = np.asarray(betas, dtype=np.float64)
    return np.linalg.eigvalsh(T)


def _start_vectors(shape: Tuple[int, ...], seed: int,
                   dev: torch.device) -> torch.Tensor:
    """The reference's f32 start vectors for ``seed``, on ``dev``."""
    return threefry.normal(seed, shape, dev)


def _deflation_rows(deflate_vectors: Optional[Sequence[np.ndarray]],
                    dev: torch.device) -> Optional[torch.Tensor]:
    """Orthonormal (d, n) f32 rows spanning ``deflate_vectors`` (tiny d x d
    QR on the host), or None."""
    if not deflate_vectors:
        return None
    D = np.stack([d / np.linalg.norm(d) for d in deflate_vectors])
    Q, _ = np.linalg.qr(D.T)
    return torch.as_tensor(Q.T, dtype=torch.float32, device=dev)


def lanczos_extremes(matvec: Callable, n: int, m: int = 200, seed: int = 0,
                     deflate_vectors: Optional[Sequence[np.ndarray]] = None,
                     *, device: Device = DEFAULT_DEVICE
                     ) -> Tuple[float, float]:
    """(lambda_max, lambda_min) of the (deflated) operator.  ``matvec``'s
    operands must live on ``device``."""
    dev = resolve_device(device)
    obs.count("lanczos/solves")
    obs.count("lanczos/iters", m)
    v0 = _start_vectors((n,), seed, dev)
    deflate = _deflation_rows(deflate_vectors, dev)
    alphas, betas = lanczos_tridiag(matvec, v0, m, deflate)
    ev = _tridiag_eigvals(alphas.cpu().numpy(), betas.cpu().numpy())
    return float(ev[-1]), float(ev[0])


def lanczos_top_ritz(matvec: Callable, n: int, m: int = 200, seed: int = 0,
                     deflate_vectors: Optional[Sequence[np.ndarray]] = None,
                     *, device: Device = DEFAULT_DEVICE
                     ) -> Tuple[float, np.ndarray]:
    """Top eigenpair (lambda_max, Ritz vector) of the (deflated) operator.

    The Ritz vector is V^T y for the top eigenvector y of the tridiagonal T —
    the matrix-free analogue of the dense ``fiedler_vector`` when the operator
    is the ones-deflated adjacency of a regular graph.
    """
    dev = resolve_device(device)
    obs.count("lanczos/solves")
    obs.count("lanczos/iters", m)
    v0 = _start_vectors((n,), seed, dev)
    deflate = _deflation_rows(deflate_vectors, dev)
    alphas, betas, V = _lanczos_with_basis(matvec, v0, m, deflate)
    alphas = alphas.cpu().numpy().astype(np.float64)
    betas = betas.cpu().numpy().astype(np.float64)[:-1]
    T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    w, y = np.linalg.eigh(T)
    ritz = V[:m].T @ torch.as_tensor(y[:, -1], dtype=torch.float32,
                                     device=dev)
    ritz = ritz.cpu().numpy().astype(np.float64)
    nrm = np.linalg.norm(ritz)
    if nrm > 0:
        ritz = ritz / nrm
    return float(w[-1]), ritz


@obs.traced("spectral/rho2_lanczos", phase="execute")
def rho2_lanczos(topo: Topology, iters: int = 200, seed: int = 0,
                 matvec: Optional[Callable] = None, *,
                 device: Device = DEFAULT_DEVICE) -> float:
    """rho_2 = k - lambda_2 for regular graphs, via ones-deflated Lanczos.

    For bipartite graphs the -k eigenpair is also deflated (sign vector from
    the 2-coloring) so the reported lambda_2 is the top *nontrivial* one.
    Note: assumes lambda_2 >= 0 (true for all surveyed topologies; dense path
    covers near-complete graphs where lambda_2 < 0).

    ``matvec``: optional replacement adjacency operator obeying the same
    padded gather-table contract, with its operands on ``device``; defaults
    to :func:`table_matvec` over ``gather_operands()``.
    """
    k = topo.radix
    if matvec is None:
        tab, w = topo.gather_operands()  # valid for any multigraph (loops folded)
        mv = table_matvec(tab, w, device=device)
    else:
        mv = matvec
    defl = [np.ones(topo.n)]
    if topo.meta.get("bipartite"):
        defl.append(_bipartite_sign(topo))
    lmax, _ = lanczos_extremes(mv, topo.n, m=iters, seed=seed,
                               deflate_vectors=defl, device=device)
    return float(k - lmax)


@obs.traced("spectral/fiedler_lanczos", phase="execute")
def fiedler_lanczos(topo: Topology, iters: int = 200, seed: int = 0, *,
                    device: Device = DEFAULT_DEVICE) -> np.ndarray:
    """Approximate Fiedler vector, matrix-free (device-scale graphs).

    For k-regular G the Laplacian eigenvector of rho_2 equals the adjacency
    eigenvector of lambda_2, which is the top Ritz vector of the ones-deflated
    adjacency operator.  Used by the Analysis/survey layer to witness
    bisections when n is too large for the dense eigendecomposition.
    """
    tab, w = topo.gather_operands()
    mv = table_matvec(tab, w, device=device)
    _, ritz = lanczos_top_ritz(mv, topo.n, m=iters, seed=seed,
                               deflate_vectors=[np.ones(topo.n)],
                               device=device)
    return ritz


def _lanczos_tridiag_batched(tables: torch.Tensor, weights: torch.Tensor,
                             v0s: torch.Tensor, m: int,
                             backend: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ones-deflated Lanczos over B same-shape neighbor tables at once.

    ``tables``: (B, n, k) int32, ``weights``: (B, n) float32 per-vertex loop
    weights, ``v0s``: (B, n) float32 start vectors, all on one device.
    Returns stacked (alphas (B, m), betas (B, m)).
    """
    bk = KS.resolve_backend(backend, v0s.device)

    def op(x):
        x = x - x.mean(dim=1, keepdim=True)             # project out ones
        y = KS.spmv(x, tables, weights, backend=bk)
        return y - y.mean(dim=1, keepdim=True)

    v0s = v0s.to(torch.float32)
    alphas, betas, _ = _lanczos_scan(op, v0s - v0s.mean(dim=1, keepdim=True),
                                     m)
    return alphas, betas


def _truncate_at_breakdown(alphas: np.ndarray, betas: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Cut (alpha, beta) at the first Lanczos breakdown (beta zeroed by the
    scan).  Steps past a breakdown contribute spurious zero rows to T, which
    are harmless when reading the *largest* Ritz value but poison the
    *smallest* one (the quantity the Laplacian path reports)."""
    zero = np.nonzero(betas == 0.0)[0]
    if zero.size:
        obs.count("lanczos/breakdown_truncations")
        keep = int(zero[0]) + 1
        return alphas[:keep], betas[:max(keep - 1, 0)]
    return alphas, betas[:-1]


def _batched_ritz_extremes(alphas: np.ndarray, betas: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(lambda_min, lambda_max) Ritz values per batch row, each row
    breakdown-truncated (:func:`_truncate_at_breakdown`) before the tridiag
    solve.  Shared readout for every batched-Lanczos path so breakdown
    handling cannot drift between them."""
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    B = alphas.shape[0]
    lmin = np.empty(B, dtype=np.float64)
    lmax = np.empty(B, dtype=np.float64)
    for i in range(B):
        a_i, b_i = _truncate_at_breakdown(alphas[i], betas[i])
        ev = _tridiag_eigvals(a_i, b_i)
        lmin[i], lmax[i] = float(ev[0]), float(ev[-1])
    return lmin, lmax


def _lap_lanczos_batched(tables: torch.Tensor, weights: torch.Tensor,
                         degs: torch.Tensor, v0s: torch.Tensor, m: int,
                         backend: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ones-deflated *Laplacian* Lanczos over B same-shape tables at once.

    The adjacency batch (:func:`_lanczos_tridiag_batched`) needs regular
    graphs; this one applies L = D - A through the padded gather form, so it
    is valid for the irregular graphs produced by fault injection.  ``degs``
    holds per-vertex degrees *including* signed self-loop weights, which makes
    ``deg * x - (gather + w * x)`` exactly L x (loops cancel).

    Deflation of the trivial 0 eigenpair (ones) is done by a rank-one SHIFT,
    not a projection: ``L + c * ones ones^T / n`` moves the ones eigenvalue to
    ``c = max_deg + 2 > rho2`` (Fiedler: rho2 <= vertex connectivity <=
    min degree, and rho2 = n = max_deg + 1 for K_n) and leaves every
    ones-orthogonal eigenpair untouched.  A projection would let float32
    roundoff reintroduce the ones component, whose ghost 0 Ritz value poisons
    the *smallest* eigenvalue — exactly the one this path reports.
    """
    bk = KS.resolve_backend(backend, v0s.device)
    c = degs.max(dim=1, keepdim=True).values + 2.0      # (B, 1)

    def op(x):
        lx = degs * x - KS.spmv(x, tables, weights, backend=bk)
        return lx + c * x.mean(dim=1, keepdim=True)

    alphas, betas, _ = _lanczos_scan(op, v0s, m)
    return alphas, betas


def _tile_indices(lo: int, hi: int, tile: int) -> Tuple[np.ndarray, int]:
    """Index vector for one batch tile, padded to ``tile`` samples by
    repeating sample ``lo`` so every tile has one shape (the padded rows are
    recomputed garbage, sliced off by the caller)."""
    idx = np.arange(lo, hi, dtype=np.int64)
    if idx.size < tile:
        idx = np.concatenate([idx, np.full(tile - idx.size, lo, np.int64)])
    return idx, hi - lo


@obs.traced("spectral/rho2_laplacian_batched", phase="execute")
def rho2_laplacian_batched(tables: np.ndarray, weights: np.ndarray,
                           degs: np.ndarray, iters: int = 160,
                           seed: int = 0, *,
                           batch_chunk: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Device = DEFAULT_DEVICE) -> np.ndarray:
    """rho_2 for B (possibly irregular) graphs in one *streamed* Lanczos solve.

    Operands are stacked padded gather forms — ``tables`` (B, n, k) int32,
    ``weights`` (B, n) per-vertex self weights (loop + padding compensation),
    ``degs`` (B, n) degrees including loop weights.  Returns the
    second-smallest Laplacian eigenvalue per graph (~0 for disconnected
    samples: the extra kernel vector survives the ones deflation).

    The batch axis streams through the solve in memory-bounded tiles
    (``batch_chunk`` samples each; default from
    :data:`DEFAULT_BATCH_TILE_BYTES`).  ``backend`` picks the spmv route.
    """
    dev = resolve_device(device)
    tables = np.asarray(tables)
    weights, degs = np.asarray(weights), np.asarray(degs)
    B, n, k = tables.shape
    obs.count("lanczos/solves", B)
    obs.count("lanczos/iters", B * iters)
    v0s = _start_vectors((B, n), seed, dev)
    tile = _batch_tile(B, n, k, iters, batch_chunk)
    alphas = np.empty((B, iters), dtype=np.float64)
    betas = np.empty((B, iters), dtype=np.float64)
    for lo in range(0, B, tile):
        idx, keep = _tile_indices(lo, min(lo + tile, B), tile)
        ops = _mesh.shard_batch(
            torch.as_tensor(tables[idx], dtype=torch.int32, device=dev),
            torch.as_tensor(weights[idx], dtype=torch.float32, device=dev),
            torch.as_tensor(degs[idx], dtype=torch.float32, device=dev),
            v0s[torch.as_tensor(idx, device=dev)])
        a, b = _lap_lanczos_batched(*ops, iters, backend=backend)
        alphas[lo:lo + keep] = a.cpu().numpy()[:keep]
        betas[lo:lo + keep] = b.cpu().numpy()[:keep]
    lmin, _ = _batched_ritz_extremes(alphas, betas)
    return np.maximum(lmin, 0.0)


def _signed_lanczos_batched(table: torch.Tensor, slot_signs: torch.Tensor,
                            v0s: torch.Tensor, m: int,
                            backend: Optional[str] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos on B *signed* adjacency operators sharing one table.

    ``table``: (n, k) int32 neighbor table of the base graph, shared across
    the batch; ``slot_signs``: (B, n, k) float32 per-slot ±1 signs (the
    signing of edge e written into both of e's table slots); ``v0s``: (B, n)
    start vectors.  The operator is ``(A_s x)[i] = sum_j s[i,j] x[table[i,j]]``
    — the Bilu–Linial signed adjacency in the padded gather-table contract,
    applied through the spmv dispatcher's ``signs=`` form.
    No deflation: a signing destroys the trivial ±k eigenpairs.
    """
    bk = KS.resolve_backend(backend, v0s.device)

    def op(x):
        return KS.spmv(x, table, signs=slot_signs, backend=bk)

    alphas, betas, _ = _lanczos_scan(op, v0s, m)
    return alphas, betas


@obs.traced("spectral/signed_extremes_batched", phase="execute")
def signed_extremes_batched(table: np.ndarray, slot_signs: np.ndarray,
                            iters: int = 90, seed: int = 0, *,
                            batch_chunk: Optional[int] = None,
                            backend: Optional[str] = None,
                            device: Device = DEFAULT_DEVICE
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(lambda_max, lambda_min) of B signed adjacencies in one streamed solve.

    By Bilu–Linial the eigenvalues of the signed adjacency A_s are exactly the
    NEW eigenvalues a 2-lift introduces, so ``lambda_max`` bounds the lift's
    lambda_2 and ``max(|lambda_min|, lambda_max)`` is the signed spectral
    radius.  Operands follow :func:`_signed_lanczos_batched`; returns float64
    arrays (lmax (B,), lmin (B,)), breakdown-truncated.  The batch streams in
    memory-bounded tiles like :func:`rho2_laplacian_batched`.
    """
    dev = resolve_device(device)
    slot_signs = np.asarray(slot_signs)
    B, n, k = slot_signs.shape
    obs.count("lanczos/solves", B)
    obs.count("lanczos/iters", B * iters)
    v0s = _start_vectors((B, n), seed, dev)
    tab = torch.as_tensor(np.asarray(table), dtype=torch.int32, device=dev)
    tile = _batch_tile(B, n, k, iters, batch_chunk)
    alphas = np.empty((B, iters), dtype=np.float64)
    betas = np.empty((B, iters), dtype=np.float64)
    for lo in range(0, B, tile):
        idx, keep = _tile_indices(lo, min(lo + tile, B), tile)
        sg, v0 = _mesh.shard_batch(
            torch.as_tensor(slot_signs[idx], dtype=torch.float32,
                            device=dev),
            v0s[torch.as_tensor(idx, device=dev)])
        a, b = _signed_lanczos_batched(tab, sg, v0, iters, backend=backend)
        alphas[lo:lo + keep] = a.cpu().numpy()[:keep]
        betas[lo:lo + keep] = b.cpu().numpy()[:keep]
    lmin, lmax = _batched_ritz_extremes(alphas, betas)
    return lmax, lmin


def rho2_lanczos_batched(topos: Sequence[Topology], iters: int = 200,
                         seed: int = 0, *,
                         device: Device = DEFAULT_DEVICE) -> list:
    """rho_2 for a batch of same-shape regular graphs in ONE batched solve.

    All topologies must share (n, table-width) so their neighbor tables stack;
    bipartite graphs are rejected (their -k pair needs per-graph deflation) —
    the survey layer routes those through :func:`rho2_lanczos` one by one.
    """
    if not topos:
        return []
    dev = resolve_device(device)
    shapes = set()
    tabs, lws = [], []
    for t in topos:
        if t.meta.get("bipartite"):
            raise ValueError(f"{t.name}: bipartite graphs cannot be batched")
        tab, w = t.gather_operands()
        shapes.add(tab.shape)
        tabs.append(tab)
        lws.append(w)
    if len(shapes) != 1:
        raise ValueError(f"neighbor tables must share one shape, got {shapes}")
    obs.count("lanczos/solves", len(topos))
    obs.count("lanczos/iters", len(topos) * iters)
    n = topos[0].n
    v0s = _start_vectors((len(topos), n), seed, dev)
    alphas, betas = _lanczos_tridiag_batched(
        torch.as_tensor(np.stack(tabs), dtype=torch.int32, device=dev),
        torch.as_tensor(np.stack(lws), dtype=torch.float32, device=dev),
        v0s, iters)
    alphas = alphas.cpu().numpy().astype(np.float64)
    betas = betas.cpu().numpy().astype(np.float64)
    out = []
    for i, t in enumerate(topos):
        ev = _tridiag_eigvals(alphas[i], betas[i][:-1])
        out.append(float(t.radix - ev[-1]))
    return out
