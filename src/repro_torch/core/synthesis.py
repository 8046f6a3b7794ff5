"""Topology synthesis: batched search for maximum-spectral-gap graphs
(PyTorch port of the reference module).

The paper's conclusion — every surveyed topology sits well below the
Ramanujan spectral-gap optimum — "suggests the potential utility of adopting
Ramanujan graphs as interconnection networks."  This module *designs* such
networks at a target (n, k), along the two constructive paths of the
literature:

* **Bilu–Linial lifts** (the Xpander line): repeatedly 2-lift a small seed,
  choosing each edge signing to minimize the top eigenvalue of the signed
  adjacency A_s (spec(2-lift) = spec(A) ∪ spec(A_s)).  The signed objective
  runs in the padded gather-table contract — one shared (n, k) table plus
  per-candidate (B, n, k) slot signs — so B candidate signings cost ONE
  batched Lanczos solve (:func:`repro_torch.core.spectral.
  signed_extremes_batched`), whose matvec is kernel K1's signed form over a
  (B, n) batch on the card.  A simulated-annealing single-flip refinement
  loop re-estimates all B candidates per step with a warm-started small
  Lanczos solve, batched the same way.

* **Degree-preserving rewiring** (Markov-chain double-edge swaps): for sizes
  a lift tower cannot reach, hill-climb over the double-edge-swap chain from
  a random regular graph, scoring each candidate batch with one batched
  Laplacian Lanczos solve (:func:`repro_torch.core.spectral.
  rho2_laplacian_batched`).

:func:`synthesize` wraps both and returns a :class:`SynthesisResult`; the
products register as the ``xpander`` and ``rewired`` families, so
``Analysis``, ``survey()`` and ``routing()/traffic()`` consume designed
topologies like surveyed ones.  Every entry point takes ``device=``
(default ``"cuda"``).

Randomness.  Numpy draws are the reference's own (``default_rng(seed)``:
the candidate signings, the swap proposals), so they are bit-identical.  The
reference's annealing draws come from ``jax.random``; the private
:func:`_anneal_signings` takes its draws as tensors — start vectors (B, n),
flip indices (steps, B), uniforms (steps, B) — and :func:`_anneal_draws`
makes the reference's own draws without JAX (:mod:`.threefry`: the same
``split`` chain, ``randint`` and ``uniform`` bit for bit, the start
vectors to a few float32 ulps), on the host, for every device.  The exact
scores are 90-step float32 Lanczos estimates, whose error (up to ~1e-2 at
n = 32768) exceeds some levels' gaps between candidates, so the winner
depends on the start vectors; those are the reference's own draws on every
device (:func:`repro_torch.core.spectral._start_vectors`), and a level's
winner differs from the reference's only where two scores lie within
float32 rounding of each other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, resolve_device

from ..api.registry import register
from ..kernels import spmv as KS
from . import bounds as B
from . import spectral as S
from . import threefry as TF
from .graphs import Topology
from .lifts import two_lift

__all__ = [
    "SynthesisResult", "synthesize", "lift_search", "rewire_search",
    "best_signing_batched", "signed_slot_operands", "double_edge_swaps",
    "xpander", "rewired",
]

Device = Union[str, torch.device, None]

#: candidate signings / graphs evaluated per batched solve
DEFAULT_BATCH = 24
#: default refinement budgets (see ``synthesize``'s ``budget`` docs)
DEFAULT_LIFT_BUDGET = 2400
DEFAULT_REWIRE_BUDGET = 288


# --------------------------------------------------------------------------
# signed-adjacency operands: the lifts.py objective in gather-table form
# --------------------------------------------------------------------------

def signed_slot_operands(topo: Topology) -> Tuple[np.ndarray, np.ndarray]:
    """(table (n, k) int32, edge_slot (n, k) int32) for an edge-regular graph.

    ``table`` is the standard neighbor table; ``edge_slot[i, j]`` is the row
    index into ``topo.edges`` that produced slot (i, j), so a batch of
    signings (B, m) expands to per-slot signs with ONE gather —
    ``signings[:, edge_slot]`` — placing each edge's sign into both of its
    table slots (``lifts._signed_adjacency`` in the operand contract).
    """
    if topo.loops is not None and np.any(topo.loops):
        raise ValueError(f"{topo.name}: signed lifts need a loop-free graph")
    src = np.concatenate([topo.edges[:, 0], topo.edges[:, 1]])
    dst = np.concatenate([topo.edges[:, 1], topo.edges[:, 0]])
    eid = np.tile(np.arange(topo.m, dtype=np.int32), 2)
    order = np.argsort(src, kind="stable")
    src, dst, eid = src[order], dst[order], eid[order]
    deg = np.bincount(src, minlength=topo.n)
    k = int(deg.max())
    if not np.all(deg == k):
        raise ValueError(f"{topo.name}: signed lifts need an edge-regular graph")
    starts = np.concatenate([[0], np.cumsum(deg)])
    slot = np.arange(src.size) - starts[src]
    table = np.empty((topo.n, k), dtype=np.int32)
    edge_slot = np.empty((topo.n, k), dtype=np.int32)
    table[src, slot] = dst.astype(np.int32)
    edge_slot[src, slot] = eid
    return table, edge_slot


# --------------------------------------------------------------------------
# simulated-annealing flip refinement, batched over candidates
# --------------------------------------------------------------------------

def _lam_estimator(table: torch.Tensor, shift: float, est_iters: int,
                   objective: str, backend: Optional[str] = None):
    """Objective estimate of B candidates: a small warm-started Lanczos
    solve over the (B, n) batch.

    For ``objective="gap"`` the operator is A_s + shift·I (PSD for
    shift >= k) and the estimate is its top Ritz value − shift, i.e.
    lambda_max(A_s).  For ``"radius"`` the raw A_s tridiagonal is read at
    both ends, max(|lambda_min|, lambda_max).  The signed matvec is the spmv
    dispatcher's ``signs=`` form (K1 on the card).  ``est(slot_signs
    (B, n, k), v0 (B, n))`` returns (estimates (B,), next warm vectors
    (B, n)).
    """
    def est(slot_signs: torch.Tensor, v0: torch.Tensor):
        bk = KS.resolve_backend(backend, v0.device)

        def op(x):
            y = KS.spmv(x, table, signs=slot_signs, backend=bk)
            if objective == "gap":
                y = y + shift * x
            return y

        a, b, V = S._lanczos_scan(op, v0, est_iters)
        off = b[:, :-1]
        T = torch.diag_embed(a) + torch.diag_embed(off, 1) + \
            torch.diag_embed(off, -1)
        w, y = torch.linalg.eigh(T)                     # ascending
        if objective == "gap":
            lam = w[:, -1] - shift
            top = y[:, :, -1]
        else:
            idx = w.abs().argmax(dim=1, keepdim=True)   # (B, 1)
            lam = w.abs().gather(1, idx)[:, 0]
            top = y.gather(2, idx[:, None, :].expand(-1, est_iters, 1))[:, :, 0]
        ritz = torch.bmm(V[:, :est_iters].transpose(1, 2),
                         top.unsqueeze(2)).squeeze(2)   # (B, n)
        nrm = torch.linalg.vector_norm(ritz, dim=1, keepdim=True)
        ok = nrm > 1e-6
        ritz = torch.where(ok, ritz / torch.where(ok, nrm, 1.0), v0)
        return lam, ritz

    return est


def _anneal_signings(table: torch.Tensor, edge_slot: torch.Tensor,
                     signings: torch.Tensor, v0s: torch.Tensor,
                     flips: torch.Tensor, uniforms: torch.Tensor,
                     shift: float, temp0: float, *, est_iters: int,
                     objective: str, backend: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SA single-flip refinement of B signings, on their device.

    ``table`` (n, k) int32, ``edge_slot`` (n, k) int64, ``signings`` (B, m)
    float32 ±1, and the draws: ``v0s`` (B, n) float32 start vectors,
    ``flips`` (steps, B) edge indices, ``uniforms`` (steps, B) float32 in
    [0, 1).  Step t flips one edge sign per candidate, re-estimates the
    objective warm-started from the last accepted Ritz vector, and accepts
    downhill moves always and uphill moves with probability
    exp(-delta / T_t) under geometric cooling from ``temp0`` (float32, as in
    the reference).  Estimates are noisy by design: the caller re-scores
    refined AND original candidates exactly and keeps the winner.  Returns
    (refined signings (B, m), estimates (B,)).
    """
    obs.count("synthesis/anneal_steps", int(flips.shape[0]))
    steps, Bc = int(flips.shape[0]), int(signings.shape[0])
    dev = signings.device
    est = _lam_estimator(table, shift, est_iters, objective, backend)
    obj, vecs = est(signings[:, edge_slot], v0s)
    rows = torch.arange(Bc, device=dev)
    temps = torch.tensor(temp0, dtype=torch.float32, device=dev) * torch.exp(
        -3.0 * torch.arange(steps, dtype=torch.float32, device=dev) / steps)
    for t in range(steps):
        flipped = signings.clone()
        flipped[rows, flips[t]] *= -1.0
        new_obj, new_vecs = est(flipped[:, edge_slot], vecs)
        accept = (new_obj < obj) | (uniforms[t] < torch.exp(
            -(new_obj - obj) / torch.clamp(temps[t], min=1e-9)))
        signings = torch.where(accept[:, None], flipped, signings)
        obj = torch.where(accept, new_obj, obj)
        vecs = torch.where(accept[:, None], new_vecs, vecs)
    return signings, obj


def _anneal_draws(seed: int, batch: int, n: int, m: int, steps: int,
                  dev: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference annealer's own ``jax.random`` draws for ``seed``, in
    its order (:mod:`.threefry`): ``key, k0 = split(PRNGKey(seed))``, start
    vectors ``normal(k0, (batch, n))``, then per step ``key, k1, k2 =
    split(key, 3)``, flip indices ``randint(k1, (batch,), 0, m)`` and
    uniforms ``uniform(k2, (batch,))``.  Drawn on the host and moved to
    ``dev`` once, so every device anneals from the same numbers: start
    vectors (batch, n) float32, flips (steps, batch) int64, uniforms
    (steps, batch) float32."""
    key, k0 = TF.split(TF.prng_key(seed))
    v0s = TF.normal(k0, (batch, n), torch.device("cpu"))
    flips = np.empty((steps, batch), dtype=np.int64)
    uniforms = np.empty((steps, batch), dtype=np.float32)
    for t in range(steps):
        key, k1, k2 = TF.split(key, 3)
        flips[t] = TF.randint(k1, (batch,), 0, m)
        uniforms[t] = TF.uniform(k2, (batch,))
    return (v0s.to(dev), torch.from_numpy(flips).to(dev),
            torch.from_numpy(uniforms).to(dev))


def best_signing_batched(topo: Topology, batch: int = DEFAULT_BATCH,
                         steps: int = 400, est_iters: int = 10,
                         iters: int = 90, seed: int = 0,
                         temp0: float = 0.05, objective: str = "gap", *,
                         device: Device = DEFAULT_DEVICE
                         ) -> Tuple[np.ndarray, float, float]:
    """Best of ``batch`` random signings after SA flip refinement.

    The candidates are numpy draws (``default_rng(seed)``, as the
    reference's); the annealing draws are the reference's jax.random
    draws (:func:`_anneal_draws`).  Refined ∪ initial candidates are
    scored together by one :func:`repro_torch.core.spectral.
    signed_extremes_batched` call, so refinement can only help.  Returns
    (signing (m,) float ±1, lambda_max(A_s), signed spectral radius) of the
    winner under ``objective`` ("gap" minimizes lambda_max — the lift-rho2
    criterion; "radius" minimizes max|eig| — the Ramanujan criterion).
    """
    if objective not in ("gap", "radius"):
        raise ValueError(f"unknown signing objective {objective!r}")
    dev = resolve_device(device)
    table, edge_slot = signed_slot_operands(topo)
    rng = np.random.default_rng(seed)
    init = rng.choice([-1.0, 1.0], size=(batch, topo.m)).astype(np.float32)
    if steps > 0:
        v0s, flips, uniforms = _anneal_draws(seed, batch, topo.n, topo.m,
                                             steps, dev)
        refined, _ = _anneal_signings(
            torch.as_tensor(table, dtype=torch.int32, device=dev),
            torch.as_tensor(edge_slot, dtype=torch.int64, device=dev),
            torch.as_tensor(init, device=dev), v0s, flips, uniforms,
            float(topo.radix), temp0, est_iters=est_iters,
            objective=objective)
        refined = np.sign(refined.cpu().numpy().astype(np.float64))
        cands = np.concatenate([refined, init], axis=0)
    else:
        cands = init
    slot_signs = cands[:, edge_slot]
    lmax, lmin = S.signed_extremes_batched(table, slot_signs, iters=iters,
                                           seed=seed + 1, device=dev)
    radius = np.maximum(np.abs(lmin), lmax)
    score = lmax if objective == "gap" else radius
    best = int(np.argmin(score))
    return cands[best].astype(np.float64), float(lmax[best]), float(radius[best])


# --------------------------------------------------------------------------
# degree-preserving double-edge-swap rewiring
# --------------------------------------------------------------------------

def double_edge_swaps(edges: np.ndarray, swaps: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Apply ``swaps`` random degree-preserving double-edge swaps.

    The classic Markov-chain move on simple graphs: edges {a,b}, {c,d} become
    {a,c}, {b,d} (orientation randomized), rejected when it would create a
    self-loop or parallel edge, so the result is again simple with the exact
    same degree sequence.  Caps proposals at 20x ``swaps``.
    """
    e = np.array(edges, dtype=np.int64, copy=True)
    m = e.shape[0]
    eset = {tuple(sorted(row)) for row in e.tolist()}
    if len(eset) != m:
        raise ValueError("double_edge_swaps needs a simple graph")
    done = attempts = 0
    while done < swaps and attempts < 20 * swaps:
        attempts += 1
        i, j = rng.integers(0, m, size=2)
        if i == j:
            continue
        a, b = e[i]
        c, d = e[j]
        if rng.random() < 0.5:
            c, d = d, c
        if a == c or b == d:
            continue
        n1, n2 = tuple(sorted((int(a), int(c)))), tuple(sorted((int(b), int(d))))
        if n1 in eset or n2 in eset:
            continue
        eset.discard(tuple(sorted((int(a), int(b)))))
        eset.discard(tuple(sorted((int(c), int(d)))))
        eset.add(n1)
        eset.add(n2)
        e[i] = n1
        e[j] = n2
        done += 1
    return e


def _padded_operands(n: int, edges: np.ndarray, width: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather operands of a loop-free graph at an imposed table width (the
    reference's ``faults._padded_operands``): (table (n, width) int32,
    w (n,) float64 padding compensation, deg (n,) float64)."""
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n)
    starts = np.concatenate([[0], np.cumsum(deg)])
    slot = np.arange(src.size) - starts[src]
    table = np.repeat(np.arange(n, dtype=np.int32)[:, None], width, axis=1)
    table[src, slot] = dst.astype(np.int32)
    w = -(width - deg).astype(np.float64)
    return table, w, deg.astype(np.float64)


def _batched_rho2_edges(n: int, edge_sets: Sequence[np.ndarray], iters: int,
                        seed: int, *, device: Device = DEFAULT_DEVICE
                        ) -> np.ndarray:
    """rho2 of B same-order graphs given as edge arrays, one batched solve
    (the reference stacks them with ``faults.stacked_operands``)."""
    width = max(max(int(np.bincount(e.reshape(-1), minlength=n).max())
                    for e in edge_sets), 1)
    tabs, ws, degs = zip(*(_padded_operands(n, np.asarray(e), width)
                           for e in edge_sets))
    return S.rho2_laplacian_batched(np.stack(tabs), np.stack(ws),
                                    np.stack(degs), iters=iters, seed=seed,
                                    device=device)


# --------------------------------------------------------------------------
# the two search drivers + synthesize()
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SynthesisResult:
    """Outcome of one topology-design search."""
    topo: Topology              # the best graph found (regular, simple)
    method: str                 # "lift" or "rewire"
    n: int
    k: int
    rho2: float                 # measured on topo (dense or Lanczos verified)
    ramanujan_rho2: float       # k - 2 sqrt(k-1), the design optimum
    gap_fraction: float         # rho2 / ramanujan_rho2
    trajectory: List[float]     # predicted rho2 after each search stage
    evaluations: int            # candidate signings/graphs scored exactly
    seconds: float

    def to_dict(self) -> Dict:
        """JSON-ready summary (the topology itself is not serialized)."""
        return dict(name=self.topo.name, method=self.method, n=self.n,
                    k=self.k, rho2=round(self.rho2, 6),
                    ramanujan_rho2=round(self.ramanujan_rho2, 6),
                    gap_fraction=round(self.gap_fraction, 6),
                    trajectory=[round(x, 6) for x in self.trajectory],
                    evaluations=self.evaluations,
                    seconds=round(self.seconds, 3))

    def report(self) -> str:
        """Compact text block for CLI reports."""
        return "\n".join([
            f"synthesized     : {self.topo.name} (method={self.method})",
            f"nodes / radix   : {self.n} / {self.k}",
            f"rho2 (measured) : {self.rho2:.5f}",
            f"Ramanujan rho2  : {self.ramanujan_rho2:.5f} "
            f"({100 * self.gap_fraction:.1f}% achieved)",
            f"search          : {self.evaluations} exact evaluations, "
            f"{len(self.trajectory)} stages, {self.seconds:.1f}s",
        ])


def _lift_seed(n: int, k: int, seed: int) -> Tuple[Topology, int]:
    """Smallest valid 2-lift tower base: n = n0 * 2^t with n0 >= k+1 and
    n0*k even.  Returns (seed topology, t)."""
    from .topologies import complete, random_regular

    n0, t = n, 0
    while n0 % 2 == 0 and n0 // 2 >= k + 1 and ((n0 // 2) * k) % 2 == 0:
        n0 //= 2
        t += 1
    if t == 0:
        raise ValueError(
            f"lift synthesis cannot reach n={n} at k={k} (need n = n0 * 2^t "
            f"with n0 >= {k + 1} and n0*k even); use method='rewire'")
    g = complete(k + 1) if n0 == k + 1 else random_regular(n0, k, seed=seed)
    return g, t


@obs.traced("synthesis/lift_search", phase="execute")
def lift_search(n: int, k: int, budget: int = DEFAULT_LIFT_BUDGET,
                batch: int = DEFAULT_BATCH, seed: int = 0,
                iters: int = 90, *, device: Device = DEFAULT_DEVICE
                ) -> Tuple[Topology, List[float], int]:
    """Grow an (n, k) expander by a tower of best-signed 2-lifts.

    ``budget`` is the total SA flip-refinement steps, split evenly across the
    tower's levels; each level additionally spends ``2 * batch`` exact signed
    Lanczos evaluations (one batched solve on ``device``).  The rho2
    trajectory uses the Bilu–Linial identity — lambda_2(lift) =
    max(lambda_2(base), lambda_max(A_s)) — so no intermediate full solves
    are needed.  Returns (topology, trajectory, exact evaluations).
    """
    g, t = _lift_seed(n, k, seed)
    lam2 = float(np.sort(S.adjacency_spectrum(g))[-2])
    traj = [k - lam2]
    lams, evals = [], 0
    steps = max(budget // t, 0)
    for lvl in range(t):
        s, top, _radius = best_signing_batched(
            g, batch=batch, steps=steps, iters=iters, seed=seed + 7 * lvl,
            objective="gap", device=device)
        evals += 2 * batch if steps > 0 else batch
        g = two_lift(g, s)
        lams.append(top)
        lam2 = max(lam2, top)
        traj.append(k - lam2)
    g.name = f"xpander({n},{k})"
    g.meta["lift_lams"] = lams
    g.meta["k"] = k
    g.meta["seed"] = seed
    return g, traj, evals


@obs.traced("synthesis/rewire_search", phase="execute")
def rewire_search(n: int, k: int, budget: int = DEFAULT_REWIRE_BUDGET,
                  batch: int = DEFAULT_BATCH, seed: int = 0,
                  iters: int = 160, swap_fraction: float = 0.05, *,
                  device: Device = DEFAULT_DEVICE
                  ) -> Tuple[Topology, List[float], int]:
    """Hill-climb the double-edge-swap Markov chain toward maximum rho2.

    Starts from a random k-regular graph; each round proposes ``batch``
    candidates (each ``swap_fraction * m`` swaps away from the incumbent) and
    scores incumbent + candidates in ONE batched Laplacian Lanczos solve on
    ``device``, moving to the best.  ``budget`` is the total candidate
    evaluations (rounds = budget // (batch + 1)).  Reaches any (n, k) with
    n*k even.  Returns (topology, rho2 trajectory, exact evaluations).
    """
    from .topologies import random_regular

    if (n * k) % 2 or n <= k:
        raise ValueError(f"no {k}-regular graph on {n} vertices")
    rng = np.random.default_rng(seed)
    g = random_regular(n, k, seed=seed)
    edges = g.edges
    swaps = max(1, int(round(swap_fraction * edges.shape[0])))
    rounds = max(budget // (batch + 1), 1)
    rho2_cur = float(_batched_rho2_edges(n, [edges], iters, seed,
                                         device=device)[0])
    traj = [rho2_cur]
    evals = 1
    for rnd in range(rounds):
        cands = [double_edge_swaps(edges, swaps, rng) for _ in range(batch)]
        vals = _batched_rho2_edges(n, [edges] + cands, iters, seed + 1 + rnd,
                                   device=device)
        evals += batch + 1
        best = int(np.argmax(vals))
        if best > 0:
            edges = cands[best - 1]
        rho2_cur = float(vals[best])
        traj.append(rho2_cur)
    topo = Topology(f"rewired({n},{k})", n, edges,
                    meta=dict(k=k, seed=seed, swaps_per_candidate=swaps))
    return topo, traj, evals


def synthesize(n: int, k: int, method: str = "lift",
               budget: Optional[int] = None, batch: int = DEFAULT_BATCH,
               seed: int = 0, iters: Optional[int] = None, *,
               device: Device = DEFAULT_DEVICE) -> SynthesisResult:
    """Design a k-regular n-vertex topology with maximum spectral gap.

    ``method="lift"`` grows a Bilu–Linial 2-lift tower (needs n = n0 * 2^t);
    ``method="rewire"`` runs the degree-preserving double-edge-swap search
    (any n*k even).  ``budget`` scales search effort: total SA flip steps
    (lift, default 2400) or total candidate evaluations (rewire, default
    288).  The returned :class:`SynthesisResult` carries the measured rho2
    (re-verified on the final graph: dense on the host up to
    ``spectral.DENSE_THRESHOLD``, Lanczos on ``device`` above), the
    per-stage rho2 trajectory, and the achieved fraction of the
    Ramanujan-bound gap ``k - 2 sqrt(k-1)``.
    """
    if k < 3:
        raise ValueError("synthesis needs radix k >= 3")
    dev = resolve_device(device)
    t0 = time.time()
    if method == "lift":
        topo, traj, evals = lift_search(
            n, k, budget=DEFAULT_LIFT_BUDGET if budget is None else budget,
            batch=batch, seed=seed, iters=iters or 90, device=dev)
    elif method == "rewire":
        topo, traj, evals = rewire_search(
            n, k, budget=DEFAULT_REWIRE_BUDGET if budget is None else budget,
            batch=batch, seed=seed, iters=iters or 160, device=dev)
    else:
        raise ValueError(f"unknown synthesis method {method!r} "
                         "(known: 'lift', 'rewire')")
    rho2 = S.algebraic_connectivity(topo, seed=seed, device=dev)
    opt = B.ramanujan_rho2(k)
    return SynthesisResult(
        topo=topo, method=method, n=topo.n, k=k, rho2=rho2,
        ramanujan_rho2=opt, gap_fraction=rho2 / opt, trajectory=traj,
        evaluations=evals, seconds=time.time() - t0)


# --------------------------------------------------------------------------
# first-class registry families: designed topologies survey like built ones
# --------------------------------------------------------------------------

def _cf_xpander(n: int, k: int, seed: int = 0,
                budget: int = DEFAULT_LIFT_BUDGET) -> dict:
    return dict(nodes=n, radix=k)


def _cf_rewired(n: int, k: int, seed: int = 0,
                budget: int = DEFAULT_REWIRE_BUDGET) -> dict:
    return dict(nodes=n, radix=k)


@register("xpander", params=dict(n=int, k=int, seed=int, budget=int),
          defaults=dict(seed=0, budget=DEFAULT_LIFT_BUDGET),
          closed_forms=_cf_xpander, default_instance="xpander(32,4,0,160)")
def xpander(n: int, k: int, seed: int = 0,
            budget: int = DEFAULT_LIFT_BUDGET, *,
            device: Device = DEFAULT_DEVICE) -> Topology:
    """Lift-synthesized expander: best-signed Bilu–Linial 2-lift tower at
    (n, k), searched on ``device``."""
    res = synthesize(n, k, method="lift", budget=budget, seed=seed,
                     device=device)
    res.topo.meta["synthesis"] = res.to_dict()
    return res.topo


@register("rewired", params=dict(n=int, k=int, seed=int, budget=int),
          defaults=dict(seed=0, budget=DEFAULT_REWIRE_BUDGET),
          closed_forms=_cf_rewired, default_instance="rewired(40,4,0,80)")
def rewired(n: int, k: int, seed: int = 0,
            budget: int = DEFAULT_REWIRE_BUDGET, *,
            device: Device = DEFAULT_DEVICE) -> Topology:
    """Rewire-synthesized expander: double-edge-swap rho2 hill-climb at
    (n, k), scored on ``device``."""
    res = synthesize(n, k, method="rewire", budget=budget, seed=seed,
                     device=device)
    res.topo.meta["synthesis"] = res.to_dict()
    return res.topo
