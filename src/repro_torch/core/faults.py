"""Fault models + batched degraded-operation spectral sweeps (PyTorch port
of the reference module).

The paper names fault tolerance as one of the three spectrally-controlled
properties of an interconnect (kappa >= rho_2, Fiedler), and §3's discrepancy
bounds are what guarantee bandwidth on a *degraded* machine.  This module asks
the operational question directly: what happens to rho_2, the guaranteed
bisection, and connectivity when links or routers die?

Four fault models produce :class:`FaultScenario` records (which links/nodes
fail), ``apply_faults`` materializes the degraded :class:`Topology`, and
:func:`fault_sweep` drives the whole pipeline: for each fault rate it draws B
Monte-Carlo samples, stacks their padded gather operands, and solves all B
degraded graphs in ONE batched Laplacian Lanczos call
(:func:`repro_torch.core.spectral.rho2_laplacian_batched`: kernel K1's
(B, n, k) table-stack form on the card).  Degraded graphs are irregular, so
the sweep runs on L = D - A rather than the regular-only adjacency batch.
Scenario draws are numpy's (``np.random.default_rng(seed)``), identical to
the reference's; the fault models and operand stacking run on the host.

Models
------
* ``link``            — iid random link failure (Monte-Carlo, seeded)
* ``node``            — iid random router failure; survivors are relabelled
* ``attack_degree``   — adversarial: kill the highest-degree routers first
* ``attack_spectral`` — adversarial: cut the links carrying the Fiedler
  Rayleigh quotient (largest (f_u - f_v)^2), the spectrally most damaging set
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, resolve_device

from . import bounds as B
from . import spectral as S
from .graphs import Topology

Device = Union[str, torch.device, None]

__all__ = [
    "FaultScenario", "FaultSweepResult", "FAULT_MODELS",
    "random_link_faults", "random_node_faults",
    "adversarial_degree_attack", "adversarial_spectral_attack",
    "apply_faults", "stacked_operands", "connected_component_count",
    "fault_sweep", "make_scenario",
]

FAULT_MODELS = ("link", "node", "attack_degree", "attack_spectral")

#: adversarial models are deterministic — one sample tells the whole story
DETERMINISTIC_MODELS = ("attack_degree", "attack_spectral")


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One concrete fault pattern: which links/nodes of a topology fail."""
    kind: str                   # one of FAULT_MODELS
    rate: float                 # requested fault fraction
    seed: int                   # RNG seed (0 for deterministic attacks)
    failed_links: np.ndarray    # (t,) int64 row indices into topo.edges
    failed_nodes: np.ndarray    # (f,) int64 vertex ids (empty for link models)

    @property
    def n_failed_links(self) -> int:
        return int(self.failed_links.size)

    @property
    def n_failed_nodes(self) -> int:
        return int(self.failed_nodes.size)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fault rate must be in [0, 1), got {rate}")


def random_link_faults(topo: Topology, rate: float, seed: int = 0
                       ) -> FaultScenario:
    """iid link failure: a uniform random ``round(rate * m)``-subset of edges."""
    _check_rate(rate)
    t = int(round(rate * topo.m))
    rng = np.random.default_rng(seed)
    failed = rng.choice(topo.m, size=t, replace=False) if t else \
        np.empty(0, dtype=np.int64)
    return FaultScenario(kind="link", rate=rate, seed=seed,
                         failed_links=np.sort(failed.astype(np.int64)),
                         failed_nodes=np.empty(0, dtype=np.int64))


def _incident_links(topo: Topology, nodes: np.ndarray) -> np.ndarray:
    dead = np.zeros(topo.n, dtype=bool)
    dead[nodes] = True
    hit = dead[topo.edges[:, 0]] | dead[topo.edges[:, 1]]
    return np.nonzero(hit)[0].astype(np.int64)


def random_node_faults(topo: Topology, rate: float, seed: int = 0
                       ) -> FaultScenario:
    """iid router failure: ``round(rate * n)`` random vertices (and every
    incident link) die; the degraded graph is the induced survivor subgraph."""
    _check_rate(rate)
    f = int(round(rate * topo.n))
    rng = np.random.default_rng(seed)
    nodes = rng.choice(topo.n, size=f, replace=False) if f else \
        np.empty(0, dtype=np.int64)
    nodes = np.sort(nodes.astype(np.int64))
    return FaultScenario(kind="node", rate=rate, seed=seed,
                         failed_links=_incident_links(topo, nodes),
                         failed_nodes=nodes)


def adversarial_degree_attack(topo: Topology, rate: float) -> FaultScenario:
    """Targeted router attack: the ``round(rate * n)`` highest-degree vertices
    (ties broken by vertex id) — the classic hub-removal adversary."""
    _check_rate(rate)
    f = int(round(rate * topo.n))
    deg = topo.degrees(include_loops=False)
    # stable sort on (-degree, id): highest degree first, lowest id on ties
    order = np.argsort(-deg, kind="stable")
    nodes = np.sort(order[:f].astype(np.int64))
    return FaultScenario(kind="attack_degree", rate=rate, seed=0,
                         failed_links=_incident_links(topo, nodes),
                         failed_nodes=nodes)


def _fiedler(topo: Topology, device: Device) -> np.ndarray:
    """Dense Fiedler vector up to the dense threshold, Lanczos above it."""
    return S.fiedler_vector(topo) if topo.n <= S.DENSE_THRESHOLD \
        else S.fiedler_lanczos(topo, device=device)


def adversarial_spectral_attack(topo: Topology, rate: float,
                                fiedler: Optional[np.ndarray] = None, *,
                                device: Device = DEFAULT_DEVICE
                                ) -> FaultScenario:
    """Spectrally-targeted link attack: cut the ``round(rate * m)`` edges with
    the largest Fiedler energy (f_u - f_v)^2.  Those edges carry the Rayleigh
    quotient of rho_2, so removing them is the greedy gap-minimizing cut.
    Without ``fiedler``, large graphs solve for it on ``device``."""
    _check_rate(rate)
    t = int(round(rate * topo.m))
    if fiedler is None:
        fiedler = _fiedler(topo, device)
    f = np.asarray(fiedler, dtype=np.float64)
    energy = (f[topo.edges[:, 0]] - f[topo.edges[:, 1]]) ** 2
    order = np.argsort(-energy, kind="stable")
    return FaultScenario(kind="attack_spectral", rate=rate, seed=0,
                         failed_links=np.sort(order[:t].astype(np.int64)),
                         failed_nodes=np.empty(0, dtype=np.int64))


def make_scenario(topo: Topology, model: str, rate: float, seed: int = 0,
                  fiedler: Optional[np.ndarray] = None, *,
                  device: Device = DEFAULT_DEVICE) -> FaultScenario:
    """One :class:`FaultScenario` of ``model`` at ``rate`` (seeded draws for
    the Monte-Carlo models; ``device`` only matters for a spectral attack
    that has to solve for its Fiedler vector)."""
    if model == "link":
        return random_link_faults(topo, rate, seed)
    if model == "node":
        return random_node_faults(topo, rate, seed)
    if model == "attack_degree":
        return adversarial_degree_attack(topo, rate)
    if model == "attack_spectral":
        return adversarial_spectral_attack(topo, rate, fiedler,
                                           device=device)
    raise ValueError(f"unknown fault model {model!r} (known: {FAULT_MODELS})")


def apply_faults(topo: Topology, sc: FaultScenario) -> Topology:
    """Materialize the degraded topology: failed links dropped, failed nodes
    removed with survivors relabelled 0..n_s-1 (``meta['survivors']`` keeps the
    original ids).  Healthy-only meta (vertex transitivity, spec/closed forms)
    is stripped — a degraded graph earns none of those certificates."""
    keep = np.ones(topo.m, dtype=bool)
    keep[sc.failed_links] = False
    edges = topo.edges[keep]
    loops = topo.loops
    n = topo.n
    meta = {k: v for k, v in topo.meta.items()
            if k not in ("vertex_transitive", "spec")}
    meta["fault"] = dict(kind=sc.kind, rate=sc.rate, seed=sc.seed,
                         failed_links=sc.n_failed_links,
                         failed_nodes=sc.n_failed_nodes)
    if sc.failed_nodes.size:
        alive = np.ones(topo.n, dtype=bool)
        alive[sc.failed_nodes] = False
        relabel = np.cumsum(alive) - 1
        edges = relabel[edges]
        loops = loops[alive] if loops is not None else None
        n = int(alive.sum())
        meta["survivors"] = np.nonzero(alive)[0]
    name = f"{topo.name}%{sc.kind}@{sc.rate:g}" + \
        (f"#{sc.seed}" if sc.kind not in DETERMINISTIC_MODELS else "")
    return Topology(name, n, edges, loops=loops, meta=meta)


# --------------------------------------------------------------------------
# stacked operands: B degraded graphs -> one (B, n, k) batched solve
# --------------------------------------------------------------------------

def _padded_operands(n: int, edges: np.ndarray, loops: Optional[np.ndarray],
                     width: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized :meth:`Topology.gather_operands` with an imposed table width
    (so samples of different max degree still stack).  Returns
    (table (n, width) int32, w (n,) float64, deg (n,) float64 incl. loops)."""
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n)
    if deg.size and deg.max() > width:
        raise ValueError(f"table width {width} < max degree {deg.max()}")
    starts = np.concatenate([[0], np.cumsum(deg)])
    slot = np.arange(src.size) - starts[src]
    table = np.repeat(np.arange(n, dtype=np.int32)[:, None], width, axis=1)
    table[src, slot] = dst.astype(np.int32)
    lo = loops if loops is not None else np.zeros(n)
    w = lo - (width - deg).astype(np.float64)
    # deg carries the SIGNED loop weight so deg*x - (gather + w*x) = L x
    # exactly (loops cancel in the combinatorial Laplacian)
    return table, w, deg.astype(np.float64) + lo


def stacked_operands(topos: Sequence[Topology], width: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack B same-order graphs into (tables (B,n,k), weights (B,n),
    degs (B,n)) — the operand block of one batched Laplacian solve."""
    ns = {t.n for t in topos}
    if len(ns) != 1:
        raise ValueError(f"stacked graphs must share n, got {sorted(ns)}")
    n = ns.pop()
    if width is None:
        width = max(int(np.bincount(t.edges.reshape(-1), minlength=n).max())
                    for t in topos)
        width = max(width, 1)
    tabs, ws, degs = zip(*(_padded_operands(t.n, t.edges, t.loops, width)
                           for t in topos))
    return np.stack(tabs), np.stack(ws), np.stack(degs)


def connected_component_count(n: int, edges: np.ndarray) -> int:
    """Exact component count via vectorized min-label propagation with
    pointer jumping — O((m + n) log n), no Python per-edge loop."""
    labels = np.arange(n, dtype=np.int64)
    if edges.size == 0:
        return n
    u, v = edges[:, 0], edges[:, 1]
    while True:
        nxt = labels.copy()
        np.minimum.at(nxt, u, labels[v])
        np.minimum.at(nxt, v, labels[u])
        nxt = nxt[nxt]                       # pointer jumping
        if np.array_equal(nxt, labels):
            break
        labels = nxt
    return int(np.unique(labels).size)


# --------------------------------------------------------------------------
# the sweep driver
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FaultSweepResult:
    """Survival curves of one topology under one fault model."""
    name: str
    model: str
    n: int
    m: int
    samples: int
    seed: int
    rho2_healthy: float
    rows: List[Dict]            # one dict per fault rate (see fault_sweep)
    batched_solves: int         # number of batched Lanczos calls issued
    seconds: float

    def curve(self, field: str) -> List:
        """[(rate, value), ...] — e.g. curve('rho2_mean')."""
        return [(r["rate"], r[field]) for r in self.rows]

    def to_dict(self) -> Dict:
        return dict(name=self.name, model=self.model, n=self.n, m=self.m,
                    samples=self.samples, seed=self.seed,
                    rho2_healthy=self.rho2_healthy, rows=self.rows,
                    batched_solves=self.batched_solves,
                    seconds=round(self.seconds, 3))

    def report(self) -> str:
        """Compact text block for CLI reports."""
        lines = [f"fault model     : {self.model} "
                 f"({self.samples} sample{'s' if self.samples > 1 else ''}/rate, "
                 f"{self.batched_solves} batched solve"
                 f"{'s' if self.batched_solves > 1 else ''})",
                 f"healthy rho2    : {self.rho2_healthy:.5f}"]
        for r in self.rows:
            kept = "n/a kept" if r["rho2_retention"] is None \
                else f"{r['rho2_retention']:.0%} kept"
            lines.append(
                f"  rate {r['rate']:>5.1%} : rho2 {r['rho2_mean']:.4f} "
                f"({kept}), "
                f"P(connected) {r['connectivity_prob']:.2f}, "
                f"bisection LB {r['bw_fiedler_lb_mean']:.1f}")
        return "\n".join(lines)


@obs.traced("faults/sweep", phase="execute")
def fault_sweep(topo: Topology, rates: Sequence[float] = (0.02, 0.05, 0.1, 0.2),
                model: str = "link", samples: int = 32, seed: int = 0,
                iters: int = 160, rho2_healthy: Optional[float] = None,
                fiedler: Optional[np.ndarray] = None,
                routing: bool = False,
                routing_sources: Optional[int] = None,
                simulate: bool = False,
                sim_payload: float = float(1 << 26),
                workload=None,
                workload_samples: int = 2, *,
                device: Device = DEFAULT_DEVICE) -> FaultSweepResult:
    """Survival curves under fault injection, batched per rate.

    For each rate, ``samples`` Monte-Carlo scenarios (or one, for the
    deterministic adversarial models) are materialized, their padded gather
    operands stacked, and all degraded rho_2 values solved in a single
    batched Laplacian Lanczos call on ``device`` (default the card).  Connectivity is counted exactly on the
    host (rho_2 of a disconnected sample is ~0 and its zero crossing is the
    connectivity signal, but the component count is cheap and unambiguous).

    Per-rate row fields: rate, samples, failed_links_mean, failed_nodes,
    rho2_mean/min/max, rho2_retention (mean / healthy), connectivity_prob,
    bw_fiedler_lb_mean (Theorem 2 at each sample), diameter_ub (Theorem 1 at
    the worst connected sample; None if every sample disconnected), and the
    analytic caps interlacing_rho2_ub (link models only) / weyl_rho2_lb.

    ``routing=True`` feeds each rate's already-stacked padded tables through
    :func:`repro_torch.core.routing.routing_stats_stacked` — one batched BFS
    for all B samples — appending *measured* degraded path structure per row:
    ``bfs_diameter_mean/max`` (hops; over fully-reachable samples only, None
    when every sample disconnected — a shattered sample's max-over-reachable
    figure would shrink, not grow; exact per sample when all sources run,
    else a lower bound), ``bfs_avg_hops_mean`` (over reachable pairs),
    ``reachable_frac_mean``.
    ``routing_sources`` caps the BFS sources per sample (default: all vertices
    up to n=512, then 64 sampled sources — the knob trades exactness for time
    on large instances).

    ``simulate=True`` *executes* a ring all-reduce of ``sim_payload`` bytes
    per node on each rate's stacked degraded tables
    (:func:`repro_torch.core.simulate.stacked_ring_allreduce` — each
    sample's ring round lowered in turn, one engine pass for all B),
    appending simulated degraded collective times per row:
    ``sim_allreduce_mean/max`` (seconds of the modeled interconnect; demand
    between disconnected pairs is dropped) and ``sim_dropped_frac_mean``
    (fraction of the ring demand dropped — the disconnection signal).

    ``workload=`` (a spec string, :class:`~repro_torch.core.workloads.
    WorkloadSpec` or prebuilt :class:`~repro_torch.core.workloads.CommPlan`)
    *executes* the full per-step training communication plan on the first
    ``workload_samples`` degraded samples of each rate
    (:func:`repro_torch.core.workloads.simulate_workload` with its default
    linear placement; each sample needs its own all-sources BFS, hence the
    small default), appending simulated degraded step times per row:
    ``workload_step_mean/max`` (seconds of the modeled cluster),
    ``workload_dropped_frac_mean`` (fraction of the plan's demand between
    disconnected node pairs).
    """
    if model not in FAULT_MODELS:
        raise ValueError(f"unknown fault model {model!r} (known: {FAULT_MODELS})")
    dev = resolve_device(device)
    t0 = time.time()
    if rho2_healthy is None:
        rho2_healthy = S.algebraic_connectivity(topo, device=dev)
    if model == "attack_spectral" and fiedler is None:
        fiedler = _fiedler(topo, dev)
    B_samples = 1 if model in DETERMINISTIC_MODELS else samples
    plan = None
    if workload is not None:
        from .workloads import CommPlan, plan_workload
        plan = workload if isinstance(workload, CommPlan) else \
            plan_workload(workload)
    # impose the healthy table width so link-model rates stack identically
    healthy_width = max(int(np.bincount(topo.edges.reshape(-1),
                                        minlength=topo.n).max()), 1)
    rows: List[Dict] = []
    solves = 0
    for rate in rates:
        scen = [make_scenario(topo, model, rate, seed=seed + 7919 * i,
                              fiedler=fiedler, device=dev)
                for i in range(B_samples)]
        degraded = [apply_faults(topo, sc) for sc in scen]
        tabs, ws, degs = stacked_operands(degraded, width=healthy_width)
        rho2s = S.rho2_laplacian_batched(tabs, ws, degs, iters=iters,
                                         seed=seed, device=dev)
        solves += 1
        obs.count("faults/batched_solves")
        comps = np.array([connected_component_count(d.n, d.edges)
                          for d in degraded])
        connected = comps == 1
        n_s = degraded[0].n
        kmax = max(float(d.degrees().max()) for d in degraded)
        row = dict(
            rate=float(rate),
            samples=B_samples,
            nodes_surviving=n_s,
            failed_links_mean=float(np.mean([s.n_failed_links for s in scen])),
            failed_nodes=int(scen[0].n_failed_nodes),
            rho2_mean=float(np.mean(rho2s)),
            rho2_min=float(np.min(rho2s)),
            rho2_max=float(np.max(rho2s)),
            rho2_retention=float(np.mean(rho2s) / rho2_healthy)
                if rho2_healthy > 0 else None,
            connectivity_prob=float(np.mean(connected)),
            bw_fiedler_lb_mean=float(np.mean(
                [B.fiedler_bw_lb(n_s, r) for r in rho2s])),
            weyl_rho2_lb=B.weyl_degraded_rho2_lb(
                rho2_healthy, int(round(np.mean(
                    [s.n_failed_links for s in scen])))),
        )
        # link removal can only lower rho2 (Loewner monotonicity); node
        # removal changes the vertex set and carries no such cap
        row["interlacing_rho2_ub"] = B.interlacing_degraded_rho2_ub(
            rho2_healthy) if not scen[0].n_failed_nodes else None
        conn_rho2 = rho2s[connected]
        row["diameter_ub"] = float(B.alon_milman_diameter_ub(
            n_s, kmax, float(conn_rho2.min()))) \
            if conn_rho2.size and conn_rho2.min() > 1e-9 else None
        if routing:
            from .routing import routing_stats_stacked, sample_sources
            if routing_sources is None:
                srcs = None if n_s <= 512 else sample_sources(n_s, 64, seed)
            else:
                srcs = None if routing_sources >= n_s else \
                    sample_sources(n_s, routing_sources, seed)
            stats = routing_stats_stacked(tabs, sources=srcs, device=dev)
            # diameter stats only over samples whose sampled pairs all
            # connect — a shattered sample's max-over-reachable "diameter"
            # shrinks as components do, which would read as paths improving
            # under faults (same restriction diameter_ub applies via
            # conn_rho2); reachable_frac_mean carries the disconnection signal
            conn_stats = [s for s in stats if s["reachable_frac"] == 1.0]
            row["bfs_diameter_mean"] = float(np.mean(
                [s["diameter"] for s in conn_stats])) if conn_stats else None
            row["bfs_diameter_max"] = int(max(
                s["diameter"] for s in conn_stats)) if conn_stats else None
            row["bfs_avg_hops_mean"] = float(
                np.mean([s["avg_path_length"] for s in stats]))
            row["reachable_frac_mean"] = float(
                np.mean([s["reachable_frac"] for s in stats]))
        if simulate:
            from .simulate import stacked_ring_allreduce
            sim = stacked_ring_allreduce(tabs, payload=sim_payload,
                                         device=dev)
            row["sim_allreduce_mean"] = float(sim["time_seconds"].mean())
            row["sim_allreduce_max"] = float(sim["time_seconds"].max())
            row["sim_dropped_frac_mean"] = float(sim["dropped_frac"].mean())
        if plan is not None:
            from .workloads import simulate_workload
            wl = [simulate_workload(d, plan, device=dev)
                  for d in degraded[:max(1, workload_samples)]]
            row["workload_step_mean"] = float(
                np.mean([w.step_seconds for w in wl]))
            row["workload_step_max"] = float(
                np.max([w.step_seconds for w in wl]))
            row["workload_dropped_frac_mean"] = float(
                np.mean([w.dropped_frac for w in wl]))
        rows.append(row)
    return FaultSweepResult(
        name=topo.name, model=model, n=topo.n, m=topo.m, samples=B_samples,
        seed=seed, rho2_healthy=float(rho2_healthy), rows=rows,
        batched_solves=solves, seconds=time.time() - t0)
