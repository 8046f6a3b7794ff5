"""Lazy, memoizing analysis session over one topology (PyTorch port).

``Analysis(topo)`` computes-on-demand and caches every quantity the paper's
survey reports: spectrum, rho2, diameter, witnessed bisection, the analytic
bounds of :mod:`repro_torch.core.bounds`, and the equal-radix
Ramanujan/LPS comparison.  The backend auto-selects by ``n``:

* ``n <= dense_threshold`` — dense float64 numpy oracle on the host (full
  spectrum, exact Fiedler vector);
* larger — the matrix-free Lanczos path (``rho2_lanczos``, top-Ritz Fiedler
  approximation) on ``device``, through the :mod:`repro_torch.kernels.spmv`
  dispatcher: kernel K1 on the card, the plain PyTorch gather-sum on the CPU.

``device`` defaults to ``"cuda"``; without a card the session raises at
construction unless the caller asks for ``device="cpu"``.  A spec string of
a designed family (``xpander``, ``rewired``) is synthesized on ``device``.

Besides the main-path quantities, the session measures path structure
(:meth:`routing`), link loads under every routing scheme (:meth:`traffic`)
and their MCF ceiling (:meth:`mcf_throughput_ub`), the analytic collective
model (:meth:`network_model`), executed schedules and training steps
(:meth:`simulate`, ``workload=``) and fault sweeps (:meth:`fault_sweep`),
on ``device``.  Nothing is computed in ``__init__``; every
property memoizes on first access, so ``survey()`` can pre-populate (e.g.
batched rho2 solves) without waste.
"""
from __future__ import annotations

from functools import cached_property
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import bounds as B
from repro_torch.core import collectives as C
from repro_torch.core import faults as F
from repro_torch.core import properties as P
from repro_torch.core import routing as R
from repro_torch.core import simulate as SM
from repro_torch.core import spectral as S
from repro_torch.core import traffic as TR
from repro_torch.core import workloads as W
from repro_torch.core.graphs import Topology
from repro_torch.core.ramanujan import ramanujan_bound
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import spmv as KS

from .registry import REGISTRY, SpecError

__all__ = ["Analysis"]


class Analysis:
    """One topology, every survey quantity, computed lazily and cached."""

    def __init__(self, topo: Union[Topology, str], *,
                 dense_threshold: int = S.DENSE_THRESHOLD,
                 lanczos_iters: int = 200, seed: int = 0,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE
                 ) -> None:
        self.device = resolve_device(device)
        if isinstance(topo, str):
            topo = REGISTRY.build(topo, device=self.device)
        self.topo = topo
        self.dense_threshold = int(dense_threshold)
        self.lanczos_iters = int(lanczos_iters)
        self.seed = int(seed)

    # -- identity ----------------------------------------------------------
    @property
    def n(self) -> int:
        """Number of vertices (routers/chips)."""
        return self.topo.n

    @property
    def name(self) -> str:
        """Instance name, e.g. ``slimfly(13)``."""
        return self.topo.name

    @property
    def family(self) -> Optional[str]:
        """Registry family name, or None for hand-built topologies."""
        return self.topo.meta.get("family")

    @property
    def spec(self) -> Optional[str]:
        """Canonical spec string, or None for hand-built topologies."""
        return self.topo.meta.get("spec")

    @property
    def backend(self) -> str:
        """'dense' or 'lanczos' — chosen once by ``n`` vs the threshold."""
        return "dense" if self.n <= self.dense_threshold else "lanczos"

    @cached_property
    def radix(self) -> Optional[float]:
        """Degree if regular, else None (bounds fall back to max degree)."""
        try:
            return float(self.topo.radix)
        except ValueError:
            return None

    @cached_property
    def max_degree(self) -> float:
        return float(self.topo.degrees().max())

    # -- spectral quantities ----------------------------------------------
    def _matvec(self):
        tab, w = self.topo.gather_operands()
        return KS.spmv_matvec(tab, w, device=self.device)

    @cached_property
    def spectrum(self) -> np.ndarray:
        """Full adjacency spectrum (ascending) — dense backend only."""
        if self.backend != "dense":
            raise RuntimeError(
                f"{self.name}: full spectrum needs the dense oracle "
                f"(n={self.n} > dense_threshold={self.dense_threshold}); "
                "raise dense_threshold or use rho2/lambda_nontrivial, which "
                "route through Lanczos")
        return S.adjacency_spectrum(self.topo)

    @cached_property
    def rho2(self) -> float:
        """Algebraic connectivity rho_2 (second-smallest Laplacian eigenvalue)."""
        if self.backend == "dense":
            return float(S.laplacian_spectrum(self.topo)[1])
        return S.rho2_lanczos(self.topo, iters=self.lanczos_iters,
                              seed=self.seed, matvec=self._matvec(),
                              device=self.device)

    @cached_property
    def lambda2(self) -> Optional[float]:
        """Second-largest adjacency eigenvalue (k - rho2 for regular G)."""
        if self.radix is not None:
            return self.radix - self.rho2
        if self.backend == "dense":
            return float(self.spectrum[-2])
        return None

    @cached_property
    def lambda_nontrivial(self) -> float:
        """lambda(G): largest |eigenvalue| excluding the trivial ±k pair."""
        if self.backend == "dense":
            return S.lambda_nontrivial(self.topo)
        lmax, lmin = S.lanczos_extremes(
            self._matvec(), self.n, m=self.lanczos_iters, seed=self.seed,
            deflate_vectors=S.trivial_deflation(self.topo),
            device=self.device)
        return float(max(abs(lmax), abs(lmin)))

    @cached_property
    def spectral_gap(self) -> float:
        """k - lambda_2 (= rho2 for regular G); dense general fallback."""
        if self.radix is not None:
            return self.rho2
        return S.spectral_gap(self.topo)

    # -- combinatorial quantities -----------------------------------------
    @cached_property
    def diameter(self) -> int:
        return P.diameter(
            self.topo,
            vertex_transitive=bool(self.topo.meta.get("vertex_transitive")))

    @cached_property
    def fiedler(self) -> np.ndarray:
        """Canonical Fiedler vector: deterministic across eigensolver paths.

        Routed through :func:`repro_torch.core.spectral.canonical_fiedler`, so
        on degenerate Fiedler eigenspaces (butterfly, torus, ...) every
        backend yields the *same* vector at dense-tractable sizes.
        """
        if self.backend == "dense":
            return S.canonical_fiedler(self.topo)
        vec = S.fiedler_lanczos(self.topo, iters=self.lanczos_iters,
                                seed=self.seed, device=self.device)
        return S.canonical_fiedler(self.topo, vec)

    @cached_property
    def bisection_mask(self) -> np.ndarray:
        order = np.argsort(self.fiedler, kind="stable")
        mask = np.zeros(self.n, dtype=bool)
        mask[order[: self.n // 2]] = True
        return mask

    @cached_property
    def bisection_witness(self) -> float:
        """Edges crossing a balanced Fiedler sweep cut — a true bisection,
        hence a certified upper bound on BW(G) on both backends."""
        return P.bisection_witness(self.topo, self.bisection_mask)

    # -- analytic bounds ---------------------------------------------------
    @cached_property
    def bounds(self) -> Dict[str, float]:
        """Every closed-form bound of bounds.py evaluated at (n, deg, rho2)."""
        n, rho2 = self.n, self.rho2
        kmax = self.max_degree
        out = dict(
            fiedler_bw_lb=B.fiedler_bw_lb(n, rho2),
            cheeger_bw_ub=B.cheeger_bw_ub(n, kmax, rho2),
            first_moment_bw_ub=B.first_moment_bw_ub(self.topo.m),
            alon_milman_diameter_ub=B.alon_milman_diameter_ub(n, kmax, rho2),
            mohar_diameter_lb=B.mohar_diameter_lb(n, rho2),
            fiedler_vertex_connectivity_lb=B.fiedler_vertex_connectivity_lb(rho2),
        )
        if self.radix is not None and self.lambda2 is not None:
            out["tanner_isoperimetric_lb"] = B.tanner_isoperimetric_lb(
                self.radix, self.lambda2)
        return out

    @cached_property
    def closed_forms(self) -> Optional[Dict[str, float]]:
        """The registered analytic Table-1 record for this instance, if any."""
        if not self.spec:
            return None
        try:
            fam, bound = REGISTRY.parse(self.spec)
        except SpecError:
            return None
        if fam.variadic:
            return fam.forms(*bound[fam.params[0][0]])
        return fam.forms(**bound)

    # -- Ramanujan comparison (equal radix, §3) ----------------------------
    @cached_property
    def ramanujan(self) -> Dict[str, Any]:
        """Equal-radix comparison against the Ramanujan optimum (LPS class)."""
        if self.radix is None:
            raise RuntimeError(f"{self.name} is irregular — the equal-radix "
                               "Ramanujan comparison needs a regular graph")
        k = self.radix
        opt = B.ramanujan_rho2(k)
        lam = self.lambda_nontrivial
        bound = ramanujan_bound(int(k))
        return dict(
            radix=k,
            rho2_optimum=opt,
            rho2_ratio=self.rho2 / opt,
            bw_lb_at_optimum=B.ramanujan_bw_lb(self.n, k),
            lambda_bound=bound,
            lam=lam,
            is_ramanujan=bool(lam <= bound + 1e-6),
        )

    # -- measured path structure (routing & traffic) -----------------------
    def _routing_key(self, sample_fraction: Optional[float],
                     seed: Optional[int]):
        """Cache key of one routing configuration.  Exact analysis keys on
        nothing (it is deterministic); sampled analyses key on BOTH the
        fraction and the resolved seed so different samples never alias."""
        if sample_fraction is None:
            return ("exact",)
        return ("sampled", float(sample_fraction),
                self.seed if seed is None else int(seed))

    def routing(self, sources: Optional[Sequence[int]] = None, *,
                sample_fraction: Optional[float] = None,
                seed: Optional[int] = None) -> "R.RoutingResult":
        """Measured path structure via batched BFS on this session's device
        (lazy, cached per config).

        Args:
            sources: explicit BFS source vertices (not cached).  ``None``
                with no ``sample_fraction`` runs all n sources → exact
                diameter, hop-count distribution, average shortest-path
                length, and per-pair minimal-path counts.
            sample_fraction: run BFS from a ``round(fraction * n)``-subset of
                sources drawn by :func:`repro_torch.core.routing.
                sample_sources` — the datacenter-scale estimator
                (``diameter`` becomes a certified lower bound,
                ``avg_hops_ci`` a bootstrap CI).  ``1.0`` reproduces the
                exact analysis bit-for-bit.  Cached per
                ``(sample_fraction, seed)``.
            seed: source-sampling seed; defaults to this session's seed.

        Returns:
            :class:`repro_torch.core.routing.RoutingResult` (units: hops).
        """
        if sources is not None:
            return R.analyze_routing(self.topo, sources=sources,
                                     device=self.device)
        cache = self.__dict__.setdefault("_routing_cache", {})
        key = self._routing_key(sample_fraction, seed)
        if key not in cache:
            cache[key] = R.analyze_routing(
                self.topo, sample_fraction=sample_fraction,
                seed=self.seed if seed is None else int(seed),
                device=self.device)
        return cache[key]

    def traffic(self, pattern: str = "uniform", *,
                scheme: str = "minimal",
                slack: int = 1,
                sample_fraction: Optional[float] = None,
                seed: Optional[int] = None) -> "TR.TrafficResult":
        """Link-load accounting of one synthetic pattern (lazy, cached).

        Routes the named demand pattern (see
        :data:`repro_torch.core.traffic.TRAFFIC_PATTERNS`) under the chosen
        ``scheme`` (:data:`repro_torch.core.traffic.ROUTING_SCHEMES`:
        minimal ECMP, Valiant, UGAL, or k-shortest-path with ``slack`` extra
        hops), reusing this session's cached :meth:`routing` matrices and
        (for ``adversarial``) canonical Fiedler vector.  With
        ``sample_fraction``, only the sampled source rows are routed and the
        loads carry the n/S unbiasedness correction (see
        :func:`repro_torch.core.traffic.evaluate_traffic`); cache entries
        key on ``(pattern, scheme, slack, sample_fraction, seed)``.

        Returns:
            :class:`repro_torch.core.traffic.TrafficResult` — per-directed-
            link loads in injection units, max load, saturation throughput.
        """
        cache = self.__dict__.setdefault("_traffic", {})
        key = (pattern, scheme, int(slack)) + \
            self._routing_key(sample_fraction, seed)
        if key not in cache:
            fiedler = self.fiedler if pattern == "adversarial" else None
            cache[key] = TR.evaluate_traffic(
                self.topo, pattern, scheme=scheme, slack=slack,
                routing=self.routing(sample_fraction=sample_fraction,
                                     seed=seed),
                fiedler=fiedler, device=self.device)
        return cache[key]

    def mcf_throughput_ub(self, pattern: str = "uniform", *,
                          groups: Optional[int] = None) -> float:
        """Multi-commodity-flow LP throughput ceiling (lazy, cached; host).

        The grouped-commodity LP upper bound of
        :func:`repro_torch.core.traffic.mcf_throughput_ub` for this topology
        and pattern — the optimality ceiling every measured scheme's
        ``saturation_throughput`` is compared against (``thpt_gap_to_opt``
        in the survey).  Raises ``RuntimeError`` when scipy is unavailable.
        """
        cache = self.__dict__.setdefault("_mcf", {})
        key = (pattern, groups)
        if key not in cache:
            fiedler = self.fiedler if pattern == "adversarial" else None
            cache[key] = TR.mcf_throughput_ub(
                self.topo, pattern, fiedler=fiedler, groups=groups)
        return cache[key]

    # -- executed schedules (link-level simulation) ------------------------
    def network_model(self) -> "C.NetworkModel":
        """The analytic (alpha, beta) collective model of this topology
        (lazy, cached), built from this session's measured rho2 and routing
        analysis — so its ``validate`` hook ratios the *same* spectral
        figures :meth:`simulate` executes against.

        Returns:
            :class:`repro_torch.core.collectives.NetworkModel` with the
            guaranteed Fiedler bisection, measured diameter, and measured
            avg hops.
        """
        if "_network" not in self.__dict__:
            self.__dict__["_network"] = C.network_from_topology(
                self.topo, rho2=self.rho2, routing=self.routing(),
                device=self.device)
        return self.__dict__["_network"]

    def simulate(self, collective: str = "all_reduce",
                 algorithm: Optional[str] = None, *,
                 payload: Union[float, Sequence[float]] = float(1 << 26),
                 pattern: Optional[str] = None,
                 workload: Optional[Any] = None,
                 placement: str = "linear",
                 link_bw: float = C.LINK_BW,
                 hop_latency: float = C.PER_HOP_LATENCY,
                 root: int = 0,
                 scheme: str = "minimal",
                 slack: int = 1,
                 telemetry: bool = False
                 ) -> Union["SM.SimulationResult", "W.WorkloadResult"]:
        """Execute a collective algorithm, traffic workload or training step
        on the modeled links (lazy, cached per configuration).

        Lowers the named schedule (:data:`repro_torch.core.simulate.
        SIM_ALGORITHMS`) onto this topology's gather-table slots — reusing
        this session's cached :meth:`routing` matrices for the lowering —
        and runs the round engine on this session's device over all
        requested payload sizes at once.  The times are those of the
        modeled interconnect (``link_bw``, ``hop_latency``): simulated, not
        measured on the device.

        Args:
            collective: ``all_reduce`` / ``reduce_scatter`` / ``all_gather``
                / ``broadcast``, or ``"traffic"`` to execute a demand-matrix
                workload instead.
            algorithm: schedule algorithm (default: the collective's first
                :data:`~repro_torch.core.simulate.SIM_ALGORITHMS` entry).
            payload: bytes per node — scalar or sequence.
            pattern: traffic pattern for ``collective="traffic"`` (default
                ``uniform``; ``adversarial`` reuses the cached Fiedler
                vector).
            workload: a training-job spec string
                (``"kimi_k2_1t@dp=64,tp=8,ep=16"``), :class:`~repro_torch.
                core.workloads.WorkloadSpec` or prebuilt ``CommPlan``:
                execute its per-step communication plan instead
                (:func:`repro_torch.core.workloads.simulate_workload`).
            placement: logical-rank -> node strategy for ``workload=``
                (``linear`` / ``round_robin`` / ``random``).
            link_bw / hop_latency: engine constants (defaults match
                :class:`~repro_torch.core.collectives.NetworkModel`, so
                ``network_model().validate(...)`` is apples-to-apples).
            root: broadcast root vertex.
            scheme: routing scheme for the link lowering — ``minimal``
                (ECMP, default), ``valiant``, ``ugal`` or ``ksp``.  Applies
                to traffic workloads and demand-lowered collectives;
                ``workload=`` runs always use minimal ECMP.
            slack: extra hops beyond shortest for ``scheme="ksp"``.
            telemetry: attach per-round engine telemetry
                (:class:`repro_torch.core.simulate.RoundTelemetry`) as
                ``result.telemetry``.  Does not apply to ``workload=`` runs.

        Returns:
            :class:`repro_torch.core.simulate.SimulationResult` — simulated
            times (seconds), per-link utilization, congestion accounting —
            or a :class:`repro_torch.core.workloads.WorkloadResult` when
            ``workload=`` is given.
        """
        cache = self.__dict__.setdefault("_simulate", {})
        if workload is not None:
            plan = workload if isinstance(workload, W.CommPlan) else \
                W.plan_workload(workload)
            key = ("workload", plan.spec.spec, placement, link_bw,
                   hop_latency)
            if key not in cache:
                cache[key] = W.simulate_workload(
                    self.topo, plan, placement=placement,
                    routing=self.routing(), link_bw=link_bw,
                    hop_latency=hop_latency, device=self.device)
            return cache[key]
        pay = tuple(np.atleast_1d(np.asarray(payload, dtype=np.float64)))
        # resolve defaults BEFORE keying so simulate("all_reduce") and
        # simulate("all_reduce", "ring") share one cache entry
        if collective == "traffic":
            if algorithm not in (None, "ecmp"):
                raise ValueError("traffic workloads always route via ECMP; "
                                 f"algorithm={algorithm!r} does not apply")
            pattern = pattern or "uniform"
            algorithm = "ecmp"
        else:
            if pattern is not None:
                raise ValueError("pattern= only applies to "
                                 "collective='traffic'")
            if collective not in SM.SIM_ALGORITHMS:
                raise ValueError(f"unknown collective {collective!r} (known: "
                                 f"{sorted(SM.SIM_ALGORITHMS)} + 'traffic')")
            algorithm = algorithm or SM.SIM_ALGORITHMS[collective][0]
        key = (collective, algorithm, pay, pattern, link_bw, hop_latency,
               root, scheme, int(slack), bool(telemetry))
        if key not in cache:
            if collective == "traffic":
                fiedler = self.fiedler if pattern == "adversarial" else None
                cache[key] = SM.simulate_traffic(
                    self.topo, pattern, payloads=pay, link_bw=link_bw,
                    hop_latency=hop_latency, routing=self.routing(),
                    fiedler=fiedler, scheme=scheme, slack=slack,
                    telemetry=telemetry, device=self.device)
            else:
                cache[key] = SM.simulate_collective(
                    self.topo, collective, algorithm, payloads=pay,
                    link_bw=link_bw, hop_latency=hop_latency,
                    routing=self.routing(), root=root, scheme=scheme,
                    slack=slack, telemetry=telemetry, device=self.device)
        return cache[key]

    # -- degraded operation (fault tolerance, §3) --------------------------
    def fault_sweep(self, rates: Sequence[float] = (0.02, 0.05, 0.1, 0.2),
                    model: str = "link", samples: int = 32,
                    seed: Optional[int] = None,
                    iters: Optional[int] = None,
                    routing: bool = False,
                    simulate: bool = False,
                    sim_payload: float = float(1 << 26),
                    workload: Optional[Any] = None,
                    workload_samples: int = 2) -> "F.FaultSweepResult":
        """Survival curves under fault injection (rho2, bisection floor,
        connectivity vs fault rate) on this session's device.  Monte-Carlo
        models batch all ``samples`` degraded instances per rate into ONE
        batched Laplacian Lanczos solve; the adversarial models
        (``attack_degree``, ``attack_spectral``) are deterministic.  Reuses
        this session's cached healthy rho2 and (for the spectral attack)
        Fiedler vector.  ``routing=True`` additionally runs batched BFS over
        each rate's stacked degraded tables, appending measured degraded
        diameter / path-length / reachability per rate.  ``simulate=True``
        executes a ring all-reduce of ``sim_payload`` bytes on every
        degraded sample (one engine pass per rate), appending simulated
        degraded collective times (``sim_allreduce_mean/max``,
        ``sim_dropped_frac_mean``).  ``workload=`` executes that training
        step's communication plan on the first ``workload_samples`` degraded
        samples of each rate (``workload_step_mean/max``,
        ``workload_dropped_frac_mean``)."""
        fiedler = self.fiedler if model == "attack_spectral" else None
        return F.fault_sweep(
            self.topo, rates=rates, model=model, samples=samples,
            seed=self.seed if seed is None else int(seed),
            iters=min(iters or self.lanczos_iters, max(self.n - 1, 8)),
            rho2_healthy=self.rho2, fiedler=fiedler, routing=routing,
            simulate=simulate, sim_payload=sim_payload,
            workload=workload, workload_samples=workload_samples,
            device=self.device)

    # -- presentation ------------------------------------------------------
    def report(self) -> str:
        """Paper-style text report."""
        g, bd = self.topo, self.bounds
        lines = [
            f"topology        : {g.name}",
            f"spec            : {self.spec or '(hand-built)'}",
            f"backend         : {self.backend} (n={self.n}, "
            f"dense_threshold={self.dense_threshold})",
            f"nodes / radix   : {self.n} / "
            f"{int(self.radix) if self.radix is not None else 'irregular'}",
            f"rho2 (measured) : {self.rho2:.5f}",
        ]
        cf = self.closed_forms
        if cf and "rho2_ub" in cf:
            rel = "=" if cf.get("rho2_exact") else "<="
            lines.append(f"rho2 (paper)    : {rel} {cf['rho2_ub']:.5f}")
        lines += [
            f"diameter        : {self.diameter}  "
            f"(Alon-Milman UB: {bd['alon_milman_diameter_ub']:.0f})",
            f"bisection       : witnessed {self.bisection_witness:.0f}; "
            f"Fiedler floor {bd['fiedler_bw_lb']:.0f}; "
            f"m/2 cap {bd['first_moment_bw_ub']:.0f}",
            f"fault tolerance : kappa >= rho2 = {self.rho2:.3f}",
        ]
        if self.radix is not None:
            r = self.ramanujan
            lines += [
                "--- Ramanujan comparison (equal radix) ---",
                f"rho2 optimum    : {r['rho2_optimum']:.5f} "
                f"(this graph: {100 * r['rho2_ratio']:.1f}% of optimal)",
                f"BW floor at opt : {r['bw_lb_at_optimum']:.0f} edges",
                f"Ramanujan?      : {r['is_ramanujan']} "
                f"(lambda={r['lam']:.4f}, bound={r['lambda_bound']:.4f})",
            ]
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Analysis({self.name}, n={self.n}, backend={self.backend})"
