"""Topology-aware collective cost model — the paper's thesis, operationalized
(PyTorch port of the reference module; host-only closed forms).

For a training step the roofline collective term depends on *which physical
topology* carries the traffic.  This module predicts the time of the standard
collectives on an arbitrary topology from exactly the quantities the paper
studies:

* **bandwidth terms** are limited by (a) per-node injection (radix x link_bw)
  and (b) the bisection bandwidth — lower-bounded spectrally via Fiedler
  (Theorem 2: BW >= rho2 n/4), which is the *guaranteed* figure a scheduler
  can rely on, or an exact/witnessed figure when known;
* **latency terms** scale with the diameter (Theorem 1 bounds it by rho2);
* on an *alpha-fraction of nodes* (job placement / degraded operation after
  faults) the Ramanujan discrepancy property (§3) keeps a guaranteed bisection;
  arbitrary topologies fall back to their worst observed subset cut.

Time model per collective, for payload B bytes per node over n nodes:
    t = max(t_injection, t_bisection) + t_latency
with the per-algorithm traffic factors below.  This is an (alpha, beta) model;
it does not simulate routing/congestion beyond the bisection abstraction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.device import DEFAULT_DEVICE

from .bounds import expected_degraded_rho2, fiedler_bw_lb
from .graphs import Topology

__all__ = ["NetworkModel", "network_from_topology", "tpu_v5e_ici",
           "COLLECTIVE_FACTORS", "LINK_BW", "PER_HOP_LATENCY"]

# Inputs of the modeled interconnect (a v5e-class ICI link), copied from the
# reference for parity: every simulated time the port reports is computed
# from these two constants, and none of them is a figure of the device the
# port runs on.
LINK_BW = 50e9           # bytes/s per modeled link
PER_HOP_LATENCY = 1e-6   # seconds per modeled hop


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Abstract interconnect: everything the cost model needs.

    Units: ``link_bw`` bytes/second per link; ``hop_latency`` seconds per hop;
    ``diameter``/``avg_hops`` hops; ``bisection_links``/``radix`` link counts;
    every ``all_reduce``-style method returns **seconds**.
    """
    name: str
    n: int                  # nodes (chips)
    radix: int              # links per node (as built)
    bisection_links: float  # links crossing the worst balanced cut (guaranteed)
    diameter: int           # hops; measured (routing) or bounded (Theorem 1)
    link_bw: float = LINK_BW
    hop_latency: float = PER_HOP_LATENCY
    rho2: Optional[float] = None          # algebraic connectivity, if known
    effective_radix: Optional[float] = None  # surviving links/node (degraded)
    fault_rate: float = 0.0               # cumulative fraction already failed
    avg_hops: Optional[float] = None      # measured mean shortest-path hops

    # ---- collective times (payload = bytes per node) ----------------------
    def _bw_time(self, inj_bytes: float, cross_bytes: float) -> float:
        """Bandwidth term: max of per-node injection and bisection bottleneck.

        Args: bytes each node must inject / bytes that must cross the worst
        balanced cut.  Returns seconds.
        """
        inj_links = self.effective_radix if self.effective_radix is not None \
            else self.radix
        t_inj = inj_bytes / (inj_links * self.link_bw)
        t_cut = cross_bytes / (self.bisection_links * self.link_bw)
        return max(t_inj, t_cut)

    @property
    def permute_hops(self) -> float:
        """Hops a point-to-point permutation flow travels: the *measured*
        average shortest-path length when a routing analysis supplied one,
        else the diameter (the conservative fallback).  Dimensionless (hops).
        """
        return self.avg_hops if self.avg_hops is not None else float(self.diameter)

    # ---- degraded operation ----------------------------------------------
    def degrade(self, fault_rate: float, model: str = "link") -> "NetworkModel":
        """View of this network after ``fault_rate`` of its links ("link") or
        routers ("node") have failed — collective predictions then reflect the
        guaranteed degraded bisection.

        Args:
            fault_rate: fraction of links/routers failed, in [0, 1).
            model: ``"link"`` (iid link death) or ``"node"`` (router death;
                the surviving machine shrinks to ``round(n * (1-r))`` nodes).

        Returns:
            A new frozen :class:`NetworkModel`; ``degrade(0.0)`` is an exact
            no-op (returns ``self``) and successive calls compose.

        Under iid link failure E[L_degraded] = (1 - r) L, so the certified
        figure is the Fiedler floor at the expected degraded gap
        rho2 * (1 - r) — equivalently the healthy bisection scaled by (1 - r)
        (node failure kills a cut link when either endpoint dies: (1 - r)^2).
        Injection capacity degrades to ``effective_radix = radix * (1 - r)``
        and, when rho2 is known, the diameter is bumped to the Theorem-1
        (Alon–Milman) upper bound at the degraded gap — for a *measured*
        degraded diameter instead of this analytic cap, route the degraded
        topology itself (``Analysis.fault_sweep(routing=True)``).  A measured
        healthy ``avg_hops`` is dropped (it no longer describes the degraded
        paths), falling latency terms back to the diameter.
        """
        if not 0.0 <= fault_rate < 1.0:
            raise ValueError(f"fault rate must be in [0, 1), got {fault_rate}")
        if model not in ("link", "node"):
            raise ValueError(f"degrade model must be 'link' or 'node', "
                             f"got {model!r}")
        if fault_rate == 0.0:
            return self
        s = 1.0 - fault_rate
        n = self.n if model == "link" else max(int(round(self.n * s)), 2)
        cut_survival = s if model == "link" else s * s
        rho2_deg = None if self.rho2 is None \
            else expected_degraded_rho2(self.rho2, fault_rate)
        diameter = self.diameter
        if rho2_deg is not None and rho2_deg > 0:
            from .bounds import alon_milman_diameter_ub
            kmax = self.effective_radix if self.effective_radix is not None \
                else self.radix
            diameter = max(self.diameter,
                           int(alon_milman_diameter_ub(n, kmax, rho2_deg)))
        inj = self.effective_radix if self.effective_radix is not None \
            else float(self.radix)
        return dataclasses.replace(
            self, name=f"{self.name}!{model}@{fault_rate:g}", n=n,
            bisection_links=max(self.bisection_links * cut_survival, 1e-9),
            diameter=diameter, rho2=rho2_deg,
            effective_radix=inj * s, avg_hops=None,
            fault_rate=1.0 - (1.0 - self.fault_rate) * s)

    def _lat(self, steps: float) -> float:
        """Latency term: ``steps`` hops at ``hop_latency`` each.  Seconds."""
        return steps * self.hop_latency

    def all_reduce(self, bytes_per_node: float) -> float:
        """Predicted all-reduce time (reduce-scatter + all-gather).

        Args: ``bytes_per_node`` — payload each node contributes (bytes).
        Returns seconds.  Each node moves 2B(n-1)/n; 2B crosses every
        bisection (reduced data out + result back).
        """
        b = bytes_per_node
        return self._bw_time(2 * b * (self.n - 1) / self.n, 2 * b) \
            + self._lat(2 * self.diameter + 2 * math.log2(max(self.n, 2)))

    def reduce_scatter(self, bytes_per_node: float) -> float:
        """Predicted reduce-scatter time for B input bytes/node.  Seconds."""
        b = bytes_per_node
        return self._bw_time(b * (self.n - 1) / self.n, b) \
            + self._lat(self.diameter + math.log2(max(self.n, 2)))

    def all_gather(self, bytes_per_node_out: float) -> float:
        """Predicted all-gather time; each node ends with B total gathered
        bytes (B/n contributed each).  Returns seconds."""
        b = bytes_per_node_out
        return self._bw_time(b * (self.n - 1) / self.n, b) \
            + self._lat(self.diameter + math.log2(max(self.n, 2)))

    def broadcast(self, bytes_total: float) -> float:
        """Predicted one-to-all broadcast time for B total bytes.  Seconds.
        The root injects B once over its own links, B crosses every bisection
        once, and propagation needs at least ecc(root) >= radius >=
        ceil(diam/2) hops — the model is root-agnostic, so it charges that
        certified floor (the diameter itself would over-promise for a
        central root).  A lower bound any executed broadcast tree obeys."""
        b = bytes_total
        return self._bw_time(b, b) + self._lat(math.ceil(self.diameter / 2))

    def all_to_all(self, bytes_per_node: float) -> float:
        """Predicted all-to-all time for B bytes sent per node (split across
        all peers).  Returns seconds.  Cross-traffic = (n/2 senders x B/2
        destined across) = n*B/4 over the cut."""
        b = bytes_per_node
        return self._bw_time(b * (self.n - 1) / self.n, self.n * b / 4.0) \
            + self._lat(self.diameter)

    def collective_time(self, kind: str, bytes_per_node: float) -> float:
        """Dispatch by collective name (keys of :data:`COLLECTIVE_FACTORS`).

        Args: ``kind`` collective name; ``bytes_per_node`` payload (bytes).
        Returns seconds.  ``collective-permute`` travels the *measured*
        average hop count when known (:attr:`permute_hops`), else the
        diameter.
        """
        return {
            "all-reduce": self.all_reduce,
            "all-gather": self.all_gather,
            "reduce-scatter": self.reduce_scatter,
            "all-to-all": self.all_to_all,
            "broadcast": self.broadcast,
            "collective-permute":
                lambda b: b / self.link_bw + self._lat(self.permute_hops),
        }[kind](bytes_per_node)

    # ---- empirical validation against an executed schedule ----------------
    def validate(self, sim) -> Dict[str, Any]:
        """Measured/predicted ratios for an executed schedule — the first
        empirical check that the spectral (alpha, beta) figures this model
        certifies are actually attained by a schedule that ran.

        Args:
            sim: a :class:`repro_torch.core.simulate.SimulationResult`
                (duck-typed:
                ``collective``/``algorithm`` names, ``payload_bytes`` and
                ``time_seconds`` arrays).  The simulation must have run with
                this model's ``link_bw``/``hop_latency`` for the comparison
                to be apples-to-apples.

        Returns:
            dict with ``collective``, ``algorithm``, per-payload ``rows``
            (``payload_bytes``, ``measured_s``, ``predicted_s``, ``ratio`` =
            measured/predicted) and ``all_measured_geq_predicted`` — the
            analytic model is a *lower* bound, so a ratio below 1 - 1e-6
            means the certificate over-promised (or constants diverged).
        """
        kind = str(sim.collective).replace("_", "-")
        if kind not in COLLECTIVE_FACTORS:
            raise ValueError(
                f"cannot validate {sim.collective!r}: the analytic model "
                f"only predicts {sorted(COLLECTIVE_FACTORS)}")
        rows = []
        ok = True
        for p, t in zip(sim.payload_bytes, sim.time_seconds):
            pred = self.collective_time(kind, float(p))
            ratio = float(t) / pred if pred > 0 else float("inf")
            ok &= float(t) >= pred * (1.0 - 1e-6)
            rows.append(dict(payload_bytes=float(p), measured_s=float(t),
                             predicted_s=pred, ratio=ratio))
        return dict(collective=kind, algorithm=sim.algorithm, rows=rows,
                    all_measured_geq_predicted=bool(ok))


def network_from_topology(topo: Topology, diameter: Optional[int] = None,
                          rho2: Optional[float] = None,
                          exact_bisection: Optional[float] = None,
                          vertex_transitive: bool = True,
                          routing: Optional[object] = None, *,
                          device: Union[str, torch.device, None]
                          = DEFAULT_DEVICE) -> NetworkModel:
    """Build the model from a constructed Topology.

    Args:
        topo: the physical interconnect graph (must be regular).
        diameter: known diameter in hops; measured by BFS when omitted.
        rho2: known algebraic connectivity; solved when omitted.
        exact_bisection: exact bisection link count, if known.
        vertex_transitive: lets the BFS diameter use one eccentricity.
        routing: a :class:`repro_torch.core.routing.RoutingResult` from a
            path-level analysis; when given, its *measured* exact diameter
            and average hop count replace the BFS/Theorem-1 figures
            (``avg_hops`` then drives ``collective-permute`` latency).
        device: where an omitted rho2 is solved when ``n`` is above the
            dense threshold (Lanczos; default the card).

    Returns:
        A :class:`NetworkModel` whose bisection uses the *guaranteed*
        (Fiedler) figure unless an exact value is supplied — this is the
        paper's point: the spectral gap is what a scheduler can certify
        without solving min-bisection.
    """
    from .properties import diameter as diam_fn
    from .spectral import algebraic_connectivity

    if rho2 is None:
        rho2 = algebraic_connectivity(topo, device=device)
    avg_hops = None
    if routing is not None:
        if diameter is None and routing.exact:
            diameter = int(routing.diameter)
        avg_hops = float(routing.avg_path_length)
    if diameter is None:
        diameter = diam_fn(topo, vertex_transitive=vertex_transitive)
    bisection = exact_bisection if exact_bisection is not None \
        else fiedler_bw_lb(topo.n, rho2)
    return NetworkModel(name=topo.name, n=topo.n, radix=topo.radix,
                        bisection_links=max(bisection, 1e-9), diameter=diameter,
                        rho2=rho2, avg_hops=avg_hops)


def tpu_v5e_ici(x: int = 16, y: int = 16) -> NetworkModel:
    """The *faithful* model of a v5e pod: Torus(x) x Torus(y) ICI.

    Args: ``x``, ``y`` — torus extents (chips per ring).
    Returns a :class:`NetworkModel` with the closed-form figures:
    rho2 = 2(1 - cos(2 pi / max(x,y))) (paper §4.1); bisection of a 2D torus
    is 2*min(x,y) links; diameter x/2 + y/2 hops.
    """
    n = x * y
    rho2 = 2.0 * (1 - math.cos(2 * math.pi / max(x, y)))
    return NetworkModel(name=f"torus({x}x{y})", n=n, radix=4,
                        bisection_links=2.0 * min(x, y),
                        diameter=x // 2 + y // 2, rho2=rho2)


# traffic factors used by the roofline report (documents the model above)
COLLECTIVE_FACTORS = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "broadcast": 1.0, "collective-permute": 1.0,
}
