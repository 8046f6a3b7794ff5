"""Link-level collective & workload simulator: execute what the model predicts
(PyTorch port of the reference module).

Every earlier layer *predicts*: :class:`~repro_torch.core.collectives.
NetworkModel` is a closed-form (alpha, beta) model,
:mod:`repro_torch.core.traffic` computes static link loads, and the spectral
layer bounds both.  This module closes the loop by **executing** collective
algorithms and traffic workloads round by round on the modeled links of any
topology, so the Theorem-2 figures the scheduler relies on are checked
against a schedule that actually ran.

Two stages, one operand contract (the padded ``(n, k)`` gather table shared
with :mod:`spectral` / :mod:`faults` / :mod:`routing`):

1. **Schedule compiler** — :func:`compile_schedule` lowers a named algorithm
   (``ring``, ``halving_doubling``, ``binomial``, ``bruck``, ``bfs_tree``)
   into a :class:`Schedule`: per-round *slot-aligned* ``(n, k)`` transfer
   tensors.  Logical transfers between non-adjacent nodes are routed by the
   traffic layer's schemes (minimal ECMP by default: BFS, path counts and
   the backward accumulation on the device, kernel K1's f64 form on the
   card); the topology-aware ``bfs_tree`` broadcast maps straight onto
   physical parent→child links.  Identical rounds are stored once with a
   repetition count (a ring all-reduce is ONE unique round × ``2(n-1)``).
2. **Round engine** — :func:`run_schedule` advances over the unique rounds
   on the device: every directed link drains its round bytes at
   ``link_bw``, the round completes when the most contended link finishes
   (synchronous round semantics), and a store-and-forward latency term
   charges ``hop_latency`` per hop of the round's longest transfer.  The
   payload sizes are one broadcast axis of that loop, and
   :func:`stacked_ring_allreduce` runs the engine once over the ``(B, n,
   k)`` fault stacks of :func:`repro_torch.core.faults.stacked_operands`
   after lowering each degraded sample's ring round in turn.

The reference keeps round bytes and the engine in float32; the port keeps
both in float64 (times agree with the reference's to its float32 rounding,
relative 1e-5).

Units: payloads and transfer tensors are **bytes** (``round_bytes`` is stored
per unit payload, i.e. a fraction of B); ``link_bw`` bytes/second per
directed link; ``hop_latency`` seconds/hop; all returned times are seconds
of the *modeled* interconnect (:data:`~repro_torch.core.collectives.LINK_BW`,
:data:`~repro_torch.core.collectives.PER_HOP_LATENCY`) — simulated times,
not measurements of the device the simulator runs on; link utilization is
the dimensionless busy fraction busy_seconds / total.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, resolve_device

from .collectives import LINK_BW, PER_HOP_LATENCY
from .graphs import Topology
from .routing import (DEFAULT_SOURCE_CHUNK, RoutingResult, _bfs_dist_chunk,
                      _sigma_chunk, _start_block, analyze_routing)
from .traffic import (ROUTING_SCHEMES, _ecmp_loads_chunk, _source_tile,
                      demand_matrix, scheme_link_loads)

Device = Union[str, torch.device, None]

__all__ = [
    "Schedule", "SimulationResult", "RoundTelemetry", "SIM_ALGORITHMS",
    "compile_schedule", "run_schedule", "simulate_collective",
    "simulate_traffic", "stacked_ring_allreduce",
]

#: collective -> known schedule algorithms (first entry is the default).
#: ``bruck`` / ``binomial`` / ``halving_doubling`` are the classic
#: topology-oblivious log-round schedules; ``ring`` is the bandwidth-optimal
#: chain; ``bfs_tree`` is the topology-AWARE broadcast (a BFS spanning tree
#: of physical links — no multi-hop routing at all).
SIM_ALGORITHMS: Dict[str, Tuple[str, ...]] = {
    "all_reduce": ("ring", "halving_doubling"),
    "reduce_scatter": ("ring", "halving_doubling"),
    "all_gather": ("ring", "bruck", "halving_doubling"),
    "broadcast": ("bfs_tree", "binomial"),
}


# --------------------------------------------------------------------------
# schedule representation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Schedule:
    """A compiled collective: unique per-round link-transfer tensors.

    ``round_bytes[u]`` holds the bytes each directed gather-table slot
    ``(v, j)`` (link v → table[v, j]) carries in round u **per unit payload**
    (multiply by B to get bytes); ``counts[u]`` repeats identical rounds
    without storing them twice; ``hops[u]`` is the longest shortest-path any
    transfer of round u travels (the round's store-and-forward latency, in
    hops).  ``rounds`` = ``counts.sum()`` is the executed round count.
    """
    name: str
    collective: str
    algorithm: str
    n: int
    k: int                       # gather-table width (directed slots per node)
    round_bytes: np.ndarray      # (U, n, k) float64, bytes per unit payload
    counts: np.ndarray           # (U,) int32 repetitions of each unique round
    hops: np.ndarray             # (U,) int32 max hops travelled in the round
    dropped_demand: float = 0.0  # unit-payload bytes to unreachable targets

    @property
    def unique_rounds(self) -> int:
        return int(self.round_bytes.shape[0])

    @property
    def rounds(self) -> int:
        return int(self.counts.sum())

    def total_link_bytes(self) -> np.ndarray:
        """(n, k) bytes per unit payload each directed slot carries in total."""
        return (self.round_bytes
                * self.counts[:, None, None].astype(np.float64)).sum(axis=0)


def _logical_rounds_ring(n: int, phases: int) -> List[Tuple[np.ndarray, int, float]]:
    """Ring chain s -> s+1 (mod n): one unique demand, ``phases*(n-1)`` rounds,
    1/n of the payload per node per round."""
    D = np.zeros((n, n))
    s = np.arange(n)
    D[s, (s + 1) % n] = 1.0 / n
    np.fill_diagonal(D, 0.0)        # n == 1 degenerates to self-traffic
    return [(D, phases * (n - 1), 1.0)]


def _require_pow2(n: int, algorithm: str) -> int:
    t = n.bit_length() - 1
    if n <= 0 or (1 << t) != n:
        raise ValueError(f"{algorithm} needs a power-of-two node count, "
                         f"got n={n}; use algorithm='ring' instead")
    return t


def _logical_rounds_halving_doubling(n: int, phases: int
                                     ) -> List[Tuple[np.ndarray, int, float]]:
    """Recursive halving (reduce-scatter) / doubling (all-gather): round i
    pairs s with s XOR 2^i and exchanges 1/2^(i+1) of the payload.  An
    all-reduce (phases=2) runs each exchange twice — once per direction of
    the butterfly — so each unique round gets count 2."""
    t = _require_pow2(n, "halving_doubling")
    s = np.arange(n)
    out = []
    for i in range(t):
        D = np.zeros((n, n))
        D[s, s ^ (1 << i)] = 1.0 / float(1 << (i + 1))
        out.append((D, phases, 1.0))
    return out


def _logical_rounds_bruck(n: int) -> List[Tuple[np.ndarray, int, float]]:
    """Bruck all-gather: ceil(log2 n) rounds; in round i node s sends its
    accumulated min(2^i, n - 2^i) blocks (of 1/n payload each) to
    (s - 2^i) mod n."""
    s = np.arange(n)
    out = []
    i = 0
    while (1 << i) < n:
        blocks = min(1 << i, n - (1 << i))
        D = np.zeros((n, n))
        D[s, (s - (1 << i)) % n] = blocks / float(n)
        out.append((D, 1, 1.0))
        i += 1
    return out


def _logical_rounds_binomial(n: int, root: int
                             ) -> List[Tuple[np.ndarray, int, float]]:
    """Binomial-tree broadcast from ``root``: in round i every node that
    already holds the payload (rank-distance < 2^i from the root) forwards the
    full payload to rank-distance +2^i."""
    out = []
    i = 0
    while (1 << i) < max(n, 2):
        D = np.zeros((n, n))
        senders = np.arange(min(1 << i, n))
        receivers = senders + (1 << i)
        keep = receivers < n
        D[(senders[keep] + root) % n, (receivers[keep] + root) % n] = 1.0
        if keep.any():
            out.append((D, 1, 1.0))
        i += 1
    return out


def _unpack_topo(topo: Union[Topology, Tuple[np.ndarray, int]]
                 ) -> Tuple[str, int, np.ndarray]:
    """(name, n, padded table) from a Topology or a ``(table, n)`` pair; the
    schedules below all need at least two nodes (and hence k >= 1 slots)."""
    if isinstance(topo, Topology):
        name, n = topo.name, topo.n
        table = topo.gather_operands()[0]
    else:
        table, n = np.asarray(topo[0]), int(topo[1])
        name = f"table(n={n})"
    if n < 2:
        raise ValueError(f"simulation needs at least 2 nodes, got n={n}")
    return name, n, table


def _lower_demand_rounds(table: np.ndarray, routing: RoutingResult,
                         logical: List[Tuple[np.ndarray, int, float]],
                         chunk: int, scheme: str = "minimal",
                         slack: int = 1, *,
                         device: Device = DEFAULT_DEVICE
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    float]:
    """Lower logical (demand, count) rounds onto the gather-table slots under
    one of the traffic layer's routing schemes (minimal ECMP by default —
    Valiant/UGAL/ksp let executed collectives ride non-minimal paths)."""
    dist = routing.dist
    reachable = dist >= 0
    rounds, counts, hops = [], [], []
    dropped = 0.0
    for D, count, _scale in logical:
        served = np.where(reachable, D, 0.0)
        np.fill_diagonal(served, 0.0)
        dropped += count * float(D.sum() - np.trace(D) - served.sum())
        loads, _, max_hops = scheme_link_loads(
            table, routing, served, scheme, slack=slack, chunk=chunk,
            device=device)
        rounds.append(loads)
        counts.append(count)
        hops.append(int(max_hops))
    return (np.stack(rounds), np.asarray(counts, dtype=np.int32),
            np.asarray(hops, dtype=np.int32), dropped)


def _bfs_tree_rounds(table: np.ndarray, dist_root: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Broadcast over a BFS spanning tree: round d loads exactly the physical
    parent→child links between depths d-1 and d (no ECMP — every transfer is
    one hop).  Each child's parent is its lowest-id neighbor one layer up."""
    n, k = table.shape
    depth = int(dist_root.max())
    nbr_dist = dist_root[table]                        # (n, k)
    is_parent = nbr_dist == (dist_root[:, None] - 1)
    # lowest-id parent per reached non-root vertex (stable, deterministic)
    parent_ids = np.where(is_parent, table, n)
    parent = parent_ids.min(axis=1)
    rounds, counts, hops = [], [], []
    for d in range(1, depth + 1):
        children = np.nonzero((dist_root == d) & (parent < n))[0]
        loads = np.zeros((n, k), dtype=np.float64)
        for c in children:                             # host-side; <= n total
            row = table[parent[c]]
            j = int(np.nonzero(row == c)[0][0])
            loads[parent[c], j] += 1.0
        rounds.append(loads)
        counts.append(1)
        hops.append(1)
    if not rounds:                                     # n == 1 or shattered root
        rounds = [np.zeros((n, k), dtype=np.float64)]
        counts, hops = [1], [0]
    return (np.stack(rounds), np.asarray(counts, dtype=np.int32),
            np.asarray(hops, dtype=np.int32))


@obs.traced("simulate/compile_schedule", phase="compile")
def compile_schedule(topo: Union[Topology, Tuple[np.ndarray, int]],
                     collective: str = "all_reduce",
                     algorithm: Optional[str] = None, *,
                     routing: Optional[RoutingResult] = None,
                     root: int = 0,
                     scheme: str = "minimal",
                     slack: int = 1,
                     chunk: int = DEFAULT_SOURCE_CHUNK,
                     device: Device = DEFAULT_DEVICE) -> Schedule:
    """Lower one collective algorithm onto a topology's physical links.

    Args:
        topo: a :class:`Topology` or ``(table, n)`` padded gather-table pair
            (the degraded-operation entry point).
        collective: key of :data:`SIM_ALGORITHMS` (``all_reduce``,
            ``reduce_scatter``, ``all_gather``, ``broadcast``).
        algorithm: schedule algorithm; default is the collective's first
            entry in :data:`SIM_ALGORITHMS`.  ``halving_doubling`` requires a
            power-of-two node count.
        routing: reuse an all-sources :class:`RoutingResult` (e.g. from a
            lazy Analysis session); computed here when absent.
        root: broadcast root vertex.
        scheme: routing scheme used to lower each logical round onto links
            (one of :data:`repro_torch.core.traffic.ROUTING_SCHEMES`).
            Non-minimal
            schemes let executed collectives ride Valiant/UGAL/ksp paths;
            ``bfs_tree`` schedules are physical trees and ignore it.
        slack: extra hops beyond shortest for ``scheme="ksp"``.
        chunk: sources per ECMP device call (memory knob).
        device: where routing and the lowering run (default the card).

    Returns:
        A :class:`Schedule` of unique ``(n, k)`` per-round transfer tensors
        (bytes per unit payload), repetition counts, and per-round hop counts.
        Demand between disconnected pairs is dropped and accounted in
        ``dropped_demand``.
    """
    name, n, table = _unpack_topo(topo)
    if collective not in SIM_ALGORITHMS:
        raise ValueError(f"unknown collective {collective!r} "
                         f"(known: {sorted(SIM_ALGORITHMS)})")
    algorithm = algorithm or SIM_ALGORITHMS[collective][0]
    if algorithm not in SIM_ALGORITHMS[collective]:
        raise ValueError(f"unknown algorithm {algorithm!r} for {collective} "
                         f"(known: {SIM_ALGORITHMS[collective]})")
    if scheme not in ROUTING_SCHEMES:
        raise ValueError(f"unknown routing scheme {scheme!r} "
                         f"(known: {ROUTING_SCHEMES})")
    dev = resolve_device(device)
    if routing is None:
        routing = analyze_routing((table, n), chunk=chunk, device=dev)
    if not routing.exact:
        raise ValueError("schedule compilation needs an all-sources routing "
                         f"result (got {routing.sources.size}/{n} sources)")
    dropped = 0.0
    if algorithm == "bfs_tree":
        rounds, counts, hops = _bfs_tree_rounds(table, routing.dist[root])
        dropped = float((routing.dist[root] < 0).sum())
    else:
        if algorithm == "ring":
            logical = _logical_rounds_ring(
                n, phases=2 if collective == "all_reduce" else 1)
        elif algorithm == "halving_doubling":
            logical = _logical_rounds_halving_doubling(
                n, phases=2 if collective == "all_reduce" else 1)
        elif algorithm == "bruck":
            logical = _logical_rounds_bruck(n)
        else:                                          # binomial broadcast
            logical = _logical_rounds_binomial(n, root)
        rounds, counts, hops, dropped = _lower_demand_rounds(
            table, routing, logical, chunk, scheme=scheme, slack=slack,
            device=dev)
    return Schedule(name=name, collective=collective, algorithm=algorithm,
                    n=n, k=int(table.shape[1]), round_bytes=rounds,
                    counts=counts, hops=hops, dropped_demand=dropped)


# --------------------------------------------------------------------------
# the round engine
# --------------------------------------------------------------------------

def _engine(round_bytes: torch.Tensor, counts: np.ndarray,
            hops: torch.Tensor, payload: torch.Tensor, link_bw: float,
            hop_latency: float, busy: bool = True):
    """Advance rounds until B schedules are drained, at P payloads.

    ``round_bytes`` (B, U, n, k) and ``hops`` (B, U) on the device, ``counts``
    (U,) on the host, ``payload`` (P,) on the device; float64.  Each unique
    round u: every directed slot drains ``round_bytes[:, u] * payload`` at
    ``link_bw``; the round takes ``max_link_bytes / link_bw + hops[:, u] *
    hop_latency`` seconds (synchronous rounds: the most contended link gates
    everyone) and repeats ``counts[u]`` times.  One pass of the loop per
    unique round, the payload axis broadcast.  Returns (total seconds
    (B, P), (B, P, n, k) per-slot busy seconds or None).
    """
    B, U = round_bytes.shape[:2]
    total = torch.zeros((B, payload.shape[0]), dtype=torch.float64,
                        device=payload.device)
    busy_s = torch.zeros((B, payload.shape[0]) + round_bytes.shape[2:],
                         dtype=torch.float64, device=payload.device) \
        if busy else None
    for u in range(U):
        rb = round_bytes[:, u]                                 # (B, n, k)
        peak = rb.reshape(B, -1).amax(dim=1)                   # (B,)
        t_round = (peak[:, None] * payload[None, :]) / link_bw \
            + hops[:, u, None] * hop_latency
        c = float(counts[u])
        total += c * t_round
        if busy:
            busy_s += c * (rb[:, None] * payload[None, :, None, None]
                           / link_bw)
    return total, busy_s


@dataclasses.dataclass
class RoundTelemetry:
    """Per-round engine telemetry, indexed by **unique** round ``u``.

    Computed host-side from the compiled schedule at one payload size (the
    largest of the sweep), so it costs no extra device work.  Link loads are
    per **unit payload** (the :class:`Schedule` convention): for a one-round
    traffic schedule ``round_max_link_load.max()`` equals the static routing
    layer's ``max_link_load`` on the same demand — the executed counterpart
    of the quantity Theorem 2's spectral bound controls.  Utilizations are
    busy fractions of the round: ``round_util_max`` is the straggler link's
    drain share ``bw_seconds / round_seconds`` and ``round_util_mean``
    averages over loaded slots.  ``hot_node[u], hot_slot[u]`` name the argmax
    contended directed link as gather-table coordinates (the physical link is
    ``hot_node -> table[hot_node, hot_slot]``).
    """
    round_seconds: np.ndarray          # (U,) seconds per execution of round u
    round_bw_seconds: np.ndarray       # (U,) straggler-link drain term
    round_latency_seconds: np.ndarray  # (U,) hops[u] * hop_latency term
    round_max_link_load: np.ndarray    # (U,) peak slot bytes per unit payload
    round_mean_link_load: np.ndarray   # (U,) mean over loaded slots
    round_util_max: np.ndarray         # (U,) straggler busy fraction
    round_util_mean: np.ndarray        # (U,) mean loaded-slot busy fraction
    hot_node: np.ndarray               # (U,) argmax link source node
    hot_slot: np.ndarray               # (U,) argmax link gather-table slot
    counts: np.ndarray                 # (U,) repetitions of each unique round
    hops: np.ndarray                   # (U,) store-and-forward hops
    payload_bytes: float               # payload the seconds are computed at

    @property
    def unique_rounds(self) -> int:
        return int(self.round_seconds.shape[0])

    def argmax_link(self) -> Tuple[int, int]:
        """(node, slot) of the most contended link over ALL rounds."""
        u = int(self.round_max_link_load.argmax())
        return int(self.hot_node[u]), int(self.hot_slot[u])

    def total_seconds(self) -> float:
        """Engine-identity check: ``sum(counts * round_seconds)`` equals the
        measured completion time at ``payload_bytes`` (up to f32 rounding)."""
        return float((self.counts.astype(np.float64)
                      * self.round_seconds).sum())

    def to_dict(self) -> Dict:
        """JSON-ready per-round arrays (lists; U is small by construction)."""
        node, slot = self.argmax_link()
        return dict(
            unique_rounds=self.unique_rounds,
            payload_bytes=float(self.payload_bytes),
            round_seconds=[round(float(t), 9) for t in self.round_seconds],
            round_bw_seconds=[round(float(t), 9)
                              for t in self.round_bw_seconds],
            round_latency_seconds=[round(float(t), 9)
                                   for t in self.round_latency_seconds],
            round_max_link_load=[round(float(x), 9)
                                 for x in self.round_max_link_load],
            round_mean_link_load=[round(float(x), 9)
                                  for x in self.round_mean_link_load],
            round_util_max=[round(float(x), 6) for x in self.round_util_max],
            round_util_mean=[round(float(x), 6)
                             for x in self.round_util_mean],
            hot_link=[node, slot],
            counts=[int(c) for c in self.counts],
            hops=[int(h) for h in self.hops])


def _round_telemetry(schedule: Schedule, payload: float, link_bw: float,
                     hop_latency: float) -> RoundTelemetry:
    """Host-side per-round accounting mirroring the engine's round formula."""
    rb = np.asarray(schedule.round_bytes, dtype=np.float64)
    U = rb.shape[0]
    flat = rb.reshape(U, -1)
    idx = flat.argmax(axis=1)
    max_load = flat[np.arange(U), idx]
    node, slot = np.unravel_index(idx, rb.shape[1:])
    loaded = (flat > 0).sum(axis=1)
    mean_load = np.where(loaded > 0,
                         flat.sum(axis=1) / np.maximum(loaded, 1), 0.0)
    bw_s = max_load * payload / link_bw
    lat_s = schedule.hops.astype(np.float64) * hop_latency
    round_s = bw_s + lat_s
    safe = np.where(round_s > 0, round_s, 1.0)
    util_max = np.where(round_s > 0, bw_s / safe, 0.0)
    util_mean = np.where(round_s > 0,
                         mean_load * payload / link_bw / safe, 0.0)
    return RoundTelemetry(
        round_seconds=round_s, round_bw_seconds=bw_s,
        round_latency_seconds=lat_s, round_max_link_load=max_load,
        round_mean_link_load=mean_load, round_util_max=util_max,
        round_util_mean=util_mean,
        hot_node=node.astype(np.int64), hot_slot=slot.astype(np.int64),
        counts=np.asarray(schedule.counts),
        hops=np.asarray(schedule.hops), payload_bytes=float(payload))


@dataclasses.dataclass
class SimulationResult:
    """Measured execution of one schedule at one or more payload sizes.

    ``time_seconds[i]`` is the completion time at ``payload_bytes[i]``;
    ``link_busy_seconds`` (per directed slot, at the LARGEST payload) divided
    by that payload's completion time gives per-link utilization.  Padding
    slots never carry bytes and stay 0.
    """
    name: str
    collective: str
    algorithm: str
    n: int
    rounds: int
    unique_rounds: int
    payload_bytes: np.ndarray      # (B,) bytes per node
    time_seconds: np.ndarray       # (B,) measured completion seconds
    link_busy_seconds: np.ndarray  # (n, k) busy seconds at the largest payload
    max_link_bytes: float          # peak per-round slot bytes per unit payload
    total_bytes: float             # link bytes moved per unit payload (all rounds)
    utilization_max: float         # busiest slot's busy fraction (largest payload)
    utilization_mean: float        # mean busy fraction over loaded slots
    dropped_demand: float          # unit-payload bytes to unreachable targets
    saturation_throughput: Optional[float]  # traffic workloads only (1/max load)
    seconds: float                 # wall time (compile + engine)
    telemetry: Optional[RoundTelemetry] = None  # run_schedule(telemetry=True)

    def utilization(self, index: int = -1) -> np.ndarray:
        """(n, k) busy fraction of each directed slot at payload ``index``."""
        t = float(self.time_seconds[index])
        if t <= 0:
            return np.zeros_like(self.link_busy_seconds)
        scale = float(self.payload_bytes[index] / self.payload_bytes.max())
        return self.link_busy_seconds * scale / t

    def hot_links(self, table: np.ndarray, top: int = 5
                  ) -> List[Tuple[int, int, float]]:
        """The ``top`` most-utilized directed links as (u, v, busy fraction)."""
        util = self.utilization()
        flat = np.argsort(-util, axis=None)[:top]
        out = []
        for f in flat:
            u, j = np.unravel_index(f, util.shape)
            out.append((int(u), int(table[u, j]), float(util[u, j])))
        return out

    def utilization_histogram(self, bins: int = 10) -> Dict[str, List[float]]:
        """Histogram of per-slot busy fractions over LOADED slots (the
        congestion picture: a tight histogram means balanced links)."""
        util = self.utilization()
        loaded = util[self.link_busy_seconds > 0]
        counts, edges = np.histogram(loaded, bins=bins,
                                     range=(0.0, max(1.0, float(util.max()))))
        return dict(counts=counts.tolist(), edges=np.round(edges, 6).tolist())

    def to_dict(self) -> Dict:
        """JSON-ready summary (drops the (n, k) busy matrix)."""
        return dict(
            name=self.name, collective=self.collective,
            algorithm=self.algorithm, n=self.n, rounds=self.rounds,
            unique_rounds=self.unique_rounds,
            payload_bytes=[float(p) for p in self.payload_bytes],
            time_seconds=[float(t) for t in self.time_seconds],
            max_link_bytes=round(self.max_link_bytes, 9),
            total_bytes=round(self.total_bytes, 6),
            utilization_max=round(self.utilization_max, 6),
            utilization_mean=round(self.utilization_mean, 6),
            dropped_demand=round(self.dropped_demand, 6),
            saturation_throughput=None if self.saturation_throughput is None
                else round(self.saturation_throughput, 6),
            seconds=round(self.seconds, 3),
            telemetry=None if self.telemetry is None
                else self.telemetry.to_dict())

    def report(self) -> str:
        """Compact text block for CLI reports."""
        times = ", ".join(f"{p / 1e6:.1f}MB: {t * 1e3:.3f}ms"
                          for p, t in zip(self.payload_bytes,
                                          self.time_seconds))
        return "\n".join([
            f"simulated       : {self.collective}/{self.algorithm} "
            f"({self.rounds} rounds, {self.unique_rounds} unique)",
            f"measured time   : {times}",
            f"link utilization: max {self.utilization_max:.3f} / "
            f"mean {self.utilization_mean:.3f} busy fraction",
        ])


@obs.traced("simulate/run_schedule", phase="execute")
def run_schedule(schedule: Schedule,
                 payloads: Union[float, Sequence[float]] = float(1 << 26), *,
                 link_bw: float = LINK_BW,
                 hop_latency: float = PER_HOP_LATENCY,
                 saturation_throughput: Optional[float] = None,
                 t0: Optional[float] = None,
                 telemetry: bool = False,
                 device: Device = DEFAULT_DEVICE) -> SimulationResult:
    """Execute a compiled schedule at B payload sizes in one engine pass.

    Args:
        schedule: output of :func:`compile_schedule`.
        payloads: payload bytes per node — a scalar or a sequence (the engine
            runs all of them at once, as one broadcast axis).
        link_bw: bytes/second each directed link drains.
        hop_latency: seconds charged per hop of a round's longest transfer.
        saturation_throughput: passed through to the result (set by
            :func:`simulate_traffic`).
        t0: wall-clock start to attribute compile time to the result.
        telemetry: attach a :class:`RoundTelemetry` (per-round times, link
            loads, utilizations, argmax contended link) computed at the
            largest payload of the sweep.
        device: where the engine runs (default the card).

    Returns:
        :class:`SimulationResult` with simulated times (seconds) and per-link
        utilization accounting.
    """
    t0 = time.time() if t0 is None else t0
    dev = resolve_device(device)
    pay = np.atleast_1d(np.asarray(payloads, dtype=np.float64))
    order = np.argsort(pay, kind="stable")
    times, busy = _engine(
        torch.as_tensor(schedule.round_bytes, dtype=torch.float64,
                        device=dev)[None],
        np.asarray(schedule.counts),
        torch.as_tensor(schedule.hops, dtype=torch.float64, device=dev)[None],
        torch.as_tensor(pay, device=dev), float(link_bw), float(hop_latency))
    times = times[0].cpu().numpy()
    busy_last = busy[0, int(order[-1])].cpu().numpy()
    t_last = float(times[order[-1]])
    util = busy_last / t_last if t_last > 0 else np.zeros_like(busy_last)
    loaded = util[busy_last > 0]
    tel = None
    if telemetry:
        tel = _round_telemetry(schedule, float(pay[order[-1]]),
                               link_bw, hop_latency)
    return SimulationResult(
        name=schedule.name, collective=schedule.collective,
        algorithm=schedule.algorithm, n=schedule.n, rounds=schedule.rounds,
        unique_rounds=schedule.unique_rounds,
        payload_bytes=pay, time_seconds=times,
        link_busy_seconds=busy_last,
        max_link_bytes=float(schedule.round_bytes.max()),
        total_bytes=float(schedule.total_link_bytes().sum()),
        utilization_max=float(util.max()) if util.size else 0.0,
        utilization_mean=float(loaded.mean()) if loaded.size else 0.0,
        dropped_demand=schedule.dropped_demand,
        saturation_throughput=saturation_throughput,
        seconds=time.time() - t0, telemetry=tel)


# --------------------------------------------------------------------------
# one-call drivers
# --------------------------------------------------------------------------

def simulate_collective(topo: Union[Topology, Tuple[np.ndarray, int]],
                        collective: str = "all_reduce",
                        algorithm: Optional[str] = None, *,
                        payloads: Union[float, Sequence[float]] = float(1 << 26),
                        link_bw: float = LINK_BW,
                        hop_latency: float = PER_HOP_LATENCY,
                        routing: Optional[RoutingResult] = None,
                        root: int = 0,
                        scheme: str = "minimal",
                        slack: int = 1,
                        chunk: int = DEFAULT_SOURCE_CHUNK,
                        telemetry: bool = False,
                        device: Device = DEFAULT_DEVICE) -> SimulationResult:
    """Compile + execute one collective on one topology (see
    :func:`compile_schedule` / :func:`run_schedule` for the arguments).

    Returns a :class:`SimulationResult`; ``time_seconds`` is directly
    comparable to the :class:`~repro_torch.core.collectives.NetworkModel`
    prediction at the same payload (same ``link_bw`` / ``hop_latency``
    constants), which is what ``NetworkModel.validate`` ratios.
    """
    t0 = time.time()
    sched = compile_schedule(topo, collective, algorithm, routing=routing,
                             root=root, scheme=scheme, slack=slack,
                             chunk=chunk, device=device)
    return run_schedule(sched, payloads, link_bw=link_bw,
                        hop_latency=hop_latency, t0=t0, telemetry=telemetry,
                        device=device)


def simulate_traffic(topo: Union[Topology, Tuple[np.ndarray, int]],
                     pattern: str = "uniform", *,
                     payloads: Union[float, Sequence[float]] = float(1 << 26),
                     link_bw: float = LINK_BW,
                     hop_latency: float = PER_HOP_LATENCY,
                     routing: Optional[RoutingResult] = None,
                     fiedler: Optional[np.ndarray] = None,
                     demands: Optional[np.ndarray] = None,
                     scheme: str = "minimal",
                     slack: int = 1,
                     chunk: int = DEFAULT_SOURCE_CHUNK,
                     telemetry: bool = False,
                     device: Device = DEFAULT_DEVICE) -> SimulationResult:
    """Execute one traffic workload: every node injects ``payload`` bytes
    spread per the demand matrix, in one contention round on the links.

    The measured ``saturation_throughput`` (1 / peak per-unit-payload link
    bytes × per-node demand) is the executed counterpart of
    :attr:`repro_torch.core.traffic.TrafficResult.saturation_throughput` —
    same injection-units convention, so the two figures are directly
    comparable (and the spectral prediction
    :func:`~repro_torch.core.traffic.spectral_throughput_estimate` ratios
    both).

    Args: as :func:`simulate_collective`, plus ``pattern`` /
    ``fiedler`` / ``demands`` / ``scheme`` / ``slack`` as in
    :func:`repro_torch.core.traffic.evaluate_traffic`.
    """
    t0 = time.time()
    dev = resolve_device(device)
    name, n, table = _unpack_topo(topo)
    if routing is None:
        routing = analyze_routing((table, n), chunk=chunk, device=dev)
    if demands is None:
        D = demand_matrix(pattern, n, fiedler=fiedler)
    else:
        D = np.asarray(demands, dtype=np.float64)
        pattern = "custom"
    rounds, counts, hops, dropped = _lower_demand_rounds(
        table, routing, [(D, 1, 1.0)], chunk, scheme=scheme, slack=slack,
        device=dev)
    sched = Schedule(name=name, collective=f"traffic:{pattern}",
                     algorithm="ecmp" if scheme == "minimal" else scheme,
                     n=n, k=int(table.shape[1]),
                     round_bytes=rounds, counts=counts, hops=hops,
                     dropped_demand=dropped)
    max_load = float(rounds.max())
    thpt = 1.0 / max_load if max_load > 0 else float("inf")
    return run_schedule(sched, payloads, link_bw=link_bw,
                        hop_latency=hop_latency,
                        saturation_throughput=thpt, t0=t0,
                        telemetry=telemetry, device=dev)


# --------------------------------------------------------------------------
# fault stacks: B degraded samples -> B lowerings + one engine pass
# --------------------------------------------------------------------------

def stacked_ring_allreduce(tables: np.ndarray,
                           payload: float = float(1 << 26), *,
                           link_bw: float = LINK_BW,
                           hop_latency: float = PER_HOP_LATENCY,
                           chunk: int = DEFAULT_SOURCE_CHUNK,
                           device: Device = DEFAULT_DEVICE) -> Dict:
    """Ring all-reduce times for B stacked padded tables, one engine pass.

    This is the fault-subsystem hook: ``tables`` is the (B, n, k) block
    :func:`repro_torch.core.faults.stacked_operands` builds for a batch of
    degraded samples.  The reference vmaps BFS + ECMP over the stack; here
    the samples are lowered one after another, each sample's source chunk
    (``chunk`` sources, capped by the ECMP tile budget) forming one
    shared-table batch of BFS, path counts and the backward accumulation on
    the device (K1's f64 batch form on the card) — a (B, S, n) operand
    would cost B·S·n·k gathers' worth of table copies.  All B schedules then
    execute in ONE engine pass.  Demand between disconnected pairs is
    dropped (and reported), exactly like the healthy compiler.  Float64
    throughout (the reference casts sigma and the demands to float32 here).

    Args:
        tables: (B, n, k) int padded neighbor tables.
        payload: all-reduce bytes per node.
        link_bw / hop_latency: engine constants (see :func:`run_schedule`).
        chunk: BFS/ECMP sources per device call.
        device: where the lowering and the engine run (default the card).

    Returns:
        dict with ``time_seconds`` (B,), ``dropped_frac`` (B,) — fraction of
        the ring demand dropped per sample — plus ``rounds`` and ``payload``.
    """
    dev = resolve_device(device)
    tables = np.asarray(tables)
    B, n, k = tables.shape
    D = _logical_rounds_ring(n, phases=1)[0][0]   # the healthy ring demand
    loads = torch.zeros((B, n, k), dtype=torch.float64, device=dev)
    hops = torch.zeros(B, dtype=torch.float64, device=dev)
    dropped = torch.zeros(B, dtype=torch.float64, device=dev)
    inner = _source_tile(chunk, n, k)
    for b in range(B):
        tab = torch.as_tensor(tables[b], dtype=torch.int32, device=dev)
        tab64 = tab.long()
        for lo in range(0, n, inner):
            hi = min(lo + inner, n)
            dist = _bfs_dist_chunk(tab64, _start_block(np.arange(lo, hi), n,
                                                       dev))
            sigma = _sigma_chunk(tab, dist)
            dem = torch.as_tensor(D[lo:hi], dtype=torch.float64, device=dev)
            served = torch.where(dist >= 0, dem, 0.0)
            loads[b] += _ecmp_loads_chunk(tab, dist, sigma, served)
            hops[b] = torch.maximum(
                hops[b], torch.where(served > 0, dist, 0).amax().double())
            dropped[b] += torch.where(dist < 0, dem, 0.0).sum()
    counts = np.array([2 * (n - 1)], dtype=np.int64)
    times, _ = _engine(loads[:, None], counts, hops[:, None],
                       torch.tensor([float(payload)], dtype=torch.float64,
                                    device=dev),
                       float(link_bw), float(hop_latency), busy=False)
    dropped = dropped.cpu().numpy()
    total = float(D.sum())
    return dict(
        time_seconds=times[:, 0].cpu().numpy(),
        dropped_frac=dropped / total if total > 0 else dropped,
        rounds=int(counts[0]), payload=float(payload))
