"""Job placement & degraded-operation guarantees from the discrepancy property
(PyTorch port of the reference module; numpy only, host-side).

The paper's §3 observation: on a Ramanujan topology, *any* alpha-fraction of
nodes retains bisection bandwidth >= (alpha k n/2)(alpha/2 - 2 sqrt(k-1)/k (1 -
alpha/2)) — independent of WHICH nodes.  This is the formal basis for
fault-tolerant/elastic scheduling without re-packing: after failures the
surviving node set keeps a certified bandwidth floor.

A torus offers no such guarantee: a scattered alpha-subset can have near-zero
internal bandwidth.  ``empirical_subset_bw`` measures that gap.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bounds import active_subset_bw_lb
from .ramanujan import ramanujan_bound
from .graphs import Topology

__all__ = ["PlacementGuarantee", "ramanujan_placement_guarantee",
           "empirical_subset_bw", "min_alpha_for_positive_guarantee",
           "place_ranks"]


def place_ranks(n: int, world: int, strategy: str = "linear",
                seed: int = 0) -> np.ndarray:
    """Map ``world`` logical job ranks onto ``n`` physical nodes.

    The workload compiler (:mod:`repro_torch.core.workloads`) uses this to
    pin a training job's rank grid to a topology; traffic between ranks that
    land on the same node is free.  Ranks are spread as evenly as possible:
    node loads differ by at most one for every strategy.

    Strategies:
      * ``"linear"`` — rank ``r`` -> node ``r * n // world``: consecutive
        ranks stay adjacent in node id, so axis-local groups (TP blocks)
        co-locate when the job oversubscribes the machine.
      * ``"round_robin"`` — rank ``r`` -> node ``r % n``: consecutive ranks
        land on distinct nodes (stripes every group across the machine).
      * ``"random"`` — the linear assignment pushed through a seeded node
        permutation: balanced but uniformly scattered, the
        placement-agnostic setting of the paper's discrepancy argument.

    Args:
        n: physical node count (>= 1).
        world: logical rank count (>= 1); may exceed ``n`` (oversubscribed)
            or be below ``n`` (idle nodes).
        strategy: one of the three names above.
        seed: RNG seed for ``"random"``.

    Returns:
        int array of shape ``(world,)``; entry ``r`` is the node of rank ``r``.
    """
    if n < 1 or world < 1:
        raise ValueError(f"need n >= 1 and world >= 1, got n={n}, "
                         f"world={world}")
    ranks = np.arange(world)
    if strategy == "linear":
        return (ranks * n) // world
    if strategy == "round_robin":
        return ranks % n
    if strategy == "random":
        perm = np.random.default_rng(seed).permutation(n)
        return perm[(ranks * n) // world]
    raise ValueError(f"unknown placement strategy {strategy!r} "
                     "(known: linear, round_robin, random)")


@dataclasses.dataclass(frozen=True)
class PlacementGuarantee:
    topology: str
    alpha: float
    nodes_active: int
    guaranteed_bisection_edges: float   # certified floor (>= 0 means usable)
    note: str = ""


def ramanujan_placement_guarantee(n: int, k: int, alpha: float) -> PlacementGuarantee:
    g = active_subset_bw_lb(alpha, n, k)
    return PlacementGuarantee(
        topology=f"ramanujan(n={n},k={k})", alpha=alpha,
        nodes_active=int(alpha * n), guaranteed_bisection_edges=max(g, 0.0),
        note="discrepancy property — holds for ANY active subset")


def min_alpha_for_positive_guarantee(k: int) -> float:
    """Smallest alpha with a positive discrepancy floor:
    alpha/2 > (2 sqrt(k-1)/k)(1 - alpha/2)  =>  alpha > 2c/(1+c), c = 2 sqrt(k-1)/k."""
    c = ramanujan_bound(k) / k
    return 2.0 * c / (1.0 + c)


def empirical_subset_bw(topo: Topology, alpha: float, trials: int = 32,
                        seed: int = 0) -> float:
    """Worst observed bisection bandwidth across random alpha-subsets,
    bisected by a random balanced split of the subset (upper bound on the
    subset's bisection; lower is worse)."""
    rng = np.random.default_rng(seed)
    worst = np.inf
    na = max(2, int(alpha * topo.n))
    u, v = topo.edges[:, 0], topo.edges[:, 1]
    for _ in range(trials):
        sub = rng.choice(topo.n, size=na, replace=False)
        half = rng.permutation(na)
        side = np.zeros(topo.n, dtype=np.int8)  # 0 = inactive
        side[sub[half[: na // 2]]] = 1
        side[sub[half[na // 2:]]] = 2
        cross = float(np.sum((side[u] == 1) & (side[v] == 2))
                      + np.sum((side[u] == 2) & (side[v] == 1)))
        worst = min(worst, cross)
    return worst
