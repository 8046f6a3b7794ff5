"""Quickstart: the paper in 60 seconds (the port of the reference's
``examples/quickstart.py``).

Builds a v5e-pod torus and an equal-radix LPS Ramanujan graph, compares
their spectral gap / bisection / diameter / fault tolerance, and shows the
predicted impact on a training step's collectives.  Every graph here has
at most 4,096 nodes, so rho_2 takes the dense path on the host, as in the
reference; ``--device`` is where a Lanczos solve would run.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import bounds as B
from repro_torch.core import spectral as S
from repro_torch.core import topologies as T
from repro_torch.core.collectives import NetworkModel, tpu_v5e_ici
from repro_torch.core.placement import (empirical_subset_bw,
                                        ramanujan_placement_guarantee)
from repro_torch.core.properties import bisection_fiedler, diameter
from repro_torch.core.ramanujan import is_ramanujan, lps
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["main"]


def main(device: str = DEFAULT_DEVICE) -> None:
    dev = resolve_device(device)
    print("=" * 72)
    print("1. A v5e pod's ICI is Torus(16,2) — the paper says tori expand badly")
    print("=" * 72)
    torus = T.torus(16, 2)
    rho2_t = S.algebraic_connectivity(torus, device=dev)
    print(f"   torus(16,2):  n={torus.n:5d} radix={torus.radix} "
          f"rho2={rho2_t:.4f}  diameter={diameter(torus, vertex_transitive=True)}")
    print(f"   Ramanujan optimum at radix 4: rho2 >= {B.ramanujan_rho2(4):.4f} "
          f"({B.ramanujan_rho2(4) / rho2_t:.1f}x better)")

    print()
    print("=" * 72)
    print("2. An actual Ramanujan graph: LPS X^{13,17} (PSL(2,F_13) Cayley)")
    print("=" * 72)
    g = lps(13, 17)
    ok, lam = is_ramanujan(g)
    print(f"   lps(13,17): n={g.n} radix={g.radix} lambda={lam:.4f} "
          f"<= 2 sqrt(k-1) = {B.ramanujan_rho2(18) and 2 * np.sqrt(17):.4f} "
          f"-> Ramanujan: {ok}")
    rho2_r = S.algebraic_connectivity(g, device=dev)
    bw, _ = bisection_fiedler(g)
    print(f"   rho2={rho2_r:.3f}; witnessed bisection={bw:.0f} edges "
          f"(Fiedler floor {B.fiedler_bw_lb(g.n, rho2_r):.0f})")

    print()
    print("=" * 72)
    print("3. What that buys a training job (collective cost model)")
    print("=" * 72)
    net_t = tpu_v5e_ici(16, 16)
    net_r = NetworkModel("ramanujan(k=4)", n=256, radix=4,
                         bisection_links=B.fiedler_bw_lb(256, B.ramanujan_rho2(4)),
                         diameter=6)
    grad_bytes = 2 * 7.6e9 / 256   # qwen2-7b bf16 grads, 256-way DP
    for net in (net_t, net_r):
        t = net.all_reduce(grad_bytes)
        print(f"   {net.name:16s} grad all-reduce: {t * 1e3:7.3f} ms "
              f"(bisection {net.bisection_links:.0f} links)")

    print()
    print("=" * 72)
    print("4. Fault tolerance: guaranteed bandwidth on ANY 90% of nodes")
    print("=" * 72)
    cert = ramanujan_placement_guarantee(g.n, g.radix, 0.9)
    emp = empirical_subset_bw(g, 0.9, trials=8)
    print(f"   discrepancy floor: {cert.guaranteed_bisection_edges:.0f} edges "
          f"(measured worst-of-8 random subsets: {emp:.0f})")
    t33 = T.torus(33, 2)
    emp_t = empirical_subset_bw(t33, 0.9, trials=8)
    print(f"   torus(33,2) same test: measured {emp_t:.0f} edges, NO floor "
          f"(guarantee requires contiguous re-packing)")


def _cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device of any Lanczos solve (default: cuda)")
    main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    _cli()
