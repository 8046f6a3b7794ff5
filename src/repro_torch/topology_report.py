"""Paper-style topology report (Table 1 + Ramanujan comparison) for any
registered topology, addressed by spec string — the port's counterpart of
``examples/topology_report.py``, with the same flags plus ``--device``::

    PYTHONPATH=src python -m repro_torch.topology_report "slimfly(q=13)"
    PYTHONPATH=src python -m repro_torch.topology_report "torus(16,2)" \\
        --fault-rate 0.05
    PYTHONPATH=src python -m repro_torch.topology_report "torus(16,2)" --routing
    PYTHONPATH=src python -m repro_torch.topology_report "slimfly(13)" \\
        --workload "qwen2_7b@dp=16,tp=4" --placement random
    PYTHONPATH=src python -m repro_torch.topology_report --list

``--fault-rate`` appends the resilience block (survival statistics under the
chosen fault model, from the batched degraded-Lanczos sweep); ``--routing``
appends the measured path structure and the ECMP link loads of
``--traffic-pattern``; ``--workload`` appends the executed training step of
a workload spec (``"kimi_k2_1t@dp=64,tp=8,ep=16"``): its closed-form
communication plan and per-phase link times on this topology, in seconds of
the modeled cluster.  ``--trace out.json`` records the run as
:mod:`repro_torch.obs` spans, prints the span tree and writes Chrome-trace
JSON.

Every quantity runs on ``--device`` (default ``cuda``, which raises without
a card; pass ``--device cpu`` to run on the host).
"""
from __future__ import annotations

import argparse
import contextlib

from repro_torch import obs
from repro_torch.api import REGISTRY, Analysis


def list_families() -> str:
    lines = ["registered topology families:"]
    for fam in REGISTRY:
        schema = ", ".join(f"{p}:{t.__name__}" for p, t in fam.params)
        example = fam.default_instance or fam.name
        lines.append(f"  {fam.name:16s} ({schema:24s})  e.g. {example}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("spec", nargs="?", help='topology spec, e.g. "slimfly(q=13)"')
    ap.add_argument("--list", action="store_true",
                    help="list registered families and their spec schemas")
    ap.add_argument("--dense-threshold", type=int, default=4096,
                    help="largest n using the dense float64 oracle")
    ap.add_argument("--lanczos-iters", type=int, default=200)
    ap.add_argument("--fault-rate", type=float, default=None,
                    help="append a resilience block at this fault rate")
    ap.add_argument("--fault-model", default="link",
                    choices=["link", "node", "attack_degree", "attack_spectral"])
    ap.add_argument("--fault-samples", type=int, default=32)
    ap.add_argument("--routing", action="store_true",
                    help="append measured path structure + traffic loads")
    ap.add_argument("--traffic-pattern", default="uniform",
                    help="traffic pattern for --routing (uniform, "
                         "bit_complement, transpose, neighbor, adversarial)")
    ap.add_argument("--workload", default=None, metavar="SPEC",
                    help='append an executed-training-step block for a '
                         'workload spec, e.g. "kimi_k2_1t@dp=64,tp=8,ep=16"')
    ap.add_argument("--placement", default="linear",
                    choices=["linear", "round_robin", "random"],
                    help="logical-rank -> physical-node strategy for "
                         "--workload")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record the run as repro_torch.obs spans, print the "
                         "span tree, and write Chrome-trace JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where the numerics run (default cuda)")
    args = ap.parse_args(argv)
    if args.list or not args.spec:
        print(list_families())
        if not args.spec:
            ap.error("a topology spec is required (see the list above)")
        return
    with contextlib.ExitStack() as stack:
        if args.trace:
            stack.enter_context(obs.tracing(args.trace))
        a = Analysis(args.spec, dense_threshold=args.dense_threshold,
                     lanczos_iters=args.lanczos_iters, device=args.device)
        print(a.report())
        if args.routing:
            print("--- measured path structure (routing & traffic) ---")
            print(a.routing().report())
            print(a.traffic(args.traffic_pattern).report())
        if args.workload:
            print("--- executed training step (workload lowering) ---")
            res = a.simulate(workload=args.workload, placement=args.placement)
            print(res.plan.report())
            print(res.report())
        if args.fault_rate is not None:
            print("--- resilience (degraded operation) ---")
            print(a.fault_sweep(rates=(args.fault_rate,),
                                model=args.fault_model,
                                samples=args.fault_samples).report())
        if args.trace:
            print(f"--- span tree (trace written to {args.trace}) ---")
            print(obs.render_tree())


if __name__ == "__main__":
    main()
