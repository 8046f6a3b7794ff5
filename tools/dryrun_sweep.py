"""Every dry-run cell at a cut depth: one JSON line a cell, ok or failed.

    PYTHONPATH=src python tools/dryrun_sweep.py --device cpu [--periods 1]
        [--meshes 16x16 2x16x16] [--arch qwen2-7b ...] [--out FILE]

``repro_torch.launch.dryrun``'s ``--all --both-meshes`` cell list, each
cell traced by ``lower_cell`` with its depth cut to ``periods`` repeats of
its layer pattern (one layer for a uniform model, eight for jamba), so that
the whole list traces in minutes where full depth would take hours.  Each
line: the tag, ``ok`` or the error, the layers traced, the trace seconds,
per-device FLOPs and bytes, argument and peak bytes, collective bytes by
kind and the dominant roofline term (the card's constants).  One fake
world a mesh.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--periods", type=int, default=1)
    ap.add_argument("--meshes", nargs="+", default=["16x16", "2x16x16"])
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    out = open(args.out, "a") if args.out else None
    failures = 0
    for mesh in args.meshes:
        mp = mesh == "2x16x16"
        world = int(np.prod(list(make_production_mesh(
            multi_pod=mp).shape.values())))
        cells = [c for c in D.cell_list(True, multi_pod=mp)
                 if not args.arch or c[0] in args.arch]
        with D.fake_world(world):
            for arch, shape, _ in cells:
                layers = args.periods * len(get_config(arch).pattern)
                row = dict(tag=D.cell_tag(arch, shape, mp), layers=layers,
                           full_layers=get_config(arch).n_layers)
                t0 = time.time()
                try:
                    r, _ = D.lower_cell(arch, shape, mp,
                                        overrides=dict(n_layers=layers),
                                        device=args.device)
                    row.update(
                        ok=True, trace_seconds=r["compile_seconds"],
                        flops_per_device=r["cost"]["flops_per_device"],
                        bytes_per_device=r["cost"]["bytes_per_device"],
                        argument_bytes=r["memory"]["argument_bytes"],
                        peak_bytes=r["memory"]["peak_bytes"],
                        collective_bytes=r["collectives"]["bytes_by_kind"],
                        dominant=r["roofline"]["dominant"], device=r["device"])
                except Exception as e:        # recorded, counted, and on
                    failures += 1
                    row.update(ok=False, error=f"{type(e).__name__}: {e}"[:500])
                row["seconds"] = time.time() - t0
                line = json.dumps(row)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
