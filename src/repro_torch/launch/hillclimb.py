"""Hill-climb: trace one cell with a named variant of its config and
print the roofline beside the baseline artifact.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen2-7b \\
        --shape train_4k --variant no_remat --overrides '{"remat": false}'

The port of the reference's ``launch/hillclimb.py``: the cell is traced by
:func:`repro_torch.launch.dryrun.lower_cell` with the overrides applied by
``dataclasses.replace``, written to ``{out}/{tag}__{variant}.json``, and one
line is printed with the baseline of ``experiments/dryrun/{tag}.json`` when
that exists.  The reference's documented variant, the float8 expert
dispatch::

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch kimi-k2-1t-a32b --shape train_4k --variant fp8_dispatch \\
        --overrides '{"moe_dispatch_dtype": "float8_e4m3fn"}'

``--device cpu`` traces the plain path; without it the card's program is
traced, and the tool raises where there is no card.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card's program) or cpu (the "
                         "plain path)")
    args = ap.parse_args(argv)

    from .dryrun import cell_tag, lower_cell

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    overrides = json.loads(args.overrides)
    tag = cell_tag(args.arch, args.shape, args.multi_pod)
    t0 = time.time()
    result, _ = lower_cell(args.arch, args.shape, args.multi_pod,
                           overrides=overrides or None, device=args.device)
    result["variant"] = args.variant
    result["overrides"] = overrides
    path = out / f"{tag}__{args.variant}.json"
    path.write_text(json.dumps(result, indent=1))
    base_path = Path("experiments/dryrun") / f"{tag}.json"
    r = result["roofline"]
    line = (f"{args.variant}: compute={r['compute_s']:.4f}s "
            f"memory={r['memory_s']:.4f}s "
            f"collective={r['collective_s']:.4f}s "
            f"dominant={r['dominant']} "
            f"[{time.time() - t0:.0f}s]")
    if base_path.exists():
        b = json.loads(base_path.read_text())["roofline"]
        line += (f"   (baseline: {b['compute_s']:.4f}/{b['memory_s']:.4f}"
                 f"/{b['collective_s']:.4f} {b['dominant']})")
    print(line)
    return line


if __name__ == "__main__":
    main()
