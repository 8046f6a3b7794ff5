"""Where the scale row's seconds go: ``xpander(65536,32,0,0)``'s survey row
(the smoke's ``scale_row``) split below its obs spans.

Runs the row ``--runs`` times in one process on the card and times, beside
the row's obs spans, the calls inside them (each bracketed by
``torch.cuda.synchronize``), filed under the solve they ran in
(``signed/`` for ``signed_extremes_batched``, ``final/`` for
``rho2_lanczos``, ``other/`` elsewhere):

* ``start_vectors`` -- ``spectral._start_vectors``, the threefry draws;
* ``signed_loop`` -- ``spectral._signed_lanczos_batched``, the ten signed
  solves' Lanczos loops (K1 launches, GEMVs, the host loop);
* ``ritz`` -- ``spectral._batched_ritz_extremes``, their host eigvals;
* ``lanczos_scan`` -- ``spectral._lanczos_scan``, a Lanczos loop;
* ``two_lift`` -- ``synthesis.two_lift``, the host lift of each level;
* ``slot_operands`` -- ``synthesis.signed_slot_operands``;
* ``seed_spectrum`` -- ``spectral.adjacency_spectrum`` (dense eig).

Each call's time is its wall time with the card drained on entry and exit.
The last run also goes through ``torch.profiler`` for the device's busy
time (kernels' summed duration). The names it wraps are the same in every
version of the port since the scale row was added, so one call can run two
trees side by side::

    python tools/scale_row_split.py --src src --runs 3
    python tools/scale_row_split.py --src /path/to/other/tree/src

``--spec 'xpander(2048,32,0,0)' --device cpu`` is a dry run on the host.

Prints the card's name and power limit, one JSON object a run, and a last
line with the medians of the unprofiled runs.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

#: (module, function, key): the calls timed; a call made inside one of
#: SCOPES is filed under that scope's name ("signed/...", "final/...")
WRAPPED = (("spectral", "_start_vectors", "start_vectors"),
           ("spectral", "_signed_lanczos_batched", "signed_loop"),
           ("spectral", "_batched_ritz_extremes", "ritz"),
           ("spectral", "_lanczos_scan", "lanczos_scan"),
           ("spectral", "adjacency_spectrum", "seed_spectrum"),
           ("synthesis", "two_lift", "two_lift"),
           ("synthesis", "signed_slot_operands", "slot_operands"))
SCOPES = (("spectral", "signed_extremes_batched", "signed"),
          ("spectral", "rho2_lanczos", "final"))
SPANS = ("synthesis/lift_search", "spectral/signed_extremes_batched",
         "spectral/rho2_lanczos", "routing/bfs", "routing/sigma",
         "traffic/ecmp", "traffic/ucb", "registry/build")


def _wrap(sync, module, name, key, totals, calls, scope):
    original = getattr(module, name)

    def timed(*args, **kwargs):
        outer = scope[-1] if scope else "other"
        sync()
        t0 = time.perf_counter()
        scope.append(key)
        try:
            return original(*args, **kwargs)
        finally:
            scope.pop()
            sync()
            where = key if key in ("signed", "final") else f"{outer}/{key}"
            totals[where] += time.perf_counter() - t0
            calls[where] += 1
    setattr(module, name, timed)


def one_row(torch, spec: str, device: str = "cuda",
            profiled: bool = False) -> dict:
    from repro_torch import obs
    from repro_torch.api import Analysis, survey
    from repro_torch.kernels import spmv as KS
    from repro_torch.specs import SCALE_COLUMNS, SCALE_NODES, SCALE_SOURCES

    from repro_torch.core import spectral, synthesis

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    modules = dict(spectral=spectral, synthesis=synthesis)
    totals, calls = collections.defaultdict(float), collections.Counter()
    scope: list = []
    saved = [(modules[m], n, getattr(modules[m], n))
             for m, n, _ in WRAPPED + SCOPES]
    for m, n, key in WRAPPED + SCOPES:
        _wrap(sync, modules[m], n, key, totals, calls, scope)
    obs.reset()
    KS.reset_launches()
    prof = None
    try:
        if profiled:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        with obs.tracing():
            sync()
            t0 = time.perf_counter()
            res = survey([Analysis(spec, device=device)], SCALE_COLUMNS,
                         routing=dict(pattern="uniform",
                                      sample_fraction=SCALE_SOURCES
                                      / SCALE_NODES, seed=0),
                         device=device)
            sync()
            seconds = time.perf_counter() - t0
            rep = obs.metrics_report()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        for module, name, original in saved:
            setattr(module, name, original)
    spans = {k: rep.spans[k].total_seconds for k in SPANS if k in rep.spans}
    out = dict(seconds=seconds, rho2=float(res.rows[0]["rho2"]), spans=spans,
               span_calls={k: rep.spans[k].calls for k in SPANS
                           if k in rep.spans},
               calls=dict(totals), call_counts=dict(calls),
               spmv_launches=KS.launches(), profiled=profiled)
    if prof is not None:
        from torch.autograd import DeviceType

        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("repro_torch/")]
        busy = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                   for e in events) / 1e6
        out.update(device_busy_s=busy if busy > 0 else "not measured",
                   device_kernels=len(events))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--spec", default=None,
                    help="another row than the scale row (a dry run)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("scale_row_split: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.specs import SCALE_SPEC

    smi = "not a card" if args.device != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi)
    rows = []
    for i in range(args.runs + (args.device == "cuda")):
        row = one_row(torch, args.spec or SCALE_SPEC, args.device,
                      profiled=i == args.runs and args.device == "cuda")
        row.update(run=i, src=repro_torch.__file__, nvidia_smi=smi)
        print(json.dumps(row), flush=True)
        rows.append(row)
    plain = rows[1:args.runs] or rows[:1]       # the first run is cold

    def med(get):
        return statistics.median(get(r) for r in plain)
    summary = dict(src=repro_torch.__file__, torch=torch.__version__,
                   spec=args.spec or SCALE_SPEC,
                   nvidia_smi=smi, warm_runs=len(plain),
                   seconds=med(lambda r: r["seconds"]),
                   spans={k: med(lambda r, k=k: r["spans"].get(k, 0.0))
                          for k in SPANS},
                   calls={k: med(lambda r, k=k: r["calls"].get(k, 0.0))
                          for k in sorted(rows[-1]["calls"])},
                   device_busy_s=rows[-1].get("device_busy_s",
                                              "not measured"))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
