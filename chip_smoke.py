#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version at the main path's shapes,
drives the main path (registry spec -> topology -> Lanczos rho_2 / lambda on
the card -> survey rows) at full width, and checks the results against known
values and the host's dense float64 oracle.  Every phase asserts or raises.
Output is one JSON object per line; the line before the last lists each
kernel with its launches, error and times, and the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
sources beside it, it exits non-zero and prints no result.

Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 67e12, "float64": 34e12}

#: reference values of the main path (JAX reference on the CPU, iters 200)
LPS_RHO2 = 1.5883946
LPS_RHO2_TOL = 1e-4
HYPERCUBE_RHO2 = 2.0
HYPERCUBE_RHO2_TOL = 2e-4
ORACLE_TOL = 1e-3

#: kernel-vs-plain tolerances (the reference's tests/test_spmv.py levels)
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 0.15}

SPMV_SOURCE = "src/repro_torch/kernels/csrc/spmv.cu"
SPMV_REPLACES = "src/repro/kernels/spmv.py:172"

#: enough copies of a case's operands that one timed launch finds the
#: previous copies' bytes evicted from the 50 MB L2, as a Lanczos step does
#: (its reorthogonalization streams up to 91 MB between two matvecs)
COLD_BYTES = 120e6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def _graph_ms(torch, fn, arg_sets, reps: int) -> float:
    """Per-call device time of ``fn`` over ``reps`` calls cycling through
    ``arg_sets``, captured into one CUDA graph so host launch overhead does
    not enter; median of 5 replays, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[2]


def _eager_ms(torch, fn, arg_sets, reps: int) -> float:
    """Per-call time of ``reps`` eager calls, CUDA events around the loop
    (includes host launch overhead where the device waits on the host)."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phase 2: K1 against its plain version
# --------------------------------------------------------------------------

def _csr_operator(torch, table, loops, signs, n):
    """The case's operator as one torch sparse CSR matrix (the library
    yardstick): (n, n), or block-diagonal (B n, B n) for per-batch tables."""
    tab = table.long()
    batched = tab.dim() == 3
    B = tab.shape[0] if batched else 1
    k = tab.shape[-1]
    rows = torch.arange(B * n, device=tab.device).repeat_interleave(k)
    cols = (tab.reshape(B, n * k)
            + (torch.arange(B, device=tab.device) * n)[:, None]).reshape(-1)
    dt = torch.float64 if (loops is not None and loops.dtype == torch.float64) \
        else torch.float32
    vals = (signs.reshape(-1).to(dt) if signs is not None
            else torch.ones(rows.numel(), dtype=dt, device=tab.device))
    if loops is not None:
        diag = torch.arange(B * n, device=tab.device)
        lw = loops.reshape(-1).to(dt)
        if lw.numel() == n and B > 1:
            lw = lw.repeat(B)
        rows = torch.cat([rows, diag])
        cols = torch.cat([cols, diag])
        vals = torch.cat([vals, lw])
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  (B * n, B * n)).coalesce()
    return coo.to_sparse_csr()


def _case_bytes_ops(x, table, loops, signs) -> tuple:
    """(bytes, flops) the function must move/do: each input read once, the
    output written once; 1 add per slot, +1 mul per signed slot, 2 per loop."""
    B = x.shape[0] if x.dim() == 2 else 1
    n = x.shape[-1]
    k = table.shape[-1]
    acc = 8 if x.element_size() == 8 else 4
    nbytes = 2 * x.numel() * x.element_size() + table.numel() * 4
    if loops is not None:
        nbytes += loops.numel() * acc
    if signs is not None:
        nbytes += signs.numel() * acc
    flops = B * n * (k * (2 if signs is not None else 1)
                     + (2 if loops is not None else 0))
    return nbytes, flops


def check_kernel_case(torch, KS, case: dict) -> dict:
    """Kernel K1 vs spmv_ref on one case: error, then kernel / plain /
    library / bound times."""
    x, table, loops, signs = case["x"], case["table"], case["loops"], \
        case["signs"]
    dtype = str(x.dtype).replace("torch.", "")
    y_k = KS.spmv_cuda(x, table, loops, signs)
    y_p = KS.spmv_ref(x, table, loops, signs)
    torch.cuda.synchronize()
    err = float((y_k.double() - y_p.double()).abs().max())
    if not math.isfinite(err) or err > TOL[dtype]:
        raise AssertionError(f"K1 {case['name']}: max |kernel - plain| = "
                             f"{err} > {TOL[dtype]}")
    nbytes, flops = _case_bytes_ops(x, table, loops, signs)
    copies = max(2, min(64, math.ceil(COLD_BYTES / nbytes)))
    sets = [(x.clone(), table.clone(),
             None if loops is None else loops.clone(),
             None if signs is None else signs.clone())
            for _ in range(copies)]
    reps = max(64, copies)
    ms = _graph_ms(torch, KS.spmv_cuda, sets, reps)
    plain_ms = _graph_ms(torch, KS.spmv_ref, sets, reps)
    eager_ms = _eager_ms(torch, KS.spmv_cuda, sets, reps)
    library_ms = None
    library_timing = None
    if x.dtype != torch.bfloat16:         # no bf16 sparse CSR matvec
        n = x.shape[-1]
        B = x.shape[0] if x.dim() == 2 else 1
        lib_sets = []
        for s in sets[:max(2, copies // 2)]:
            A = _csr_operator(torch, s[1], s[2], s[3], n)
            if table.dim() == 3:
                lib_sets.append((A, s[0].reshape(B * n)))
            elif x.dim() == 2:
                lib_sets.append((A, s[0].T))
            else:
                lib_sets.append((A, s[0]))
        libfn = torch.matmul
        # the yardstick is timed like the kernel where cuSPARSE lets a CUDA
        # graph capture it, else eagerly; which one is reported
        try:
            library_ms = _graph_ms(torch, libfn, lib_sets, reps)
            library_timing = "graph"
        except RuntimeError:
            torch.cuda.synchronize()
            library_ms = _eager_ms(torch, libfn, lib_sets, reps)
            library_timing = "eager"
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(
        form=case["name"], dtype=dtype, shape=list(x.shape),
        table_shape=list(table.shape), max_abs_err=err, tol=TOL[dtype],
        ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
        library_timing=library_timing,
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        bytes=nbytes, flops=flops, cold_copies=copies)


def kernel_cases(torch, np, REG, dev) -> list:
    """K1's forms at the main path's shapes (lps(61,5), hypercube(16)) plus
    a ragged n and the irregular, negative-loop data_vortex(4,3)."""
    rng = np.random.default_rng(0)
    cases = []

    def add(name, x, table, loops=None, signs=None):
        cases.append(dict(name=name, x=x, table=table, loops=loops,
                          signs=signs))

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    for spec in ("lps(61,5)", "hypercube(16)"):
        topo = REG.build(spec)
        tab_np, w_np = topo.gather_operands()
        n, k = tab_np.shape
        tab = t(tab_np, torch.int32)
        loops = t(w_np, torch.float32)
        x = rng.standard_normal(n)
        add(f"{spec} f32 plain+loops", t(x, torch.float32), tab, loops)
        xb = rng.standard_normal((4, n))
        tabs = t(np.stack([tab_np[rng.permutation(n)] for _ in range(4)]),
                 torch.int32)
        add(f"{spec} f32 batched (4,n,k)+loops", t(xb, torch.float32), tabs,
            t(np.stack([w_np] * 4), torch.float32))
        add(f"{spec} f32 batched (4,n) shared table", t(xb, torch.float32),
            tab, loops)
        sg = rng.choice([-1.0, 1.0], size=(n, k))
        add(f"{spec} f32 signed", t(x, torch.float32), tab, None,
            t(sg, torch.float32))
        add(f"{spec} f64 plain+loops", t(x, torch.float64), tab,
            t(w_np, torch.float64))
        add(f"{spec} bf16 plain+loops", t(x, torch.bfloat16), tab, loops)
    n = 100_003                                  # ragged: not a block multiple
    tab_np = rng.integers(0, n, size=(n, 7))
    add("ragged n=100003 k=7 f32 signed+loops",
        t(rng.standard_normal(n), torch.float32), t(tab_np, torch.int32),
        t(rng.standard_normal(n), torch.float32),
        t(rng.choice([-1.0, 1.0], size=(n, 7)), torch.float32))
    dv = REG.build("data_vortex(4,3)")
    tab_np, w_np = dv.gather_operands()
    # irregular: the degree-3 rows are self-padded, and the padding's -1
    # compensation cancels their +1 regularizing loop in the weights
    assert (tab_np == np.arange(dv.n)[:, None]).any(), "expected self-padding"
    add("data_vortex(4,3) f32 plain+loops",
        t(rng.standard_normal(dv.n), torch.float32), t(tab_np, torch.int32),
        t(w_np, torch.float32))
    return cases


# --------------------------------------------------------------------------
# phase 7: where a Lanczos solve's device time goes
# --------------------------------------------------------------------------

def lanczos_split(torch, S, topo, dev, iters: int) -> dict:
    """Device time of one rho2_lanczos solve by kernel class, from
    torch.profiler's CUDA kernel events (``not measured`` if it shows none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    S.rho2_lanczos(topo, iters=iters, seed=0, device=dev)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rho2 = S.rho2_lanczos(topo, iters=iters, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes = {"spmv_kernel_ms": 0.0, "reorth_gemv_ms": 0.0, "other_ms": 0.0}
    kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        kernels += 1
        name = e.name.lower()
        if "spmv_kernel" in name:
            classes["spmv_kernel_ms"] += us / 1e3
        elif any(s in name for s in ("gemv", "gemm", "xmma", "cutlass")):
            classes["reorth_gemv_ms"] += us / 1e3
        else:
            classes["other_ms"] += us / 1e3
    busy = sum(classes.values())
    out = dict(spec=topo.name, iters=iters, rho2=rho2,
               solve_wall_ms=wall * 1e3, device_kernels=kernels)
    if busy > 0:
        out.update({k: v for k, v in classes.items()},
                   device_busy_ms=busy,
                   device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)))
    else:
        out.update({k: "not measured" for k in classes},
                   device_busy_ms="not measured",
                   device_idle_share="not measured")
    # CUDA-event time of the same solve, for a second opinion on the wall
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    S.rho2_lanczos(topo, iters=iters, seed=0, device=dev)
    end.record()
    torch.cuda.synchronize()
    out["solve_event_ms"] = start.elapsed_time(end)
    return out


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    return run(torch, torch.device("cuda"))


def run(torch, dev) -> int:
    """Every phase on ``dev`` (the card; see :func:`main`)."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.api import (DEFAULT_COLUMNS, RAMANUJAN_COLUMNS,
                                 TABLE1_COLUMNS, survey)
    from repro_torch.api.registry import REGISTRY
    from repro_torch.core import spectral as S
    from repro_torch.interop import topology_from_arrays
    from repro_torch.kernels import build
    from repro_torch.kernels import spmv as KS
    from repro_torch.specs import (LPS_DENSE_THRESHOLD, LPS_SPECS,
                                   TABLE1_SPECS)

    t_start = time.time()

    # -- phase 1: the card and the build ---------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    build.build_all(["spmv"])
    build_s = time.time() - t0
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, build_seconds=build_s,
              allow_tf32=torch.backends.cuda.matmul.allow_tf32))

    # -- phase 2: K1 against its plain version ---------------------------
    t0 = time.time()
    results = [check_kernel_case(torch, KS, c)
               for c in kernel_cases(torch, np, REGISTRY, dev)]
    for r in results:
        emit(dict(phase="kernel_check", kernel="spmv_padded", **r))
    emit(dict(phase="kernel_check_done", cases=len(results),
              seconds=time.time() - t0))

    # -- phase 3: the main path at full width, through survey ------------
    iters = 200
    cols = DEFAULT_COLUMNS + ["lambda", "is_ramanujan", "diameter",
                              "seconds"]
    obs.reset_counters()
    KS.reset_launches()
    t0 = time.time()
    res = survey(["lps(61,5)", "hypercube(16)"], columns=cols,
                 lanczos_iters=iters, device=dev)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = KS.launches()
    counts = obs.counters()
    rows = {r["spec"]: r for r in res.rows}
    lps, hc = rows["lps(61,5)"], rows["hypercube(16)"]
    for r in res.rows:
        assert r["backend"] == "lanczos", r
        for c in cols:
            v = r[c]
            assert v is not None or c in ("rho2_ub_paper", "bw_ub_paper",
                                          "rho2_ok"), (c, r)
            if isinstance(v, float):
                assert math.isfinite(v), (c, r)
    assert abs(lps["rho2"] - LPS_RHO2) <= LPS_RHO2_TOL, lps
    assert lps["is_ramanujan"] is True, lps
    assert lps["lambda"] <= 2 * math.sqrt(5) + 1e-6, lps
    assert lps["nodes"] == 113460 and lps["radix"] == 6, lps
    assert abs(hc["rho2"] - HYPERCUBE_RHO2) <= HYPERCUBE_RHO2_TOL, hc
    assert hc["diameter"] == 16 and hc["nodes"] == 65536, hc
    lanczos_iters = counts.get("lanczos/iters", 0)
    assert counts.get("lanczos/solves", 0) == 6, counts
    assert launches >= lanczos_iters > 0, (launches, counts)
    assert counts.get("spmv/dispatch/cuda", 0) > 0, counts
    assert counts.get("spmv/dispatch/ref", 0) == 0, counts
    main_launches = launches
    emit(dict(phase="main_path", rows=res.rows, seconds=main_s,
              spmv_launches=launches,
              counters={k: v for k, v in counts.items()
                        if k.startswith(("spmv/", "lanczos/", "survey/"))}))

    # -- phase 4: same-shape batch (B, n, k) over relabellings -----------
    topo = REGISTRY.build("lps(61,5)")
    rng = np.random.default_rng(61)
    batch = [topo]
    for i in range(3):
        perm = rng.permutation(topo.n)
        loops = None
        if topo.loops is not None:
            loops = np.empty(topo.n)
            loops[perm] = topo.loops
        batch.append(topology_from_arrays(
            f"lps(61,5)/relabel{i}", topo.n, perm[topo.edges], loops,
            {"bipartite": False}))
    obs.reset_counters()
    KS.reset_launches()
    t0 = time.time()
    vals = S.rho2_lanczos_batched(batch, iters=iters, seed=0, device=dev)
    batch_s = time.time() - t0
    batch_launches = KS.launches()
    assert max(vals) - min(vals) <= LPS_RHO2_TOL, vals
    assert all(abs(v - LPS_RHO2) <= LPS_RHO2_TOL for v in vals), vals
    assert batch_launches >= iters, batch_launches
    emit(dict(phase="batched_relabel", rho2=vals, spread=max(vals) - min(vals),
              seconds=batch_s, spmv_launches=batch_launches))

    # -- phase 5: the normal entry points against the dense oracle -------
    obs.reset_counters()
    KS.reset_launches()
    t0 = time.time()
    res_lps = survey(LPS_SPECS, RAMANUJAN_COLUMNS,
                     dense_threshold=LPS_DENSE_THRESHOLD, lanczos_iters=150,
                     device=dev)
    res_t1 = survey(TABLE1_SPECS, TABLE1_COLUMNS, dense_threshold=0,
                    device=dev)
    torch.cuda.synchronize()
    surveys_s = time.time() - t0
    oracle_launches = KS.launches()
    gaps = []
    t0 = time.time()
    for r in res_lps.rows:
        assert r["is_ramanujan"] is True, r
        if r["backend"] == "lanczos":
            want = S.lambda_nontrivial(REGISTRY.build(r["spec"]))
            gaps.append(dict(spec=r["spec"], quantity="lambda",
                             lanczos=r["lambda"], dense=want,
                             gap=abs(r["lambda"] - want)))
    for spec, r in zip(TABLE1_SPECS, res_t1.rows):
        want = float(S.laplacian_spectrum(REGISTRY.build(spec))[1])
        gaps.append(dict(spec=r["instance"], quantity="rho2",
                         lanczos=r["rho2"], dense=want,
                         gap=abs(r["rho2"] - want)))
    oracle_s = time.time() - t0
    worst = max(gaps, key=lambda g: g["gap"])
    assert any(g["quantity"] == "lambda" for g in gaps), gaps
    assert worst["gap"] <= ORACLE_TOL, worst
    emit(dict(phase="oracle", lps_rows=res_lps.rows, table1_rows=res_t1.rows,
              compared=len(gaps), worst=worst, tol=ORACLE_TOL,
              rho2_ok_rows=sum(bool(r["rho2_ok"]) for r in res_t1.rows),
              survey_seconds=surveys_s, oracle_seconds=oracle_s,
              spmv_launches=oracle_launches))

    # -- phase 7: per-row seconds and the Lanczos time split -------------
    emit(dict(phase="row_seconds",
              rows={r["spec"]: r["seconds"] for r in res.rows}))
    emit(dict(phase="lanczos_split",
              **lanczos_split(torch, S, topo, dev, iters)))
    emit(dict(phase="total", seconds=time.time() - t_start))

    # -- the kernels line, then the last line ----------------------------
    main = results[0]
    assert main["form"] == "lps(61,5) f32 plain+loops", main
    emit({"kernels": [dict(
        name="spmv_padded", route="cuda", source=SPMV_SOURCE,
        replaces=SPMV_REPLACES, launches=main_launches,
        max_abs_err=max(r["max_abs_err"] for r in results
                        if r["dtype"] == "float32"),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        forms=[r["form"] for r in results])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
