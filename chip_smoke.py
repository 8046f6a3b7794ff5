#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It builds the port's four CUDA kernels from the sources in this checkout
(one ``nvcc`` each, all at once), holds each kernel against its plain
PyTorch version at its main path's shapes, and drives both main paths:

* slice 1, the paper's measurement: registry spec -> topology -> Lanczos
  rho_2 / lambda on the card (kernel K1) -> survey rows, at full width,
  checked against known values and the host's dense float64 oracle;
* slice 2, LM serving: jamba-v0.1-52b at its published widths, 16 of its 32
  layers, bf16, random weights from seed 0, serving 4 requests of 1024-token
  prompts and 32 greedy new tokens through ``repro_torch.serve.generate``
  (kernels K5 RMSNorm, K3 flash attention, K4 Mamba scan), checked against
  the same prefill run through the plain versions and against the CPU on
  the reduced config.

Every phase asserts or raises.  Output is one JSON object per line; the line
before the last lists each kernel with its launches, error and times, and
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the port's sources beside it, it exits non-zero and prints no
result.

Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import contextlib
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
#: the same for work on the tensor cores (K3's bf16 products); K3's f32 path
#: runs on the f32 FMA pipes
TENSOR_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

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

#: the LM kernels: source in the port, the TPU kernel it replaces
LM_KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:25"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:71"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/kernel.py:54"),
}
#: LM kernel-vs-plain tolerances, numpy allclose style (atol = rtol): the
#: per-dtype TOL of tests/test_kernels.py:17, 3e-5 for f32 attention (its
#: property test), and for K4's f32 final state the reference's 2e-4 scan
#: tolerance (tests/test_kernels.py, mamba sweep)
LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
H_FINAL_TOL = 2e-4

#: the serving phase: jamba-v0.1-52b at full width, 16 of 32 layers
SERVE_ARCH = "jamba-v0.1-52b"
SERVE_LAYERS = 16
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32
#: bound on each layer's mixer (attention / Mamba) output, run through the
#: kernels and through the plain versions on the same input (teacher-forced,
#: bf16): both round the output once to bf16 (2^-9 relative) and may round
#: inside at other places (the kernels keep dt * x and the softmax tiles in
#: f32); two roundings are 2 * 2^-8 = 7.8e-3, rounded up to 1e-2.
SERVE_MIXER_REL_TOL = 1e-2
#: end to end: the last-position logits of the prefill through the kernels
#: against the same prefill through the plain versions, which replays the
#: kernel run's MoE expert choices (with gates from its own router
#: probabilities), so that a near-tied top-2 routing flipped by bf16
#: rounding cannot cascade through the layers; relative L2.  This
#: random-weight model amplifies any gap on its way to the logits: one bf16
#: ulp (2^-8) on every input embedding alone reads ~0.07 there on an H100,
#: and the smoke reads that floor again in every run.  The kernels' gaps are
#: bf16 roundings, layer by layer within SERVE_MIXER_REL_TOL and independent
#: between layers, so the bound is that per-layer bound times
#: sqrt(layers): 0.04, about half the one-ulp floor and ~35x under the
#: ~1.41 of two unrelated logit vectors.
SERVE_LOGITS_REL_TOL = SERVE_MIXER_REL_TOL * math.sqrt(SERVE_LAYERS)
#: K3's bf16 forms, beside the allclose: each output row's relative L2 gap
#: to the plain version, at most 4 bf16 ulps (2^-8 each) of relative error
ATTN_ROW_REL_TOL = 4 * 2.0 ** -8

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
# phase 2b: K5, K3, K4 against their plain versions
# --------------------------------------------------------------------------

def _allclose_err(torch, got, want, tol) -> tuple:
    """(max |got - want|, max of |got - want| - tol * (1 + |want|)): the
    second is <= 0 when numpy's allclose(atol=tol, rtol=tol) holds."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    return float(diff.max()), float((diff - tol * (1 + w.abs())).max())


def _lm_case(torch, name, form, kernel, plain, args, tol, nbytes, flops,
             peak, library=None, lib_args=None, reps=64, plain_reps=None,
             extra_check=None) -> dict:
    """One LM kernel case: error against the plain version, then kernel /
    plain / library times (CUDA graph, cold operands) and the bound."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    out_k = got[0] if isinstance(got, tuple) else got
    out_p = want[0] if isinstance(want, tuple) else want
    assert out_k.shape == out_p.shape and out_k.dtype == out_p.dtype, form
    err, excess = _allclose_err(torch, out_k, out_p, tol)
    if not (math.isfinite(err) and excess <= 0):
        raise AssertionError(f"{name} {form}: |kernel - plain| exceeds "
                             f"{tol} (max abs {err}, excess {excess})")
    row = dict(kernel=name, form=form, dtype=str(out_k.dtype).replace(
        "torch.", ""), shape=list(out_k.shape), max_abs_err=err, tol=tol)
    if extra_check is not None:
        row.update(extra_check(got, want))
    copies = max(2, min(64, math.ceil(COLD_BYTES / nbytes)))
    sets = [tuple(a.clone() if hasattr(a, "clone") else a for a in args)
            for _ in range(copies)]
    row["ms"] = _graph_ms(torch, kernel, sets, max(reps, copies))
    pr = plain_reps or max(reps, copies)
    row["plain_ms"] = _graph_ms(torch, plain, sets[:max(2, min(copies, pr))],
                                pr)
    row["library_ms"] = None
    if library is not None:
        lib_sets = [lib_args(a) for a in sets]
        row["library_ms"] = _graph_ms(torch, library, lib_sets,
                                      max(reps, copies))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=nbytes, flops=flops, cold_copies=copies)
    del sets
    return row


def lm_kernel_checks(torch, dev) -> list:
    """K5, K3 and K4 at the serving path's shapes (bf16 and f32) plus ragged
    cases; the first row of each kernel is its serving-path case."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import mamba_scan as K4
    from repro_torch.kernels import rmsnorm as K5

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    rows = []
    bf, f32 = torch.bfloat16, torch.float32

    # K5: prefill rows (B*S, D), decode rows, f32, ragged rows and widths
    for form, (R, D), dt in (("prefill (4096, 4096) bf16", (4096, 4096), bf),
                             ("decode (4, 4096) bf16", (4, 4096), bf),
                             ("prefill (4096, 4096) f32", (4096, 4096), f32),
                             ("ragged rows (1001, 1024) bf16", (1001, 1024), bf),
                             ("ragged width (37, 4095) f32", (37, 4095), f32)):
        x, w = randn(R, D, dtype=dt), (randn(D) + 1).to(dt)
        es = x.element_size()
        rows.append(_lm_case(
            torch, "rmsnorm", form, K5.rmsnorm_cuda, K5.rmsnorm_ref, (x, w),
            LM_TOL[str(dt)[6:]], 2 * R * D * es + D * es, 4 * R * D,
            PEAK_FLOPS[str(dt)[6:]],
            library=lambda a, b: F.rms_norm(a, (a.shape[-1],), b, 1e-6),
            lib_args=lambda a: a))

    # K3: the serving prefill (B 4, S 1024, H 32, Kv 8, hd 128)
    def attn_pairs(S, causal):
        return S * (S + 1) // 2 if causal else S * S

    def row_check(got, want):
        """bf16 only: each (b, s, h) row's relative L2 gap, so that a fault
        in late rows (|o| ~ 0.05, where the allclose allows ~40 %) shows."""
        if got.dtype != torch.bfloat16:
            return {}
        g, w = got.double(), want.double()
        rel = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        worst = float(rel.max())
        if not (math.isfinite(worst) and worst <= ATTN_ROW_REL_TOL):
            raise AssertionError(f"flash_attention: a row's relative L2 gap "
                                 f"{worst} > {ATTN_ROW_REL_TOL}")
        return dict(row_rel_l2_max=worst, row_rel_l2_median=float(
            rel.median()), row_rel_l2_tol=ATTN_ROW_REL_TOL)

    for form, (B, S, H, Kv, hd), causal, dt in (
            ("prefill causal bf16", (4, 1024, 32, 8, 128), True, bf),
            ("prefill non-causal bf16", (4, 1024, 32, 8, 128), False, bf),
            ("prefill causal f32", (4, 1024, 32, 8, 128), True, f32),
            ("ragged S=1000 causal bf16", (4, 1000, 32, 8, 128), True, bf),
            ("ragged S=1000 non-causal f32", (2, 1000, 32, 8, 128), False,
             f32)):
        q, k, v = randn(B, S, H, hd, dtype=dt), randn(B, S, Kv, hd, dtype=dt), \
            randn(B, S, Kv, hd, dtype=dt)
        es = q.element_size()
        G = H // Kv

        def sdpa_args(a, G=G):
            qq, kk, vv = a
            return (qq.transpose(1, 2).contiguous(),
                    kk.transpose(1, 2).repeat_interleave(G, 1).contiguous(),
                    vv.transpose(1, 2).repeat_interleave(G, 1).contiguous())

        rows.append(_lm_case(
            torch, "flash_attention", form,
            lambda a, b, c, causal=causal: K3.flash_attention_cuda(
                a, b, c, causal=causal),
            lambda a, b, c, causal=causal: K3.attention_ref(a, b, c,
                                                            causal=causal),
            (q, k, v), ATTN_TOL[str(dt)[6:]],
            (2 * q.numel() + 2 * k.numel()) * es,
            4 * B * H * hd * attn_pairs(S, causal), TENSOR_FLOPS[str(dt)[6:]],
            library=lambda a, b, c, causal=causal:
                F.scaled_dot_product_attention(a, b, c, is_causal=causal),
            lib_args=sdpa_args, reps=16, plain_reps=8,
            extra_check=row_check))

    # K4: the serving prefill (B 4, L 1024, Di 8192, N 16), the model's A
    def h_check(got, want):
        err, excess = _allclose_err(torch, got[1], want[1], H_FINAL_TOL)
        if not (math.isfinite(err) and excess <= 0):
            raise AssertionError(f"mamba_scan h_final: |kernel - plain| "
                                 f"exceeds {H_FINAL_TOL} (max abs {err})")
        return dict(h_final_max_abs_err=err, h_final_tol=H_FINAL_TOL)

    for form, (B, L, Di, N), dt in (
            ("prefill bf16", (4, 1024, 8192, 16), bf),
            ("prefill f32", (4, 1024, 8192, 16), f32),
            ("ragged L=1000 Di=8100 bf16", (4, 1000, 8100, 16), bf)):
        x = randn(B, L, Di, dtype=dt)
        delta = F.softplus(randn(B, L, Di) * 0.5 - 1.0).to(dt)
        A = -torch.arange(1, N + 1, device=dev, dtype=f32).expand(Di, N) \
            .contiguous()
        B_t, C_t = randn(B, L, N, dtype=dt), randn(B, L, N, dtype=dt)
        Dw = torch.ones(Di, device=dev)
        es = x.element_size()
        nbytes = (3 * B * L * Di + 2 * B * L * N) * es + (Di * N + Di) * 4 \
            + B * Di * N * 4
        rows.append(_lm_case(
            torch, "mamba_scan", form, K4.mamba_scan_cuda, K4.mamba_scan_ref,
            (x, delta, A, B_t, C_t, Dw), LM_TOL[str(dt)[6:]], nbytes,
            6 * B * L * Di * N + 3 * B * L * Di, PEAK_FLOPS["float32"],
            reps=8, plain_reps=2, extra_check=h_check))
    return rows


# --------------------------------------------------------------------------
# phase 8: LM serving at full width
# --------------------------------------------------------------------------

def _lm_counters():
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import mamba_scan as K4
    from repro_torch.kernels import rmsnorm as K5
    return {"rmsnorm": K5, "flash_attention": K3, "mamba_scan": K4}


@contextlib.contextmanager
def _plain_kernels():
    """Inside the block the model's kernel call sites run the plain versions
    on the card: each kernel wrapper is swapped for its plain version, for
    the comparison runs of this script only.  The kernels' launch counters
    do not move inside it."""
    K = _lm_counters()
    swaps = ((K["rmsnorm"], "rmsnorm_cuda", K["rmsnorm"].rmsnorm_ref),
             (K["flash_attention"], "flash_attention_cuda",
              K["flash_attention"].attention_ref),
             (K["mamba_scan"], "mamba_scan_cuda",
              K["mamba_scan"].mamba_scan_ref))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def _moe_routes(replay=None):
    """Record each MoE routing call's own expert choice, (G, S*k), into the
    list the block yields.  With ``replay`` (such a list from an earlier
    run), call i instead takes ``replay[i]``'s experts, in their order, with
    gates from its own router probabilities as ``_route_group`` forms them;
    the list still records the experts it would have chosen itself."""
    import torch

    from repro_torch.models import moe as MOE

    orig = MOE._route_group
    own = []

    def route(logits, k, C, E):
        out = orig(logits, k, C, E)
        own.append(out[2].clone())
        if replay is None:
            return out
        G, S, _ = logits.shape
        idx = replay[len(own) - 1].reshape(G, S, k)
        # logits whose top-k is exactly idx, in its order
        rank = torch.arange(k, 0, -1, dtype=torch.float32,
                            device=logits.device).expand(G, S, k)
        forced = torch.zeros(G, S, E, device=logits.device).scatter_(
            -1, idx, rank)
        dispatch, _, flat, valid = orig(forced, k, C, E)
        assert torch.equal(flat, idx.reshape(G, S * k))
        gate = torch.gather(torch.softmax(logits.float(), dim=-1), -1, idx)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return dispatch, gate, flat, valid

    MOE._route_group = route
    try:
        yield own
    finally:
        MOE._route_group = orig


def _assignments_differ(torch, a_routes, b_routes, k) -> int:
    """How many of the (token, slot) expert assignments differ, each token's
    top-k taken as a set."""
    a, b = (torch.cat([r.reshape(-1, k) for r in rr]).sort(dim=-1).values
            for rr in (a_routes, b_routes))
    return int((a != b).sum())


def serving_phase(torch, dev) -> dict:
    """Serve jamba at full width through ``generate`` (the kernels) and count
    the launches; then run the same prefill through the plain versions, once
    free and once replaying the kernel run's MoE routing, and compare."""
    from repro_torch.models import model as M
    from repro_torch.serve import generate, serving_config

    from repro_torch.configs import get_config

    cfg = serving_config(SERVE_ARCH, layers=SERVE_LAYERS)
    full_layers = get_config(SERVE_ARCH).n_layers
    n_attn = sum(s.kind == "attn" for s in cfg.pattern) * cfg.n_repeats
    n_mamba = cfg.n_layers - n_attn
    n_moe = sum(s.moe for s in cfg.pattern) * cfg.n_repeats
    k = cfg.experts_per_token
    max_len = SERVE_PROMPT + SERVE_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT),
                            generator=gen, device=dev)
    # warm-up (cuBLAS handles, allocator), not counted
    generate(params, cfg, prompts[:, :64], 2)

    counters = _lm_counters()
    for mod in counters.values():
        mod.reset_launches()
    with _moe_routes() as kernel_routes:
        res = generate(params, cfg, prompts, SERVE_NEW)
    launches = {n: mod.launches() for n, mod in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_routes = kernel_routes[:n_moe]           # the prefill's
    with _plain_kernels(), _moe_routes() as free_routes:
        free_logits, _ = M.prefill(params, {"tokens": prompts}, cfg, max_len)
    with _plain_kernels(), _moe_routes(replay=kernel_routes) as own_routes:
        plain_logits, _ = M.prefill(params, {"tokens": prompts}, cfg, max_len)
    # the model's own bf16 sensitivity, for comparison: the same replayed
    # plain prefill with each input embedding moved by one bf16 ulp
    x = M._embed_in(params, {"tokens": prompts}, cfg)
    g2 = torch.Generator(device=dev)
    g2.manual_seed(2)
    sign = torch.randint(0, 2, x.shape, generator=g2, device=dev) * 2 - 1
    x_ulp = (x.float() * (1 + sign * 2.0 ** -8)).to(x.dtype)
    with _plain_kernels(), _moe_routes(replay=kernel_routes):
        ulp_logits, _ = M.prefill(params, {"embeds": x_ulp}, cfg, max_len)
    del x, sign, x_ulp
    torch.cuda.synchronize()
    plain_launches = {n: mod.launches() for n, mod in counters.items()}

    steps = res.decode_steps
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * (1 + steps),
            "flash_attention": n_attn, "mamba_scan": n_mamba}
    assert launches == want, (launches, want)
    assert plain_launches == launches, (plain_launches, launches)
    logits = res.prefill_logits
    assert logits.shape == (SERVE_REQUESTS, cfg.vocab_size), logits.shape
    for lg in (logits, free_logits, plain_logits, ulp_logits):
        assert torch.isfinite(lg).all()
    toks = res.tokens
    assert toks.shape == (SERVE_REQUESTS, SERVE_NEW), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert len(kernel_routes) == n_moe
    assert len(free_routes) == len(own_routes) == n_moe
    return dict(
        arch=SERVE_ARCH, config=cfg.name, n_layers=cfg.n_layers,
        reduced=[f"layers {cfg.n_layers} of {full_layers} ({cfg.n_repeats} "
                 f"of {full_layers // len(cfg.pattern)} pattern repeats): "
                 "the whole model does not fit one 80 GB card in bf16"],
        params=n_params, dtype=cfg.compute_dtype, seed=0,
        init_seconds=init_s,
        requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
        prefill_ms=res.prefill_s * 1e3,
        prefill_tokens_per_s=SERVE_REQUESTS * SERVE_PROMPT / res.prefill_s,
        decode_ms_per_step=res.decode_s / steps * 1e3,
        decode_tokens_per_s=SERVE_REQUESTS * steps / res.decode_s,
        peak_memory_gb=peak_gb,
        launches=launches, launches_expected=want,
        launches_after_plain_runs=plain_launches,
        logits_rel_l2_vs_plain=_rel_l2(logits, plain_logits),
        logits_rel_tol=SERVE_LOGITS_REL_TOL,
        one_ulp_input_logits_rel_l2=_rel_l2(ulp_logits, plain_logits),
        first_token_agree=int((logits.argmax(-1)
                               == plain_logits.argmax(-1)).sum()),
        moe_assignments=n_moe * SERVE_REQUESTS * SERVE_PROMPT * k,
        moe_assignments_plain_would_flip=_assignments_differ(
            torch, kernel_routes, own_routes, k),
        free_plain_logits_rel_l2=_rel_l2(logits, free_logits),
        free_plain_moe_assignments_differ=_assignments_differ(
            torch, kernel_routes, free_routes, k),
        tokens_head=toks[:, :8].tolist()), params, prompts


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def layer_check(torch, dev, params, prompts) -> dict:
    """Teacher-forced, layer by layer: the hidden state of the run through
    the kernels enters each layer, whose mixer (attention / Mamba, after
    K5's norm1) and whole block run through the kernels and through the
    plain versions; each mixer must agree to SERVE_MIXER_REL_TOL."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.mamba import mamba_forward
    from repro_torch.serve import serving_config

    cfg = serving_config(SERVE_ARCH, layers=SERVE_LAYERS)
    k = cfg.experts_per_token
    h = M._embed_in(params, {"tokens": prompts}, cfg)
    rope = M.make_rope(cfg, h.shape[0], h.shape[1], device=dev)
    rows = []
    for r in range(cfg.n_repeats):
        for spec, p_all in zip(cfg.pattern, params["blocks"]):
            p = T._repeat(p_all, r)

            def mixer():
                hn = rms_norm(h, p["norm1"], cfg.norm_eps)
                if spec.kind == "attn":
                    return T._attn_sublayer(p["attn"], hn, cfg, spec, rope)
                return mamba_forward(p["mamba"], hn, cfg)

            mk = mixer()
            with _plain_kernels():
                mp = mixer()
            with _moe_routes() as routes:
                out_k = T._one_block(spec, p, h, cfg, rope)[0]
                with _plain_kernels():
                    out_p = T._one_block(spec, p, h, cfg, rope)[0]
            row = dict(layer=len(rows), kind=spec.kind,
                       ffn="moe" if spec.moe else "mlp",
                       mixer_rel_l2=_rel_l2(mk, mp),
                       block_update_rel_l2=_rel_l2(out_k - h, out_p - h),
                       hidden_rms=float(h.float().pow(2).mean().sqrt()))
            if spec.moe:
                a, b = (rr.reshape(-1, k).sort(-1).values for rr in routes)
                row["tokens_routed_differently"] = int((a != b).any(-1).sum())
            rows.append(row)
            h = out_k
    worst = max(r["mixer_rel_l2"] for r in rows)
    assert worst <= SERVE_MIXER_REL_TOL, (worst, rows)
    return dict(layers=rows, worst_mixer_rel_l2=worst,
                mixer_rel_tol=SERVE_MIXER_REL_TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_split(torch, dev, params, prompts) -> dict:
    """Device time of one prefill and of 4 decode steps by kernel class, from
    torch.profiler's CUDA kernel events, and the device idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M
    from repro_torch.serve import serving_config

    cfg = serving_config(SERVE_ARCH, layers=SERVE_LAYERS)
    max_len = SERVE_PROMPT + SERVE_NEW

    def classify(name):
        n = name.lower()
        if "rmsnorm_kernel" in n:
            return "rmsnorm_ms"
        if "fa_kernel" in n:
            return "flash_attention_ms"
        if "scan_kernel" in n:
            return "mamba_scan_ms"
        if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
            return "matmul_ms"
        return "other_ms"

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        classes = dict.fromkeys(("rmsnorm_ms", "flash_attention_ms",
                                 "mamba_scan_ms", "matmul_ms", "other_ms"),
                                0.0)
        kernels = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            kernels += 1
            classes[classify(e.name)] += us / 1e3
        busy = sum(classes.values())
        row = dict(wall_ms=wall * 1e3, device_kernels=kernels)
        if busy > 0:
            row.update(classes, device_busy_ms=busy,
                       device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)))
        else:
            row.update({c: "not measured" for c in classes},
                       device_busy_ms="not measured",
                       device_idle_share="not measured")
        return out, row

    (logits, caches), prefill_row = profiled(
        lambda: M.prefill(params, {"tokens": prompts}, cfg, max_len))
    tok = logits.argmax(-1)

    def four_steps():
        c, t = caches, tok
        for i in range(4):
            lg, c = M.decode_step(params, t, c, SERVE_PROMPT + i, cfg)
            t = lg.argmax(-1)
        return t

    _, decode_row = profiled(four_steps)
    return dict(prefill=prefill_row, decode_4_steps=decode_row)


def reduced_cpu_check(torch, dev) -> dict:
    """The reduced jamba (f32) served on the card through the kernels and on
    the CPU through the plain versions, on the same weights and prompts."""
    from repro_torch.models import model as M
    from repro_torch.serve import generate, serving_config

    import numpy as np

    cfg = serving_config(SERVE_ARCH, use_reduced=True)
    params = M.init_params(cfg, seed=0, device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    on_cpu = generate(params, cfg, prompts, 4)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev)

    on_dev = generate(to_dev(params), cfg, prompts.to(dev), 4)
    err, excess = _allclose_err(torch, on_dev.prefill_logits.cpu(),
                                on_cpu.prefill_logits, 1e-3)
    assert excess <= 0, (err, "reduced jamba: card vs CPU logits")
    return dict(config=cfg.name, max_abs_err=err, tol=1e-3,
                tokens_equal=bool(torch.equal(on_dev.tokens.cpu(),
                                              on_cpu.tokens)))


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
    build.build_all()                 # every kernel source, nvcc in parallel
    build_s = time.time() - t0
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, build_seconds=build_s,
              kernels_built=list(build.KERNELS),
              allow_tf32=torch.backends.cuda.matmul.allow_tf32))

    # -- phase 2: K1 against its plain version ---------------------------
    t0 = time.time()
    results = [check_kernel_case(torch, KS, c)
               for c in kernel_cases(torch, np, REGISTRY, dev)]
    for r in results:
        emit(dict(phase="kernel_check", kernel="spmv_padded", **r))
    emit(dict(phase="kernel_check_done", cases=len(results),
              seconds=time.time() - t0))

    # -- phase 2b: K5, K3, K4 against their plain versions ---------------
    t0 = time.time()
    lm_rows = lm_kernel_checks(torch, dev)
    for r in lm_rows:
        emit(dict(phase="lm_kernel_check", **r))
    emit(dict(phase="lm_kernel_check_done", cases=len(lm_rows),
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

    # -- phase 8: LM serving at full width (K5, K3, K4) ------------------
    t0 = time.time()
    serve_row, params, prompts = serving_phase(torch, dev)
    serve_row["seconds"] = time.time() - t0
    emit(dict(phase="serving", **serve_row))
    lm_launches = serve_row["launches"]
    assert serve_row["logits_rel_l2_vs_plain"] <= SERVE_LOGITS_REL_TOL, \
        serve_row["logits_rel_l2_vs_plain"]

    # -- phase 8b: each layer, kernels against plain versions -----------
    emit(dict(phase="serving_layers",
              **layer_check(torch, dev, params, prompts)))

    # -- phase 9: where a prefill's and a decode step's time goes --------
    emit(dict(phase="serve_split", **serve_split(torch, dev, params, prompts)))
    del params, prompts
    torch.cuda.empty_cache()

    # -- phase 10: the reduced model, card against CPU -------------------
    emit(dict(phase="reduced_card_vs_cpu", **reduced_cpu_check(torch, dev)))
    emit(dict(phase="total", seconds=time.time() - t_start))

    # -- the kernels line, then the last line ----------------------------
    main = results[0]
    assert main["form"] == "lps(61,5) f32 plain+loops", main
    kernels = [dict(
        name="spmv_padded", route="cuda", source=SPMV_SOURCE,
        replaces=SPMV_REPLACES, launches=main_launches,
        max_abs_err=max(r["max_abs_err"] for r in results
                        if r["dtype"] == "float32"),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        forms=[r["form"] for r in results])]
    for name, (source, replaces) in LM_KERNELS.items():
        mine = [r for r in lm_rows if r["kernel"] == name]
        first = mine[0]               # the serving path's case
        assert lm_launches[name] > 0, (name, lm_launches)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=lm_launches[name], max_abs_err=first["max_abs_err"],
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"], form=first["form"],
            forms=[r["form"] for r in mine]))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
