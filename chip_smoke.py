#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It builds the port's five CUDA kernels and its measurement probes
(``csrc/probe.cu``: the L2 read bandwidth, the launch floor, the gather
rate of a cluster's distributed shared memory) from the
sources in this checkout (one ``nvcc`` each, all at once), holds each
kernel against its plain PyTorch version at its main path's shapes, and
drives every main path:

* slice 1, the paper's measurement: registry spec -> topology -> Lanczos
  rho_2 / lambda on the card (kernel K1) -> survey rows, at full width,
  checked against known values and the host's dense float64 oracle;
* slice 2, LM serving: jamba-v0.1-52b at its published widths, 16 of its 32
  layers, bf16, random weights from seed 0, serving 4 requests of 1024-token
  prompts and 32 greedy new tokens through ``repro_torch.serve.generate``
  (kernels K5 RMSNorm, K3 flash attention, K4 Mamba scan), checked against
  the same prefill run through the plain versions and against the CPU on
  the reduced config;
* slice 3: the Cayley matvec K2 as the ``rho2_lanczos(matvec=)`` operator
  on lps(61,5); the datacenter-scale survey row -- ``xpander(65536,32,0,0)``
  synthesized on the card (signed K1 batches), its rho_2, 64-source sampled
  routing and uniform ECMP traffic (K1 in float64) -- held to the scale
  bench's conditions and the reference's values; torus(32,2)'s exact
  antipodal path count; and the sample_fraction=1.0 exactness sweep;
* slice 4, dense attention at full depth: qwen2-7b at its published widths
  and all 28 layers (K3 in every one), bf16, random weights from seed 0,
  4 requests of 1024-token prompts and 8 greedy new tokens, checked
  against the same prefill through the plain versions;
* slice 6: K4's forms beyond the model's (a general A, one request, N 5
  at an odd Di, one step), each with the time its exponentials take at
  the special-function units beside the bound; and the gradients of one
  reduced-jamba prefill through K5, K3 and K4 against the plain path's;
* slice 7: K2 on a form whose x (4 MB) no thread-block cluster's shared
  memory could hold, and the rate of 4-byte loads from a cluster's
  distributed shared memory (random words, whole lines) at cluster sizes 1
  to 16, the measurement behind K2 keeping x in L2;
* slice 8, the evaluation path: the scale row's Valiant, UGAL and KSP
  loads (KSP's float64 walk DP through K1's signed batch form, timed
  against its plain version) held to the reference's CPU figures; then,
  after the LM phases, the reference's routing-scheme, collective-simulator
  and fault-sweep benchmarks on their own families (every routing scheme
  and the MCF ceiling; ring, tree, binomial and halving-doubling schedules
  and uniform traffic, in simulated seconds of the modeled interconnect;
  link-fault survival curves and the two attacks, one batched Laplacian
  Lanczos solve a rate, and one sweep that executes a ring all-reduce on
  every degraded sample), held to the committed baselines under
  ``benchmarks/baselines`` and their correctness flags.

Every phase asserts or raises.  Output is one JSON object per line; the line
before the last lists each kernel with its launches, error and times, and
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the port's sources beside it, it exits non-zero and prints no
result.

Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import multiprocessing
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: an L2 sector: the least a random read moves between L2 and an SM
L2_SECTOR_BYTES = 32
#: the measurement probes' source (csrc/probe.cu; no kernel of the port)
PROBE_LIB = "probe"
#: the L2 read-bandwidth probe: a buffer this size (L2-resident), read this
#: many times per launch, by this many blocks per SM
L2_PROBE_BYTES = 16 << 20
L2_PROBE_REPS = 16
L2_PROBE_BLOCKS_PER_SM = 8
#: the distributed-shared-memory load probe: cluster sizes, 2^14 words
#: (64 KB) a block, 1024 threads a block, rounds of 8 loads a thread
DSMEM_PROBE_CLUSTERS = (1, 2, 4, 8, 16)
DSMEM_PROBE_LOG_WORDS = 14
DSMEM_PROBE_THREADS = 1024
DSMEM_PROBE_ROUNDS = 64
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 67e12, "float64": 34e12}
#: the same for work on the tensor cores (K3's products).  f32-accurate
#: products run there as 3xTF32 (each operand split into two TF32 parts,
#: three TF32 products per product, error near f32's), so the card's f32
#: attention rate is the 495 TFLOP/s TF32 peak over 3, not the 67 TFLOP/s
#: of the FMA pipes
TENSOR_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}

#: reference values of the main path (JAX reference on the CPU, iters 200)
LPS_RHO2 = 1.5883946
LPS_RHO2_TOL = 1e-4
HYPERCUBE_RHO2 = 2.0
HYPERCUBE_RHO2_TOL = 2e-4
ORACLE_TOL = 1e-3

#: kernel-vs-plain tolerances (the reference's tests/test_spmv.py levels)
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 0.15}

SPMV_SOURCE = "src/repro_torch/kernels/csrc/spmv.cu"
#: K1's CUDA kernels, as the profiler names them (prefixes)
K1_KERNEL_NAMES = ("spmv_rows_kernel", "spmv_batch_", "spmv_interleave_")
#: kernel classes of a profiled phase's device time (name substrings)
K1_CLASS = ("spmv_kernel_ms", K1_KERNEL_NAMES)
GEMV_CLASS = ("reorth_gemv_ms", ("gemv", "gemm", "xmma", "cutlass"))
SPMV_REPLACES = "src/repro/kernels/spmv.py:172"

#: kernel K2 (Cayley matvec): source in the port, the TPU kernel it replaces
CAYLEY_SOURCE = "src/repro_torch/kernels/csrc/cayley_spmv.cu"
CAYLEY_REPLACES = "src/repro/kernels/cayley_spmv/kernel.py:38"
#: K2 vs its plain version, numpy allclose style (atol = rtol): the per-dtype
#: TOL of tests/test_kernels.py:17
CAYLEY_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the K2 path's rho_2 against the default K1 route's (same start vector;
#: both kernels sum a row in table order)
CAYLEY_VS_K1_RHO2_TOL = 1e-5
#: lps(61,5)'s gathers a matvec: n k = 113,460 x 6
LPS_GATHERS = 113_460 * 6

#: the scale row's reference values: the JAX reference's row for
#: xpander(65536,32,0,0) on the CPU, computed as the scale bench computes it
#: (``survey([SCALE_SPEC], COLUMNS, routing=dict(pattern="uniform",
#: sample_fraction=64/65536, seed=0))``, benchmarks/scale_bench.py), as
#: rounded by the survey; tests/test_torch_synthesis.py::
#: test_scale_tower_reference_winners_match_chip_smoke recomputes every
#: value below from the reference.  (benchmarks/baselines/BENCH_scale.json
#: predates the reference's current code: rho2 20.874629, diameter 4.)
SCALE_REF = {"rho2": 20.884646, "diameter_bfs": 5, "diameter_lb": 5,
             "avg_hops": 3.5995, "avg_hops_ci": [3.5992, 3.5998],
             "path_diversity": 9.4328, "max_link_load": 33.664,
             "saturation_throughput": 0.0061, "throughput_spectral": 20.8843}
SCALE_RHO2_TOL = 1e-3
#: the row's figures rounded to 4 decimals: one unit of the last digit
SCALE_ROUNDED_TOL = 1e-4
#: the reference's ECMP loads are float32 (its ``ecmp_link_loads`` casts),
#: the port's float64: relative gap allowed on max_link_load
SCALE_LOAD_REL_TOL = 1e-5
#: the reference's lift tower for xpander(65536,32,0,0), levels 0-9
#: (n = 64 .. 32768): the winning candidate (index into the 24 budget-0
#: signings), its 90-step float32 Lanczos score, and its exact lambda_max
#: (ARPACK on the host, float64, tol 1e-10).  The port draws the
#: reference's start vectors, so it picks the same winners, and its scores
#: differ from these only by float32 rounding.
SCALE_REF_WINNERS = [12, 22, 10, 7, 4, 9, 4, 13, 3, 15]
SCALE_REF_SCORES = [
    9.780246737706195, 10.3906439346656, 10.715635709338704,
    10.843595138655921, 10.940166743260809, 10.98972691361638,
    11.058387110885924, 11.100757499928278, 11.102504333979972,
    11.104822163037255]
SCALE_REF_EXACT_LMAX = [
    9.780246628100151, 10.390643838888002, 10.715635804249471,
    10.843595224803622, 10.940172751334611, 10.989810825458408,
    11.062769836515322, 11.100789170352813, 11.106249304773216,
    11.115368588212077]
#: the 64-node seed graph's lambda_2 (dense float64)
SCALE_REF_SEED_LAM2 = 6.818187425784928
#: card score vs the reference's, same start vectors: float32 rounding
SCALE_SCORE_TOL = 1e-4
#: exact lambda_max of the same signed adjacency, ARPACK to 1e-10
SCALE_EXACT_TOL = 1e-8
#: the row's rho2 (200-step Lanczos on the whole graph) against the
#: Bilu-Linial value 32 - max(seed lambda_2, winners' exact lambda_max)
SCALE_BILU_LINIAL_TOL = 1e-3
#: torus(32,2)'s antipodal pair: 4 * C(32, 16) minimal paths, above int32
#: and not a float32 value (tests/test_scale.py)
TORUS_ANTIPODAL_PATHS = 4 * math.comb(32, 16)

#: slice 8, the evaluation path: the reference benchmarks' committed
#: baselines the smoke holds the card to (benchmarks/baselines/)
BASELINES = ROOT / "benchmarks" / "baselines"
#: BENCH_routing_schemes.json's scheme_table rounds to 4 decimals: one unit
#: of the last digit, plus the reference's float32 ECMP rounding
SCHEMES_ROUNDED_TOL = 1e-4
SCHEMES_REL_TOL = 1e-5
#: conservation (load sum vs demand-weighted hops), float64 in the port
CONSERVATION_TOL = 1e-9
#: simulated times and throughputs against the reference's float32 engine
SIM_REL_TOL = 1e-5
#: fault sweeps: degraded rho2 (float32 Lanczos) against the baseline's
FAULT_RHO2_TOL = 1e-3
#: collective_sim and workload_sim families whose card rows are held to the
#: same schedules run by the port's plain path on the host (device="cpu")
#: over the graph the card built, not to the baseline: xpander(512,6)
#: refines its lift signings by annealing (default budget).  The annealer
#: now draws the reference's own jax.random numbers (core/threefry.py), but
#: it compares warm-started 10-step float32 Lanczos estimates whose Ritz
#: vectors differ between frameworks from the first step (a degenerate top
#: eigenvalue at level 1, n = 16): the towers part at level 1, annealing
#: step 262, candidate 11 (on the CPU), so no reference figure describes the
#: card's graph (BENCH_simulate.json's and BENCH_workloads.json's rows are
#: also older than the reference's current synthesis)
SIM_HOST_CHECKED = ("xpander(512,6)",)
#: card vs host, both float64 in the port: summation order only
SIM_HOST_REL_TOL = 1e-9
#: the spectral attack ranks edges by their Fiedler energy (f_u - f_v)^2
#: with no rounding, so on a symmetric family the energies tie and the host
#: BLAS's last bits pick the cut: those rows are held to the float64 dense
#: rho2 of the graph the card attacked, not to BENCH_faults.json (whose
#: attack_spectral rows also predate the canonical Fiedler vector)
FAULT_ORACLE_MODELS = ("attack_spectral",)
#: one fault sweep with simulate=True: lps(13,5), link faults at 5 %, 8
#: samples, seed 0, 160 iterations, a 64 MiB ring all-reduce on each
#: degraded sample; the JAX reference's figures on the CPU (seconds of the
#: modeled interconnect), recomputed by tests/test_torch_faults.py
FAULT_SIM = dict(spec="lps(13,5)", rate=0.05, samples=8, seed=0, iters=160)
FAULT_SIM_REF = dict(sim_allreduce_mean=0.04059053538367152,
                     sim_allreduce_max=0.041987642645835876,
                     sim_dropped_frac_mean=0.0)
#: the same sweep's workload= check: qwen2-7b at dp=16, tp=4 (linear
#: placement, fault_sweep's own) on its first two degraded samples; the JAX
#: reference's figures on the CPU (seconds of the modeled cluster),
#: recomputed by tests/test_torch_workloads.py
FAULT_WORKLOAD = dict(spec="qwen2_7b@dp=16,tp=4", samples=2)
FAULT_WORKLOAD_REF = dict(workload_step_mean=5.786608536667133,
                          workload_step_max=5.834307511276508,
                          workload_dropped_frac_mean=0.0)
#: the scale row's other routing schemes (uniform traffic, the row's 64
#: sampled sources, seed 0, ksp slack 1): the JAX reference's figures on
#: the CPU, recomputed by tests/test_torch_synthesis.py::
#: test_scale_tower_reference_winners_match_chip_smoke.  The bootstrap UCB
#: applies to ``minimal`` only, as in the reference, so ugal's saturation
#: throughput is 1 / max load on the same loads as minimal's.
SCALE_SCHEMES_REF = {
    "minimal": dict(max_link_load=33.663963317871094,
                    saturation_throughput=0.00613270789514796,
                    avg_hops=3.5994826237888202),
    "valiant": dict(max_link_load=67.3271255493164,
                    saturation_throughput=0.01485285450464554,
                    avg_hops=7.198856142382696),
    "ugal": dict(max_link_load=33.663963317871094,
                 saturation_throughput=0.029705355562490553,
                 avg_hops=3.5994826237888202),
    "ksp": dict(max_link_load=33.418640574859175,
                saturation_throughput=0.02992341946884277,
                avg_hops=4.536979858262168),
}
#: avg_hops is float64 in both frameworks
SCALE_HOPS_REL_TOL = 1e-9
#: routing-scheme families whose MCF ceiling (a host HiGHS LP, the same
#: code as the reference's) the schemes_bench phase does not solve, to keep
#: the smoke inside its time limit: lps(13,5), the one family above n = 1000
#: (its two LPs take about two minutes), and butterfly(3,4), whose
#: adversarial LP alone takes two to three minutes; every scheme of theirs
#: is still held to the baseline
MCF_SKIP = ("lps(13,5)", "butterfly(3,4)")
#: worker processes for the other fourteen LPs (slimfly(13)'s two take
#: about half of their ~2 minutes on one core), which run on the host while
#: the evaluation and workload phases use the card
MCF_WORKERS = 3

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

#: lm_grad_check: each gradient through the kernels against the plain
#: path's, relative L2, reduced jamba in f32.  Both backwards are the plain
#: versions' autograd; they differ only by the forward activations they are
#: evaluated at, which the kernels give within LM_TOL / ATTN_TOL (at most
#: 3e-5) of the plain versions'.  1e-3 allows ~30x that for the growth
#: through 16 layers, forward and back; a dropped gradient reads 1.0, two
#: unrelated ones ~1.4.
GRAD_REL_TOL = 1e-3

#: the dense-attention serving phase: qwen2-7b at full width and depth (28
#: attention layers, ~15 GB of bf16 weights), 4 requests of 1024-token
#: prompts and 8 greedy new tokens
QWEN_ARCH = "qwen2-7b"
QWEN_REQUESTS, QWEN_PROMPT, QWEN_NEW = 4, 1024, 8
#: its last-position logits through the kernels against a plain prefill,
#: relative L2, derived as SERVE_LOGITS_REL_TOL is: the per-layer mixer
#: bound times sqrt(layers) = 1e-2 * sqrt(28) = 0.053 (qwen2 is dense, so no
#: MoE routing is replayed)
QWEN_LAYERS = 28
QWEN_LOGITS_REL_TOL = SERVE_MIXER_REL_TOL * math.sqrt(QWEN_LAYERS)

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

def _csr_operator(torch, table, loops, signs, n, dt):
    """The case's operator as one torch sparse CSR matrix of dtype ``dt``
    (the library yardstick): (n, n), or block-diagonal (B n, B n) for
    per-batch tables or per-batch signs."""
    tab = table.long()
    if signs is not None and signs.dim() == 3 and tab.dim() == 2:
        tab = tab.expand(signs.shape[0], -1, -1)   # B signings, one table
    batched = tab.dim() == 3
    B = tab.shape[0] if batched else 1
    k = tab.shape[-1]
    rows = torch.arange(B * n, device=tab.device).repeat_interleave(k)
    cols = (tab.reshape(B, n * k)
            + (torch.arange(B, device=tab.device) * n)[:, None]).reshape(-1)
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


def gather_l2_bytes(x_shape, elem: int, table_shape) -> int:
    """L2 bytes the gathers of K1 (and K2) move if each gathered value costs
    a whole 32-byte sector and none is reused in L1 or shared memory: for B
    vectors over one (n, k) table, n k gathers of ceil(B elem / 32) sectors
    each (a neighbour's B values side by side); for one vector (x (n,)) and
    for a (B, n, k) table stack, B n k gathers of one sector each."""
    n, k = table_shape[-2], table_shape[-1]
    B = x_shape[0] if len(x_shape) == 2 else 1
    if len(table_shape) == 2:
        sectors = -(-B * elem // L2_SECTOR_BYTES)
        return n * k * sectors * L2_SECTOR_BYTES
    return B * n * k * L2_SECTOR_BYTES


def kernel_bound(nbytes: int, flops: int, peak_flops: float) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes the function must move over 3.35 TB/s ("bytes") and its
    operations over the peak rate ("operations"); ms."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flops * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops)


def l2_sector_time(l2_bytes: int, l2_bytes_per_s: float) -> dict:
    """A diagnostic beside the bound, never part of it: the time the
    sectors of :func:`gather_l2_bytes` take at the L2 read bandwidth the
    smoke measures.  It is no floor: a cluster's shared memory could hold
    x at these sizes, and hypercube(16)'s low-bit neighbours share sectors
    in L1, so a kernel may read faster than it; ms."""
    return dict(l2_bytes=l2_bytes,
                l2_sector_ms=l2_bytes / l2_bytes_per_s * 1e3)


def sm_clock_hz() -> float:
    """The SM clock ``nvidia-smi`` reports as the card's maximum, Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0]) * 1e6


def sfu_time(exps: int, sms: int, sm_hz: float) -> dict:
    """A diagnostic beside K4's bound, never part of it: ``exps``
    exponentials at the special-function units' 16 per SM per clock, on
    ``sms`` SMs at ``sm_hz``; ms."""
    return dict(exponentials=exps, sm_clock_hz=sm_hz,
                sfu_ms=exps / (16 * sms * sm_hz) * 1e3)


def _probe_library(build):
    """csrc/probe.cu's library (built with the kernels), C signatures set."""
    import ctypes

    lib = build.load(PROBE_LIB)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_l2_read.argtypes = [vp, ll, ci, vp, ci, vp]
    lib.probe_empty.argtypes = [ci, ci, vp]
    lib.probe_dsmem_gather.argtypes = [ci, ci, ci, ci, ci, vp, vp,
                                       ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.probe_l2_read.restype = lib.probe_empty.restype = ci
    lib.probe_dsmem_gather.restype = ci
    lib.probe_error_string.argtypes = [ci]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _probe_ok(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: " + lib.probe_error_string(rc).decode())


def measure_l2_read_bw(torch, build) -> dict:
    """The card's L2 read bandwidth: ``probe_l2_read`` reads an
    L2_PROBE_BYTES buffer (written just before, so it sits in the 50 MB L2)
    L2_PROBE_REPS times in 16-byte loads that bypass L1, over
    L2_PROBE_BLOCKS_PER_SM blocks of 256 threads per SM; a CUDA graph of 16
    launches, median of 5 replays (:func:`_graph_ms`)."""
    lib = _probe_library(build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = L2_PROBE_BLOCKS_PER_SM * sms
    buf = torch.randint(0, 2 ** 31 - 1, (L2_PROBE_BYTES // 4,),
                        dtype=torch.int32, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def probe(b, o):
        _probe_ok(lib, lib.probe_l2_read(
            b.data_ptr(), b.numel() * 4, L2_PROBE_REPS, o.data_ptr(), blocks,
            torch.cuda.current_stream().cuda_stream), "probe_l2_read")

    ms = _graph_ms(torch, probe, [(buf, out)], 16)
    read = L2_PROBE_BYTES * L2_PROBE_REPS
    return dict(l2_read_bytes_per_s=read / (ms * 1e-3), probe_ms=ms,
                buffer_bytes=L2_PROBE_BYTES, reps=L2_PROBE_REPS,
                blocks=blocks, threads=256, sms=sms)


def measure_dsmem_gather(torch, build) -> dict:
    """4-byte loads from a cluster's distributed shared memory
    (``probe_dsmem_gather``): for each cluster size C, clusters of C blocks
    of DSMEM_PROBE_THREADS threads, each block holding
    2^DSMEM_PROBE_LOG_WORDS words, each thread DSMEM_PROBE_ROUNDS rounds of
    8 loads over the C blocks' words (1/C of them its own block's): each at
    a random word, as K2's gathers fall ("random"), or a warp's 32 lanes on
    the 32 words of one random 128-byte line ("lines"); a CUDA graph of 8
    launches, median of 5 replays.  A diagnostic beside K2's row, never
    part of a bound: the rate, and what lps(61,5)'s n k = 680,760 gathers
    would take at it."""
    import ctypes

    lib = _probe_library(build)
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    rows = []
    for pattern, lines in (("random", 0), ("lines", 1)):
        for c in DSMEM_PROBE_CLUSTERS:
            blocks, active = ctypes.c_int(0), ctypes.c_int(0)

            def probe(o, c=c, lines=lines, blocks=blocks, active=active):
                _probe_ok(lib, lib.probe_dsmem_gather(
                    c, DSMEM_PROBE_LOG_WORDS, DSMEM_PROBE_THREADS,
                    DSMEM_PROBE_ROUNDS, lines, o.data_ptr(),
                    torch.cuda.current_stream().cuda_stream,
                    ctypes.byref(blocks), ctypes.byref(active)),
                    f"probe_dsmem_gather C={c} {pattern}")

            ms = _graph_ms(torch, probe, [(out,)], 8)
            gathers = (blocks.value * DSMEM_PROBE_THREADS
                       * DSMEM_PROBE_ROUNDS * 8)
            rate = gathers / (ms * 1e-3)
            rows.append(dict(pattern=pattern, cluster=c, blocks=blocks.value,
                             active_clusters=active.value, gathers=gathers,
                             ms=ms, gathers_per_s=rate,
                             lps_gathers_ms=LPS_GATHERS / rate * 1e3))
    return dict(log_words=DSMEM_PROBE_LOG_WORDS,
                threads=DSMEM_PROBE_THREADS, rounds=DSMEM_PROBE_ROUNDS,
                by_cluster=rows)


def k1_floor(torch, np, KS, REG, build, dev) -> dict:
    """What a single-vector K1 call can come down to, each timed as a CUDA
    graph of 64 calls (:func:`_graph_ms`): an empty kernel on one block and
    on the (n,) form's grid (ceil(n / 256) blocks of 256: the launch
    floor), and K1 on lps(61,5)'s (n,) x with loops over the first 1, 2
    and all 6 columns of its table (k = 1: one dependent table read and
    gather per row, the latency floor of the gather itself).  The operands
    cycle through copies as :func:`check_kernel_case`'s do."""
    lib = _probe_library(build)
    tab_np, w_np = REG.build("lps(61,5)").gather_operands()
    n = tab_np.shape[0]
    grid = -(-n // 256)

    def empty(blocks):
        return lambda: _probe_ok(lib, lib.probe_empty(
            blocks, 256, torch.cuda.current_stream().cuda_stream),
            "probe_empty")

    out = dict(n=n, grid_blocks=grid,
               empty_one_block_ms=_graph_ms(torch, empty(1), [()], 64),
               empty_grid_ms=_graph_ms(torch, empty(grid), [()], 64))
    rng = np.random.default_rng(16)
    loops = torch.as_tensor(w_np, dtype=torch.float32, device=dev)
    for k in (1, 2, tab_np.shape[1]):
        tab = torch.as_tensor(np.ascontiguousarray(tab_np[:, :k]),
                              dtype=torch.int32, device=dev)
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        nbytes = _case_bytes_ops(x, tab, loops, None)[0]
        copies = max(2, min(64, math.ceil(COLD_BYTES / nbytes)))
        sets = [(x.clone(), tab.clone(), loops.clone())
                for _ in range(copies)]
        out[f"k1_k{k}_ms"] = _graph_ms(torch, KS.spmv_cuda, sets,
                                       max(64, copies))
        out[f"k1_k{k}_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    return out


def _sequential_signed(torch, x, table, signs):
    """``acc = acc + s[..., j] * x[table[..., j]]`` for j = 0..k-1 in plain
    PyTorch, in x's dtype: the order of the kernel's sum."""
    acc = torch.zeros_like(x)
    for j in range(table.shape[-1]):
        idx = table[..., j].long()
        if x.dim() == 1:
            g = x[idx]
        elif idx.dim() == 1:
            g = x[:, idx]
        else:
            g = torch.gather(x, 1, idx)
        acc = acc + signs[..., j].to(x.dtype) * g
    return acc


def bitwise_check(torch, CS, case: dict, y_k) -> str:
    """f32 forms that K2 also takes (one (n, k) table, no signs, loops
    (n,) or none) equal K2's result bit for bit; signed f32 forms without
    loops equal the sequential sum bit for bit.  Returns what was compared
    ("k2", "sequential" or "none"); raises where the bits differ."""
    x, table, loops, signs = case["x"], case["table"], case["loops"], \
        case["signs"]
    if x.dtype != torch.float32:
        return "none"
    if signs is None and table.dim() == 2 and (loops is None
                                               or loops.dim() == 1):
        want, what = CS.cayley_spmv_cuda(x, table, loops), "k2"
    elif signs is not None and loops is None:
        want, what = _sequential_signed(torch, x, table, signs), "sequential"
    else:
        return "none"
    torch.cuda.synchronize()
    if not torch.equal(y_k, want):
        diff = float((y_k.double() - want.double()).abs().max())
        raise AssertionError(f"K1 {case['name']}: not bit-equal to {what} "
                             f"(max abs {diff})")
    return what


def check_kernel_case(torch, KS, CS, case: dict, l2_bw: float) -> dict:
    """Kernel K1 vs spmv_ref on one case: error, the bit-equality of
    :func:`bitwise_check`, then kernel / plain / library / bound times."""
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
    bitwise = bitwise_check(torch, CS, case, y_k)
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
            A = _csr_operator(torch, s[1], s[2], s[3], n, x.dtype)
            if table.dim() == 3 or (signs is not None and signs.dim() == 3):
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
    bound = kernel_bound(nbytes, flops, PEAK_FLOPS[dtype])
    l2 = l2_sector_time(gather_l2_bytes(
        tuple(x.shape), x.element_size(), tuple(table.shape)), l2_bw)
    return dict(
        form=case["name"], dtype=dtype, shape=list(x.shape),
        table_shape=list(table.shape), max_abs_err=err, tol=TOL[dtype],
        bitwise=bitwise, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
        library_ms=library_ms, library_timing=library_timing,
        bound_share=bound["bound_ms"] / ms, **bound, **l2,
        cold_copies=copies)


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


def k1_interleave_threshold(torch, np, KS, REG, dev) -> dict:
    """K1's two paths for a shared-table batch timed on the same operands:
    the row path (one thread per (b, row)) and the batch path (interleave
    x, then gather a neighbour's B values together), at lps(61,5) f32 with
    loops, hypercube(16) f32 and a random (16384, 32) table with per-b f32
    signs, for small B (and the lift search's B = 24).  Every pair must
    agree bit for bit.  Reports the B from which the batch path (taken by
    every shared-table batch of B >= 2) pays on every form; asserts no
    speed."""
    rng = np.random.default_rng(15)
    f32 = torch.float32

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def timed(x, table, loops, signs, **kw):
        nbytes = _case_bytes_ops(x, table, loops, signs)[0]
        copies = max(2, min(64, math.ceil(COLD_BYTES / nbytes)))
        sets = [(x.clone(), table, loops, signs) for _ in range(copies)]
        return _graph_ms(torch, lambda *a: KS._spmv_cuda(*a, **kw), sets,
                         max(64, copies))

    forms = []
    lps_tab, lps_w = REG.build("lps(61,5)").gather_operands()
    hc_tab = REG.build("hypercube(16)").gather_operands()[0]
    rnd_tab = rng.integers(0, 16384, size=(16384, 32))
    for name, tab_np, loops_np, signed, bs in (
            ("lps(61,5) f32 loops", lps_tab, lps_w, False, (2, 3, 4, 8)),
            ("hypercube(16) f32", hc_tab, None, False, (2, 4, 8)),
            ("random (16384, 32) f32 per-b signs", rnd_tab, None, True,
             (2, 4, 8, 24))):
        n, k = tab_np.shape
        tab = t(tab_np, torch.int32)
        loops = None if loops_np is None else t(loops_np, f32)
        for B in bs:
            x = t(rng.standard_normal((B, n)), f32)
            signs = (t(rng.choice([-1.0, 1.0], size=(B, n, k)), f32)
                     if signed else None)
            y_r = KS._spmv_cuda(x, tab, loops, signs, interleave=False)
            y_b = KS._spmv_cuda(x, tab, loops, signs, interleave=True)
            torch.cuda.synchronize()
            assert torch.equal(y_r, y_b), (name, B)
            rows_ms = timed(x, tab, loops, signs, interleave=False)
            batch_ms = timed(x, tab, loops, signs, interleave=True)
            forms.append(dict(form=name, B=B, rows_ms=rows_ms,
                              batch_ms=batch_ms,
                              batch_pays=batch_ms < rows_ms))
    pays = [f["B"] for f in forms if f["batch_pays"]]
    smallest = min((B for B in pays if all(
        f["batch_pays"] for f in forms if f["B"] >= B)), default=None)
    return dict(forms=forms,
                smallest_b_where_batch_pays_on_every_form=smallest)


# --------------------------------------------------------------------------
# phase 2c: K2 against its plain version
# --------------------------------------------------------------------------

def cayley_cases(torch, np, REG, dev) -> list:
    """K2's forms: lps(61,5) f32 with loops (the path's form), bf16, as
    (1, n) and (4, n) batches over one table; hypercube(16) without loops;
    ragged n with a compiled radix (7) and a runtime one (12); n =
    1,000,003, whose 4 MB x is beyond what 16 blocks' shared memory
    holds."""
    rng = np.random.default_rng(2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []

    def add(name, x, table, loops=None):
        cases.append(dict(name=name, x=x, table=table, loops=loops))

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    tab_np, w_np = REG.build("lps(61,5)").gather_operands()
    n = tab_np.shape[0]
    tab, loops = t(tab_np, torch.int32), t(w_np, f32)
    x = rng.standard_normal(n)
    add("lps(61,5) f32 loops (n,)", t(x, f32), tab, loops)
    add("lps(61,5) bf16 loops (n,)", t(x, bf16), tab, loops)
    add("lps(61,5) f32 loops (1,n)", t(x[None], f32), tab, loops)
    add("lps(61,5) f32 loops (4,n) one table",
        t(rng.standard_normal((4, n)), f32), tab, loops)
    tab_np = REG.build("hypercube(16)").gather_operands()[0]
    add("hypercube(16) f32 no loops",
        t(rng.standard_normal(tab_np.shape[0]), f32), t(tab_np, torch.int32))
    n = 100_003                               # ragged: not a block multiple
    for k in (7, 12):
        add(f"ragged n=100003 k={k} f32 loops",
            t(rng.standard_normal(n), f32),
            t(rng.integers(0, n, size=(n, k)), torch.int32),
            t(rng.integers(0, 3, size=n), f32))
    n = 1_000_003
    add("n=1000003 k=6 f32 loops", t(rng.standard_normal(n), f32),
        t(rng.integers(0, n, size=(n, 6)), torch.int32),
        t(rng.integers(0, 3, size=n), f32))
    return cases


def check_cayley_case(torch, CS, KS, case: dict, l2_bw: float) -> dict:
    """K2 vs cayley_spmv_ref on one case: error (and, in f32, the gap to K1
    on the same operands), then kernel / plain / CSR library / bound."""
    x, table, loops = case["x"], case["table"], case["loops"]
    dtype = str(x.dtype).replace("torch.", "")
    tol = CAYLEY_TOL[dtype]
    y_k = CS.cayley_spmv_cuda(x, table, loops)
    y_p = CS.cayley_spmv_ref(x, table, loops)
    torch.cuda.synchronize()
    assert y_k.shape == y_p.shape and y_k.dtype == x.dtype, case["name"]
    err, excess = _allclose_err(torch, y_k, y_p, tol)
    if not (math.isfinite(err) and excess <= 0):
        raise AssertionError(f"K2 {case['name']}: |kernel - plain| exceeds "
                             f"{tol} (max abs {err}, excess {excess})")
    row = dict(form=case["name"], dtype=dtype, shape=list(x.shape),
               table_shape=list(table.shape), max_abs_err=err, tol=tol)
    if dtype == "float32":
        # K1 on the same operands: its kernel sums a row in the same order,
        # so the two agree bit for bit
        row["vs_k1_kernel_max_abs"] = float(
            (y_k - KS.spmv_cuda(x, table, loops)).abs().max())
        row["vs_k1_plain_max_abs"] = float(
            (y_k - KS.spmv_ref(x, table, loops)).abs().max())
        assert row["vs_k1_kernel_max_abs"] == 0, (case["name"], row)
    B = x.shape[0] if x.dim() == 2 else 1
    n, k = table.shape
    nbytes = 2 * x.numel() * x.element_size() + table.numel() * 4 + \
        (n * 4 if loops is not None else 0)
    flops = B * n * (k + (2 if loops is not None else 0))
    copies = max(2, min(64, math.ceil(COLD_BYTES / nbytes)))
    sets = [(x.clone(), table.clone(),
             None if loops is None else loops.clone())
            for _ in range(copies)]
    reps = max(64, copies)
    row["ms"] = _graph_ms(torch, CS.cayley_spmv_cuda, sets, reps)
    row["plain_ms"] = _graph_ms(torch, CS.cayley_spmv_ref, sets, reps)
    row["library_ms"] = row["library_timing"] = None
    if dtype == "float32":               # no bf16 sparse CSR matvec
        lib_sets = [(_csr_operator(torch, s[1], s[2], None, n, x.dtype),
                     s[0].T if x.dim() == 2 else s[0])
                    for s in sets[:max(2, copies // 2)]]
        try:
            row["library_ms"] = _graph_ms(torch, torch.matmul, lib_sets, reps)
            row["library_timing"] = "graph"
        except RuntimeError:
            torch.cuda.synchronize()
            row["library_ms"] = _eager_ms(torch, torch.matmul, lib_sets, reps)
            row["library_timing"] = "eager"
    row.update(kernel_bound(nbytes, flops, PEAK_FLOPS[dtype]),
               **l2_sector_time(gather_l2_bytes(
                   tuple(x.shape), x.element_size(), tuple(table.shape)),
                   l2_bw), cold_copies=copies)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


# --------------------------------------------------------------------------
# phase 3b: the K2 path (rho2_lanczos with kernel_matvec)
# --------------------------------------------------------------------------

def cayley_path(torch, S, CS, KS, REG, dev, iters: int) -> dict:
    """rho2_lanczos(lps(61,5), matvec=kernel_matvec(...)): one K2 launch per
    Lanczos step and no K1 launch, rho_2 against the known value and the
    default K1 route's."""
    topo = REG.build("lps(61,5)")
    mv = CS.kernel_matvec(*topo.gather_operands(), device=dev)
    CS.reset_launches()
    KS.reset_launches()
    t0 = time.time()
    rho2 = S.rho2_lanczos(topo, iters=iters, seed=0, matvec=mv, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k2, k1 = CS.launches(), KS.launches()
    rho2_k1 = S.rho2_lanczos(topo, iters=iters, seed=0, device=dev)
    assert k2 == iters and k1 == 0, (k2, k1)
    assert abs(rho2 - LPS_RHO2) <= LPS_RHO2_TOL, rho2
    assert abs(rho2 - rho2_k1) <= CAYLEY_VS_K1_RHO2_TOL, (rho2, rho2_k1)
    return dict(spec=topo.name, iters=iters, rho2=rho2, rho2_k1_route=rho2_k1,
                gap_to_k1_route=abs(rho2 - rho2_k1), seconds=secs,
                cayley_launches=k2, spmv_launches=k1)


# --------------------------------------------------------------------------
# phase 11: the datacenter-scale survey row, the sigma count, exactness
# --------------------------------------------------------------------------

def _k1_form(x, table, loops, signs) -> str:
    """A K1 launch's form, for the launch tally by form."""
    dt = str(x.dtype).replace("torch.", "")
    batch = f"({x.shape[0]}, n)" if x.dim() == 2 else "(n,)"
    tab = " table stack" if table.dim() == 3 else ""
    return f"{dt} {'signed ' if signs is not None else ''}{batch}{tab}"


def _exact_lmax(np, table, signs) -> float:
    """lambda_max of one signed adjacency (n, k) table / slot signs, on the
    host in float64 to 1e-10 (ARPACK)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    n, k = table.shape
    A = sp.csr_matrix((signs.ravel().astype(np.float64),
                       (np.repeat(np.arange(n), k), table.ravel())),
                      shape=(n, n))
    return float(sla.eigsh(A, k=1, which="LA", tol=1e-10)[0][0])


#: the scale path's K1 forms that the kernel check replays at their own
#: shapes: (form, n) of the first launch of each, operands kept
SCALE_K1_FORMS = {("float32 signed (24, n)", 16384),
                  ("float32 signed (12, n)", 32768),
                  ("float64 (64, n)", 65536), ("float64 (16, n)", 65536)}


@contextlib.contextmanager
def _scale_probes(S, KS):
    """Tally K1 launches by form and keep the operands of the first launch
    of each form in SCALE_K1_FORMS (:func:`_k1_capture`), and record each
    signed solve's winner, its score and runner-up, and the winner's
    operands (for its exact lambda_max) while the row runs."""
    import numpy as np

    levels = []
    orig_signed = S.signed_extremes_batched

    def signed(table, slot_signs, *args, **kwargs):
        lmax, lmin = orig_signed(table, slot_signs, *args, **kwargs)
        order = np.argsort(lmax, kind="stable")
        win = int(order[0])
        levels.append(dict(
            n=int(np.asarray(table).shape[0]), candidates=int(lmax.size),
            winner=win, lmax=float(lmax[win]),
            runner_up=int(order[1]), runner_up_lmax=float(lmax[order[1]]),
            margin=float(lmax[order[1]] - lmax[win]),
            operands=(np.array(table), np.array(slot_signs[win]))))
        return lmax, lmin

    S.signed_extremes_batched = signed
    try:
        with _k1_capture(KS, SCALE_K1_FORMS) as (forms, operands):
            yield forms, levels, operands
    finally:
        S.signed_extremes_batched = orig_signed


def _seed_lam2(np, table) -> float:
    """lambda_2 of the lift tower's seed, dense float64 from its table."""
    n = table.shape[0]
    A = np.zeros((n, n))
    np.add.at(A, (np.repeat(np.arange(n), table.shape[1]), table.ravel()), 1)
    return float(np.linalg.eigvalsh(A)[-2])


def scale_row(torch, dev) -> tuple:
    """survey([SCALE_SPEC], SCALE_COLUMNS, routing=...) on the card, with
    its stage split (obs spans), K1 launches by form, peak memory and the
    lift tower's levels; returns (the phase's record, the K1 operands kept
    for :func:`captured_kernel_cases`, the row's Analysis session)."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.api import Analysis, survey
    from repro_torch.core import spectral as S
    from repro_torch.kernels import spmv as KS
    from repro_torch.specs import (SCALE_COLUMNS, SCALE_NODES, SCALE_SOURCES,
                                   SCALE_SPEC)

    obs.reset()
    KS.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _scale_probes(S, KS) as (forms, levels, operands), obs.tracing():
        t0 = time.time()
        analysis = Analysis(SCALE_SPEC, device=dev)
        res = survey([analysis], SCALE_COLUMNS,
                     routing=dict(pattern="uniform",
                                  sample_fraction=SCALE_SOURCES / SCALE_NODES,
                                  seed=0), device=dev)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        rep = obs.metrics_report()
    peak = torch.cuda.max_memory_allocated() / 1e9
    spans = {k: v.total_seconds for k, v in rep.spans.items()}
    calls = {k: v.calls for k, v in rep.spans.items()}
    signed_s = spans.get("spectral/signed_extremes_batched", 0.0)
    stages = dict(
        construction_host_s=spans.get("synthesis/lift_search", 0.0) - signed_s,
        signed_solves_s=signed_s,
        signed_solve_calls=calls.get("spectral/signed_extremes_batched", 0),
        final_rho2_s=spans.get("spectral/rho2_lanczos", 0.0),
        final_rho2_calls=calls.get("spectral/rho2_lanczos", 0),
        bfs_s=spans.get("routing/bfs", 0.0),
        sigma_dp_s=spans.get("routing/sigma", 0.0),
        ecmp_s=spans.get("traffic/ecmp", 0.0),
        ucb_s=spans.get("traffic/ucb", 0.0),
        registry_build_s=spans.get("registry/build", 0.0))
    row = res.rows[0]
    launches = KS.launches()
    t0 = time.time()
    seed_lam2 = _seed_lam2(np, levels[0]["operands"][0])
    for lv in levels:
        table, signs = lv.pop("operands")
        lv["exact_lmax"] = _exact_lmax(np, table, signs)
        lv["score_error"] = lv["exact_lmax"] - lv["lmax"]
    exact_s = time.time() - t0
    bilu_linial = 32 - max([seed_lam2] + [lv["exact_lmax"] for lv in levels])
    return dict(row=row, seconds=seconds, stages=stages,
                spmv_launches=launches, spmv_launches_by_form=dict(forms),
                peak_device_gb=peak, levels=levels, seed_lam2=seed_lam2,
                exact_lmax_host_s=exact_s, bilu_linial_rho2=bilu_linial,
                reference=SCALE_REF,
                rho2_gap_to_reference=abs(row["rho2"] - SCALE_REF["rho2"])), \
        operands, analysis


def check_scale_row(sc: dict) -> None:
    """The scale bench's own conditions; the lift tower level by level
    against the reference's (winner, score, exact lambda_max); the row's
    rho_2 against the Bilu-Linial value of the tower and the reference's;
    and its routing and traffic figures against the reference's."""
    from repro_torch.specs import DIAMETER_LB_FLOOR, SCALE_NODES

    row, ref = sc["row"], SCALE_REF
    lo, hi = row["avg_hops_ci"]
    assert row["nodes"] == SCALE_NODES and row["radix"] == 32, row
    assert row["backend"] == "lanczos", row
    assert DIAMETER_LB_FLOOR <= row["diameter_lb"] <= row["diameter_bfs"], row
    assert lo <= row["avg_hops"] <= hi, row
    assert row["saturation_throughput"] > 0, row
    for c in ("rho2", "avg_hops", "path_diversity", "max_link_load",
              "saturation_throughput", "throughput_spectral"):
        assert math.isfinite(row[c]), (c, row)
    levels = sc["levels"]
    assert len(levels) == len(SCALE_REF_WINNERS) and sc["spmv_launches"] > 0
    for i, lv in enumerate(levels):
        assert lv["winner"] == SCALE_REF_WINNERS[i], (i, lv)
        assert abs(lv["lmax"] - SCALE_REF_SCORES[i]) <= SCALE_SCORE_TOL, \
            (i, lv)
        assert abs(lv["exact_lmax"] - SCALE_REF_EXACT_LMAX[i]) \
            <= SCALE_EXACT_TOL, (i, lv)
    assert abs(sc["seed_lam2"] - SCALE_REF_SEED_LAM2) <= SCALE_EXACT_TOL, sc
    assert abs(row["rho2"] - sc["bilu_linial_rho2"]) \
        <= SCALE_BILU_LINIAL_TOL, (row["rho2"], sc["bilu_linial_rho2"])
    assert sc["rho2_gap_to_reference"] <= SCALE_RHO2_TOL, sc
    assert abs(row["throughput_spectral"] - ref["throughput_spectral"]) \
        <= SCALE_RHO2_TOL, row
    assert row["diameter_bfs"] == ref["diameter_bfs"], row
    assert row["diameter_lb"] == ref["diameter_lb"], row
    for c in ("avg_hops", "path_diversity", "saturation_throughput"):
        assert abs(row[c] - ref[c]) <= SCALE_ROUNDED_TOL, (c, row)
    for got, want in zip(row["avg_hops_ci"], ref["avg_hops_ci"]):
        assert abs(got - want) <= SCALE_ROUNDED_TOL, row
    assert abs(row["max_link_load"] - ref["max_link_load"]) <= \
        SCALE_LOAD_REL_TOL * ref["max_link_load"] + SCALE_ROUNDED_TOL, row


def sigma_exact(REG, R, KS, dev) -> dict:
    """torus(32,2) from source 0: the antipodal minimal-path count, exact
    through K1's float64 form."""
    topo = REG.build("torus(32,2)")
    tab, _ = topo.gather_operands()
    KS.reset_launches()
    dist = R.bfs_distances(tab, sources=[0], device=dev)
    sigma = R.shortest_path_counts(tab, dist, device=dev)
    launches = KS.launches()
    antipode = 16 * 32 + 16                 # (16, 16) in row-major (32, 32)
    got = float(sigma[0, antipode])
    assert int(dist[0, antipode]) == 32, dist[0, antipode]
    assert got == TORUS_ANTIPODAL_PATHS, (got, TORUS_ANTIPODAL_PATHS)
    assert launches == 32, launches         # one f64 (1, n) launch per layer
    return dict(spec=topo.name, antipode=antipode, sigma=got,
                want=TORUS_ANTIPODAL_PATHS, spmv_launches=launches)


def routing_exactness(np, REG, R, KS, dev, specs) -> dict:
    """The reference's own ``_bitwise_case`` on the card for every spec:
    sample_fraction=1.0 equals the exact all-sources analysis field for
    field; the card's dist and sigma also equal the CPU's."""
    KS.reset_launches()
    cases = []
    for spec in specs:
        t0 = time.time()
        topo = REG.build(spec)
        exact = R.analyze_routing(topo, device=dev)
        full = R.analyze_routing(topo, sample_fraction=1.0, seed=1,
                                 device=dev)
        bitwise = bool(
            full.exact
            and np.array_equal(full.sources, exact.sources)
            and np.array_equal(full.dist, exact.dist)
            and np.array_equal(full.sigma, exact.sigma)
            and full.diameter == exact.diameter == full.diameter_lb
            and full.avg_path_length == exact.avg_path_length
            and np.array_equal(full.hop_histogram, exact.hop_histogram)
            and full.path_diversity_mean == exact.path_diversity_mean
            and full.avg_hops_ci == (exact.avg_path_length,
                                     exact.avg_path_length))
        host = R.analyze_routing(topo, device="cpu")
        card_eq_cpu = bool(np.array_equal(exact.dist, host.dist)
                           and np.array_equal(exact.sigma, host.sigma))
        cases.append(dict(family=topo.name, spec=spec, nodes=topo.n,
                          bitwise=bitwise, card_equals_cpu=card_eq_cpu,
                          diameter=exact.diameter,
                          seconds=time.time() - t0))
        assert bitwise and card_eq_cpu, cases[-1]
    return dict(cases=cases, spmv_launches=KS.launches())


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

    # K5: prefill rows (B*S, D), decode rows (jamba, then qwen2-7b's width),
    # f32, ragged rows and widths
    for form, (R, D), dt in (("prefill (4096, 4096) bf16", (4096, 4096), bf),
                             ("decode (4, 4096) bf16", (4, 4096), bf),
                             ("qwen prefill (4096, 3584) bf16", (4096, 3584),
                              bf),
                             ("qwen decode (4, 3584) bf16", (4, 3584), bf),
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

    # K3: the serving prefill (B 4, S 1024, H 32, Kv 8, hd 128), then the
    # qwen2-7b phase's prefill (G = 7), gemma-2b's MQA hd 256 and an hd 64
    # form: each of these holds more work tiles than the card has SMs, so
    # the persistent bf16 blocks take several tiles at every compiled width
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
             f32),
            ("qwen prefill causal bf16", (4, 1024, 28, 4, 128), True, bf),
            ("gemma-2b prefill causal bf16", (4, 1024, 8, 1, 256), True, bf),
            ("hd 64 non-causal bf16", (4, 1024, 16, 2, 64), False, bf)):
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

    # K4: the serving prefill (B 4, L 1024, Di 8192, N 16) with the model's
    # A = -(n+1) and with a general A, f32, ragged L and Di, one request
    # (B 1), N 5 (no multiple of K4's eight states a lane) at an odd Di
    # (which the wrapper pads to a 16-byte row), and one step (L 1)
    def h_check(got, want):
        err, excess = _allclose_err(torch, got[1], want[1], H_FINAL_TOL)
        if not (math.isfinite(err) and excess <= 0):
            raise AssertionError(f"mamba_scan h_final: |kernel - plain| "
                                 f"exceeds {H_FINAL_TOL} (max abs {err})")
        return dict(h_final_max_abs_err=err, h_final_tol=H_FINAL_TOL)

    sm_hz = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for form, (B, L, Di, N), dt, general_a in (
            ("prefill bf16", (4, 1024, 8192, 16), bf, False),
            ("prefill f32", (4, 1024, 8192, 16), f32, False),
            ("ragged L=1000 Di=8100 bf16", (4, 1000, 8100, 16), bf, False),
            ("prefill general A bf16", (4, 1024, 8192, 16), bf, True),
            ("B 1 prefill bf16", (1, 1024, 8192, 16), bf, False),
            ("N 5 ragged L=1000 Di=4099 bf16", (2, 1000, 4099, 5), bf, True),
            ("L 1 bf16", (4, 1, 8192, 16), bf, False)):
        x = randn(B, L, Di, dtype=dt)
        delta = F.softplus(randn(B, L, Di) * 0.5 - 1.0).to(dt)
        if general_a:      # -exp(U(-1, 2)) per (d, n): no structure in n
            A = -torch.exp(torch.rand(Di, N, generator=gen, device=dev) * 3
                           - 1)
        else:
            A = -torch.arange(1, N + 1, device=dev, dtype=f32).expand(
                Di, N).contiguous()
        B_t, C_t = randn(B, L, N, dtype=dt), randn(B, L, N, dtype=dt)
        Dw = torch.ones(Di, device=dev)
        es = x.element_size()
        nbytes = (3 * B * L * Di + 2 * B * L * N) * es + (Di * N + Di) * 4 \
            + B * Di * N * 4
        row = _lm_case(
            torch, "mamba_scan", form, K4.mamba_scan_cuda, K4.mamba_scan_ref,
            (x, delta, A, B_t, C_t, Dw), LM_TOL[str(dt)[6:]], nbytes,
            6 * B * L * Di * N + 3 * B * L * Di, PEAK_FLOPS["float32"],
            reps=8, plain_reps=2, extra_check=h_check)
        row.update(sfu_time(B * L * Di * N, sms, sm_hz))
        rows.append(row)
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


def _classify_kernel(name: str) -> str:
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


def _profiled(torch, fn):
    """``fn()`` under torch.profiler: its result and a row of device time by
    kernel class (CUDA kernel events), busy time and idle share of the
    host-clock wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes = dict.fromkeys(("rmsnorm_ms", "flash_attention_ms",
                             "mamba_scan_ms", "matmul_ms", "other_ms"), 0.0)
    kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        kernels += 1
        classes[_classify_kernel(e.name)] += us / 1e3
    busy = sum(classes.values())
    row = dict(wall_ms=wall * 1e3, device_kernels=kernels)
    if busy > 0:
        row.update(classes, device_busy_ms=busy,
                   device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
                   flash_attention_share=classes["flash_attention_ms"]
                   / busy)
    else:
        row.update({c: "not measured" for c in classes},
                   device_busy_ms="not measured",
                   device_idle_share="not measured",
                   flash_attention_share="not measured")
    return out, row


def serve_split(torch, dev, params, prompts) -> dict:
    """Device time of one prefill and of 4 decode steps by kernel class, from
    torch.profiler's CUDA kernel events, and the device idle share."""
    from repro_torch.models import model as M
    from repro_torch.serve import serving_config

    cfg = serving_config(SERVE_ARCH, layers=SERVE_LAYERS)
    max_len = SERVE_PROMPT + SERVE_NEW
    (logits, caches), prefill_row = _profiled(
        torch, lambda: M.prefill(params, {"tokens": prompts}, cfg, max_len))
    tok = logits.argmax(-1)

    def four_steps():
        c, t = caches, tok
        for i in range(4):
            lg, c = M.decode_step(params, t, c, SERVE_PROMPT + i, cfg)
            t = lg.argmax(-1)
        return t

    _, decode_row = _profiled(torch, four_steps)
    return dict(prefill=prefill_row, decode_4_steps=decode_row)


def qwen_phase(torch, dev) -> dict:
    """qwen2-7b at full width and depth, served through ``generate``: every
    layer's prefill attention is K3.  Counts the launches, profiles one
    prefill, and holds the logits against the same prefill through the
    plain versions (and reports one bf16 ulp on the input embeddings for
    scale)."""
    from repro_torch.models import model as M
    from repro_torch.serve import generate, serving_config

    cfg = serving_config(QWEN_ARCH)
    assert cfg.n_layers == QWEN_LAYERS, cfg.n_layers
    n_attn = sum(s.kind == "attn" for s in cfg.pattern) * cfg.n_repeats
    max_len = QWEN_PROMPT + QWEN_NEW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (QWEN_REQUESTS, QWEN_PROMPT),
                            generator=gen, device=dev)
    generate(params, cfg, prompts[:, :64], 2)       # warm-up, not counted

    counters = _lm_counters()
    for mod in counters.values():
        mod.reset_launches()
    res = generate(params, cfg, prompts, QWEN_NEW)
    launches = {n: mod.launches() for n, mod in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res.decode_steps
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * (1 + steps),
            "flash_attention": n_attn, "mamba_scan": 0}
    assert launches == want, (launches, want)

    (logits, _), prefill_row = _profiled(
        torch, lambda: M.prefill(params, {"tokens": prompts}, cfg, max_len))
    with _plain_kernels():
        plain_logits, _ = M.prefill(params, {"tokens": prompts}, cfg,
                                    max_len)
        x = M._embed_in(params, {"tokens": prompts}, cfg)
        g2 = torch.Generator(device=dev)
        g2.manual_seed(2)
        sign = torch.randint(0, 2, x.shape, generator=g2, device=dev) * 2 - 1
        x_ulp = (x.float() * (1 + sign * 2.0 ** -8)).to(x.dtype)
        ulp_logits, _ = M.prefill(params, {"embeds": x_ulp}, cfg, max_len)
        del x, sign, x_ulp
    torch.cuda.synchronize()
    for lg in (res.prefill_logits, logits, plain_logits, ulp_logits):
        assert lg.shape == (QWEN_REQUESTS, cfg.vocab_size), lg.shape
        assert torch.isfinite(lg).all()
    toks = res.tokens
    assert toks.shape == (QWEN_REQUESTS, QWEN_NEW), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    rel = _rel_l2(res.prefill_logits, plain_logits)
    assert rel <= QWEN_LOGITS_REL_TOL, (rel, QWEN_LOGITS_REL_TOL)
    del params
    torch.cuda.empty_cache()
    return dict(
        arch=QWEN_ARCH, n_layers=cfg.n_layers, reduced=[], params=n_params,
        dtype=cfg.compute_dtype, seed=0, init_seconds=init_s,
        requests=QWEN_REQUESTS, prompt_len=QWEN_PROMPT, max_new=QWEN_NEW,
        prefill_ms=res.prefill_s * 1e3,
        prefill_tokens_per_s=QWEN_REQUESTS * QWEN_PROMPT / res.prefill_s,
        decode_ms_per_step=res.decode_s / steps * 1e3,
        peak_memory_gb=peak_gb, launches=launches, launches_expected=want,
        prefill_profile=prefill_row,
        flash_attention_ms=prefill_row["flash_attention_ms"],
        flash_attention_share=prefill_row["flash_attention_share"],
        logits_rel_l2_vs_plain=rel, logits_rel_tol=QWEN_LOGITS_REL_TOL,
        one_ulp_input_logits_rel_l2=_rel_l2(ulp_logits, plain_logits),
        first_token_agree=int((res.prefill_logits.argmax(-1)
                               == plain_logits.argmax(-1)).sum()),
        tokens_head=toks.tolist())


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


def lm_grad_check(torch, dev) -> dict:
    """Gradients through one reduced-jamba prefill on the card (f32), through
    the kernels (K5, K3, K4 forward; their plain versions' gradient) and
    through the plain versions, replaying the kernel run's MoE expert
    choices: w.r.t. the input embeddings and one parameter each of a Mamba
    layer (A_log, K4's A), an attention layer (wq, upstream of K3) and a
    norm (that attention block's norm1, K5's weight)."""
    from repro_torch.models import model as M
    from repro_torch.serve import serving_config

    cfg = serving_config(SERVE_ARCH, use_reduced=True)
    params = M.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    B, S = 2, 40
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    embeds = M._embed_in(params, {"tokens": tokens}, cfg).detach()
    kinds = [spec.kind for spec in cfg.pattern]
    mi, ai = kinds.index("mamba"), kinds.index("attn")
    leaves = {"embeds": embeds,
              "mamba.A_log": params["blocks"][mi]["mamba"]["A_log"],
              "attn.wq": params["blocks"][ai]["attn"]["wq"],
              "attn.norm1": params["blocks"][ai]["norm1"]}
    for t in leaves.values():
        t.requires_grad_(True)
    weights = torch.randn(B, cfg.vocab_size, generator=gen, device=dev)

    def grads():
        logits, _ = M.prefill(params, {"embeds": embeds}, cfg, S + 4)
        return torch.autograd.grad((logits * weights).sum(),
                                   list(leaves.values()))

    counters = _lm_counters()
    for mod in counters.values():
        mod.reset_launches()
    with _moe_routes() as routes:
        got = grads()
    launches = {n: mod.launches() for n, mod in counters.items()}
    with _plain_kernels(), _moe_routes(replay=routes):
        want = grads()
    torch.cuda.synchronize()
    n_attn = sum(k == "attn" for k in kinds) * cfg.n_repeats
    expect = {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": n_attn,
              "mamba_scan": cfg.n_layers - n_attn}
    assert launches == expect, (launches, expect)
    rows = {}
    for name, g, w in zip(leaves, got, want):
        assert g is not None and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        rel = _rel_l2(g, w)
        dropped = int(((w != 0) & (g == 0)).sum())
        rows[name] = dict(rel_l2=rel, plain_norm=float(w.norm()),
                          nonzero_plain=int((w != 0).sum()),
                          zero_where_plain_nonzero=dropped)
        assert float(w.norm()) > 0, (name, "plain gradient is zero")
        assert rel <= GRAD_REL_TOL, (name, rel, GRAD_REL_TOL)
        assert dropped == 0, (name, dropped)
    for t in leaves.values():
        t.requires_grad_(False)
    return dict(config=cfg.name, dtype=cfg.compute_dtype, batch=B, seq=S,
                launches=launches, rel_tol=GRAD_REL_TOL, grads=rows)


# --------------------------------------------------------------------------
# phase 7: where a Lanczos solve's device time goes
# --------------------------------------------------------------------------

def lanczos_split(torch, S, topo, dev, iters: int) -> dict:
    """Device time of one rho2_lanczos solve by kernel class, from
    torch.profiler's CUDA kernel events (``not measured`` if it shows none)."""
    S.rho2_lanczos(topo, iters=iters, seed=0, device=dev)   # warm-up
    rho2, row = _device_split(
        torch, lambda: S.rho2_lanczos(topo, iters=iters, seed=0, device=dev),
        (K1_CLASS, GEMV_CLASS))
    out = dict(spec=topo.name, iters=iters, rho2=rho2,
               solve_wall_ms=row.pop("wall_ms"), **row)
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
# slice 8: the evaluation path (routing schemes, simulator, fault sweeps)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _k1_capture(KS, wanted):
    """Keep the operands of the first K1 launch of each ``(form, n)`` in
    ``wanted`` (forms as :func:`_k1_form` names them; a set of keys, or a
    predicate on a key) while a phase runs, and tally its launches by
    form."""
    import collections

    forms, operands = collections.Counter(), {}
    orig = KS.spmv_cuda
    take = wanted if callable(wanted) else wanted.__contains__

    def k1(x, table, loops=None, signs=None):
        form = _k1_form(x, table, loops, signs)
        forms[form] += 1
        key = (form, x.shape[-1])
        if take(key) and key not in operands:
            operands[key] = (tuple(x.shape), x.dtype, table, loops, signs)
        return orig(x, table, loops, signs)

    KS.spmv_cuda = k1
    try:
        yield forms, operands
    finally:
        KS.spmv_cuda = orig


def captured_kernel_cases(torch, np, operands: dict, where: str,
                          dev) -> list:
    """K1 cases from :func:`_k1_capture`'s operands (the first launch of
    each form a path made), with fresh standard-normal x of each launch's
    shape and dtype."""
    rng = np.random.default_rng(11)
    cases = []
    for (form, n), (shape, dtype, table, loops, signs) in \
            sorted(operands.items()):
        x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                            device=dev)
        cases.append(dict(name=f"{where} n={n} {form}", x=x, table=table,
                          loops=loops, signs=signs))
    return cases


def _device_split(torch, fn, classes) -> tuple:
    """``fn()`` under torch.profiler: its result and a row of device ms by
    kernel class (``classes``: (key, name substrings) pairs, first match
    wins; the rest is ``other_ms``), busy time and idle share of the
    host-clock wall (``not measured`` if it shows no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms = dict.fromkeys([key for key, _ in classes] + ["other_ms"], 0.0)
    kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        kernels += 1
        name = e.name.lower()
        key = next((k for k, subs in classes
                    if any(sub in name for sub in subs)), "other_ms")
        ms[key] += us / 1e3
    busy = sum(ms.values())
    row = dict(wall_ms=wall * 1e3, device_kernels=kernels)
    if busy > 0:
        row.update(ms, device_busy_ms=busy,
                   device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)))
    else:
        row.update({k: "not measured" for k in ms},
                   device_busy_ms="not measured",
                   device_idle_share="not measured")
    return out, row


#: the K1 forms the scale row's non-minimal schemes add: KSP's walk DP
#: (float64, shared table, the 0/1 pad mask as shared signs)
SCALE_SCHEME_K1_FORMS = {("float64 signed (12, n)", 65536)}


def scale_schemes(torch, np, KS, analysis) -> tuple:
    """Valiant, UGAL and KSP (slack 1) on the scale row's Analysis (its
    cached 64-source routing, uniform traffic), under the profiler; each
    held to the reference's CPU figures.  Returns (the phase's record, the
    KSP launch's operands for the kernel check)."""
    from repro_torch.specs import SCALE_NODES, SCALE_SOURCES

    frac = SCALE_SOURCES / SCALE_NODES
    KS.reset_launches()
    t0 = time.time()
    minimal = analysis.traffic("uniform", sample_fraction=frac, seed=0)

    def run_schemes():
        return {s: analysis.traffic("uniform", scheme=s, slack=1,
                                    sample_fraction=frac, seed=0)
                for s in ("valiant", "ugal", "ksp")}

    with _k1_capture(KS, SCALE_SCHEME_K1_FORMS) as (forms, operands):
        res, split = _device_split(torch, run_schemes, (K1_CLASS,))
    seconds = time.time() - t0
    res["minimal"] = minimal
    rows = {}
    for s, t in res.items():
        want = SCALE_SCHEMES_REF[s]
        rows[s] = dict(max_link_load=t.max_link_load,
                       saturation_throughput=t.saturation_throughput,
                       avg_hops=t.avg_hops, ucb=t.max_link_load_ucb,
                       conservation_error=t.conservation_error,
                       seconds=t.seconds, reference=want)
        assert t.conservation_error <= CONSERVATION_TOL, (s, rows[s])
        assert abs(t.max_link_load - want["max_link_load"]) <= \
            SCALE_LOAD_REL_TOL * want["max_link_load"], (s, rows[s])
        assert abs(t.avg_hops - want["avg_hops"]) <= \
            SCALE_HOPS_REL_TOL * want["avg_hops"], (s, rows[s])
        # minimal's is the bootstrap UCB (float64 here, float32 there): the
        # row's 4-decimal figure; the others are 1 / max load
        tol = SCALE_ROUNDED_TOL if s == "minimal" else \
            SCALE_LOAD_REL_TOL * want["saturation_throughput"]
        assert abs(t.saturation_throughput - want["saturation_throughput"]) \
            <= tol, (s, rows[s])
    assert np.array_equal(res["ugal"].link_loads, minimal.link_loads), \
        "ugal diverted pairs under uniform traffic"
    return dict(schemes=rows, seconds=seconds, spmv_launches=KS.launches(),
                spmv_launches_by_form=dict(forms), device=split), operands


def _baseline(name: str) -> dict:
    return json.loads((BASELINES / name).read_text())


def _close(got, want, rel: float, abs_: float = 0.0) -> bool:
    return abs(got - want) <= rel * abs(want) + abs_


#: the evaluation path's K1 forms the kernel check replays: ECMP's float64
#: shared-table batch at lps(13,5) (512 sources a call) and the fault
#: sweeps' float32 (32, n, 6) table stacks with per-sample loops
EVAL_K1_FORMS = {("float64 (512, n)", 2184),
                 ("float32 (32, n) table stack", 2184)}


def _mcf_ceiling(table, n: int, pattern: str, fiedler) -> tuple:
    """One MCF ceiling (a host HiGHS LP) in a worker process: (theta*,
    seconds).  The worker starts from a fresh import, so it finds the port
    itself."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.core import traffic as TR

    t0 = time.time()
    ub = TR.mcf_throughput_ub((table, n), pattern, fiedler=fiedler)
    return ub, time.time() - t0


def schemes_bench(np, KS, dev, mcf_skip, pool) -> tuple:
    """benchmarks/routing_schemes.py on the card: its nine families, both
    patterns and all four schemes, held to BENCH_routing_schemes.json's
    scheme_table and its non-minimal flag.  Each MCF ceiling (a host LP)
    goes to ``pool`` as the family's routing finishes, so the LPs run while
    later phases use the card; :func:`schemes_mcf_check` collects them.
    Returns (the phase's record, the pending LP work)."""
    from repro_torch.api import Analysis
    from repro_torch.core.traffic import ROUTING_SCHEMES
    from repro_torch.specs import (ROUTING_SCHEMES_DENSE_THRESHOLD,
                                   ROUTING_SCHEMES_EXPANDERS,
                                   ROUTING_SCHEMES_SPECS)

    base = {r["spec"]: r
            for r in _baseline("BENCH_routing_schemes.json")["scheme_table"]}
    KS.reset_launches()
    t_all = time.time()
    rows, route_s, pending = [], 0.0, []
    wins = True
    for spec in ROUTING_SCHEMES_SPECS:
        a = Analysis(spec, dense_threshold=ROUTING_SCHEMES_DENSE_THRESHOLD,
                     device=dev)
        row = dict(spec=spec, nodes=a.n)
        for pattern in ("uniform", "adversarial"):
            tag = "" if pattern == "uniform" else "_adv"
            t0 = time.time()
            meas = {}
            for s in ROUTING_SCHEMES:
                t = a.traffic(pattern, scheme=s)
                assert t.conservation_error <= CONSERVATION_TOL, \
                    (spec, pattern, s, t.conservation_error)
                meas[s] = t.saturation_throughput
                row[f"thpt_{s}{tag}"] = meas[s]
            route_s += time.time() - t0
            row[f"thpt_mcf_ub{tag}"] = None
            if spec not in mcf_skip:
                fiedler = a.fiedler if pattern == "adversarial" else None
                pending.append((row, tag, meas, base[spec], pool.submit(
                    _mcf_ceiling, a.topo.gather_operands()[0], a.n, pattern,
                    fiedler)))
            if pattern == "adversarial" and spec in ROUTING_SCHEMES_EXPANDERS:
                wins &= (meas["valiant"] >= meas["minimal"]
                         and meas["ugal"] >= meas["minimal"])
            want = base[spec]
            for key in [f"thpt_{s}{tag}" for s in ROUTING_SCHEMES]:
                assert _close(row[key], want[key], SCHEMES_REL_TOL,
                              SCHEMES_ROUNDED_TOL), (spec, key, row[key],
                                                     want[key])
        rows.append(row)
    assert wins, "non-minimal schemes lost to minimal on an expander"
    return dict(rows=rows, seconds=time.time() - t_all,
                routing_seconds=route_s, mcf_skipped=sorted(mcf_skip),
                nonminimal_wins_adversarial_on_expanders=bool(wins),
                spmv_launches=KS.launches(),
                device_busy_ms="not measured"), pending


def schemes_mcf_check(pending) -> dict:
    """The MCF ceilings :func:`schemes_bench` left to its worker pool: each
    held to BENCH_routing_schemes.json, and every scheme at or under it."""
    from repro_torch.specs import MCF_TOL_ABS, MCF_TOL_REL

    t0 = time.time()
    leq_ub, lp_s = True, 0.0
    for row, tag, meas, want, job in pending:
        ub, secs = job.result()
        lp_s += secs
        key = f"thpt_mcf_ub{tag}"
        row[key] = ub
        leq_ub &= all(v <= ub * (1 + MCF_TOL_REL) + MCF_TOL_ABS
                      for v in meas.values())
        assert _close(ub, want[key], SCHEMES_REL_TOL, SCHEMES_ROUNDED_TOL), \
            (row["spec"], key, ub, want[key])
    assert leq_ub, "a scheme beat the MCF ceiling"
    return dict(mcf_host_seconds=lp_s, mcf_wait_seconds=time.time() - t0,
                mcf_lps=len(pending), all_schemes_leq_mcf_ub=bool(leq_ub))


def _sim_row(a, pay: float) -> dict:
    """benchmarks/collective_sim.py's figures for one Analysis session:
    simulated seconds (ring all-reduce, its NetworkModel bound, BFS-tree
    and binomial broadcast, halving-doubling) and the executed and static
    uniform throughputs, plus the ring's schedule for the flags."""
    from repro_torch.specs import COLLECTIVE_SIM_EXTRA_ALGO_MAX_N

    ring = a.simulate("all_reduce", "ring", payload=pay, telemetry=True)
    val = a.network_model().validate(ring)
    extra = a.n <= COLLECTIVE_SIM_EXTRA_ALGO_MAX_N
    hd = extra and a.n & (a.n - 1) == 0

    def t(*args):
        return float(a.simulate(*args, payload=pay).time_seconds[0])

    return dict(
        ring_s=float(ring.time_seconds[0]),
        model_s=val["rows"][0]["predicted_s"],
        bfs_tree_s=t("broadcast", "bfs_tree"),
        binomial_s=t("broadcast", "binomial") if extra else None,
        hd_s=t("all_reduce", "halving_doubling") if hd else None,
        thpt_uniform=a.simulate("traffic", pattern="uniform",
                                payload=pay).saturation_throughput,
        thpt_static=a.traffic("uniform").saturation_throughput,
        ring_geq_model=val["all_measured_geq_predicted"],
        ring_util_max=ring.utilization_max,
        ring_hot_link=list(ring.telemetry.argmax_link()))


def collective_sim(np, KS, dev, sessions: dict) -> dict:
    """benchmarks/collective_sim.py on the card: ring all-reduce (with
    telemetry) against the NetworkModel bound, BFS-tree broadcast, uniform
    traffic, binomial and halving-doubling where the bench runs them, held
    to BENCH_simulate.json (its details' unrounded times; SIM_HOST_CHECKED
    families to the port's host run on the card's graph) and its three
    correctness flags.  Every time is simulated: seconds of the modeled
    interconnect, not of the card.  Leaves each family's (card session,
    host session or None) in ``sessions`` for :func:`workload_sim`."""
    from repro_torch.api import Analysis
    from repro_torch.specs import (COLLECTIVE_SIM_DENSE_THRESHOLD,
                                   COLLECTIVE_SIM_PAYLOAD,
                                   COLLECTIVE_SIM_SPECS,
                                   COLLECTIVE_SIM_SPECTRAL_ORDER,
                                   COLLECTIVE_SIM_THPT_TOL)

    details = _baseline("BENCH_simulate.json")["details"]
    pay = COLLECTIVE_SIM_PAYLOAD
    KS.reset_launches()
    t_all = time.time()
    rows = []
    for spec in COLLECTIVE_SIM_SPECS:
        t0 = time.time()
        a = Analysis(spec, dense_threshold=COLLECTIVE_SIM_DENSE_THRESHOLD,
                     device=dev)
        row = dict(spec=spec, nodes=a.n, rho2=a.rho2, **_sim_row(a, pay))
        row["seconds"] = time.time() - t0
        sessions[spec] = (a, None)
        if spec in SIM_HOST_CHECKED:
            host_a = Analysis(a.topo,
                              dense_threshold=COLLECTIVE_SIM_DENSE_THRESHOLD,
                              device="cpu")
            sessions[spec] = (a, host_a)
            host = _sim_row(host_a, pay)
            want = dict(host, source="the port's host run, card's graph")
            rel, abs_thpt = SIM_HOST_REL_TOL, 0.0
        else:
            d = details[spec]
            want = dict(
                ring_s=d["ring"]["time_seconds"][0],
                model_s=d["validate"]["rows"][0]["predicted_s"],
                bfs_tree_s=d["bfs_tree"]["time_seconds"][0],
                binomial_s=None if d["binomial"] is None
                else d["binomial"]["time_seconds"][0],
                hd_s=None if d["halving_doubling"] is None
                else d["halving_doubling"]["time_seconds"][0],
                # the baseline rounds throughputs to 6 decimals
                thpt_uniform=d["workload_uniform"]["saturation_throughput"],
                source="BENCH_simulate.json")
            rel, abs_thpt = SIM_REL_TOL, 5e-7
        for key in ("ring_s", "model_s", "bfs_tree_s", "binomial_s", "hd_s"):
            assert (row[key] is None) == (want[key] is None), (spec, key)
            if want[key] is not None:
                assert _close(row[key], want[key], rel), \
                    (spec, key, row[key], want[key])
        assert _close(row["thpt_uniform"], want["thpt_uniform"], rel,
                      abs_thpt), (spec, row["thpt_uniform"], want)
        row["reference"] = {k: want[k] for k in
                            ("ring_s", "model_s", "bfs_tree_s", "binomial_s",
                             "hd_s", "thpt_uniform", "source")}
        rows.append(row)
    ring_geq = all(r["ring_geq_model"] for r in rows)
    matches = all(abs(r["thpt_uniform"] - r["thpt_static"])
                  <= COLLECTIVE_SIM_THPT_TOL * r["thpt_static"] for r in rows)
    thpt = {r["spec"]: r["thpt_uniform"] for r in rows}
    rank_ok = all(thpt[x] > thpt[y] for x, y in
                  zip(COLLECTIVE_SIM_SPECTRAL_ORDER,
                      COLLECTIVE_SIM_SPECTRAL_ORDER[1:]))
    assert ring_geq and matches and rank_ok, (ring_geq, matches, rank_ok)
    return dict(rows=rows, seconds=time.time() - t_all, payload_bytes=pay,
                times_are="simulated (modeled interconnect)",
                ring_time_geq_model_lb=bool(ring_geq),
                workload_matches_static_ecmp=bool(matches),
                thpt_rank_matches_spectral=bool(rank_ok),
                spmv_launches=KS.launches(), device_busy_ms="not measured")


def _fault_row_check(got: dict, want: dict, what) -> None:
    assert got["failed_links_mean"] == want["failed_links_mean"], what
    assert got["connectivity_prob"] == want["connectivity_prob"], what
    for key in ("rho2_mean", "rho2_min", "rho2_max"):
        if key in want:
            assert abs(got[key] - want[key]) <= FAULT_RHO2_TOL, \
                (what, key, got[key], want[key])


def _attack_oracle(np, a, model: str, rate: float) -> dict:
    """The attacked graph's host figures: failed links, connectivity, the
    float64 dense rho2, and how many edges tie (to 1e-9 relative) with the
    cut's last Fiedler energy on each side of the cut."""
    from repro_torch.core import faults as F
    from repro_torch.core import spectral as S

    f = a.fiedler
    sc = F.make_scenario(a.topo, model, rate, fiedler=f, device="cpu")
    d = F.apply_faults(a.topo, sc)
    energy = (f[a.topo.edges[:, 0]] - f[a.topo.edges[:, 1]]) ** 2
    cut = np.zeros(a.topo.m, dtype=bool)
    cut[sc.failed_links] = True
    last = energy[cut].min() if cut.any() else 0.0
    tied = np.abs(energy - last) <= 1e-9 * max(last, 1e-300)
    return dict(failed_links_mean=float(sc.n_failed_links),
                connectivity_prob=float(
                    F.connected_component_count(d.n, d.edges) == 1),
                rho2_mean=max(float(S.laplacian_spectrum(d)[1]), 0.0),
                ties_in_cut=int((tied & cut).sum()),
                ties_outside_cut=int((tied & ~cut).sum()))


def fault_sweep_phase(np, KS, dev) -> dict:
    """benchmarks/fault_sweep.py on the card: link-fault survival curves
    (four rates, 32 samples, one batched Laplacian Lanczos solve a rate)
    and the two attacks at 10 % on its nine families, held to
    BENCH_faults.json (FAULT_ORACLE_MODELS to the host's dense oracle on
    the attacked graph) and its two flags; then one simulate=True,
    workload= sweep (FAULT_SIM, FAULT_WORKLOAD) against the reference's
    figures."""
    from repro_torch.api import Analysis
    from repro_torch.specs import (FAULT_SWEEP_ATTACK_RATE,
                                   FAULT_SWEEP_ITERS, FAULT_SWEEP_RATES,
                                   FAULT_SWEEP_SAMPLES, FAULT_SWEEP_SEED,
                                   FAULT_SWEEP_SPECS)

    base = _baseline("BENCH_faults.json")
    KS.reset_launches()
    t_all = time.time()
    rows = []
    interlacing = batched = True
    for spec in FAULT_SWEEP_SPECS:
        t0 = time.time()
        a = Analysis(spec, device=dev)
        sweep = a.fault_sweep(rates=FAULT_SWEEP_RATES, model="link",
                              samples=FAULT_SWEEP_SAMPLES,
                              seed=FAULT_SWEEP_SEED, iters=FAULT_SWEEP_ITERS)
        interlacing &= all(r["rho2_max"] <= r["interlacing_rho2_ub"] + 1e-3
                           for r in sweep.rows)
        batched &= sweep.batched_solves == len(FAULT_SWEEP_RATES)
        for got, want in zip(sweep.rows, base["curves"][spec]["rows"]):
            _fault_row_check(got, want, (spec, got["rate"]))
        attacks = {}
        for m in ("attack_degree", "attack_spectral"):
            r = a.fault_sweep(rates=(FAULT_SWEEP_ATTACK_RATE,), model=m,
                              iters=FAULT_SWEEP_ITERS).rows[0]
            baseline = base["adversarial"][spec][m]["rows"][0]
            want = _attack_oracle(np, a, m, FAULT_SWEEP_ATTACK_RATE) \
                if m in FAULT_ORACLE_MODELS else baseline
            _fault_row_check(r, want, (spec, m))
            attacks[m] = dict(rho2_mean=r["rho2_mean"],
                              connectivity_prob=r["connectivity_prob"],
                              failed_links_mean=r["failed_links_mean"],
                              held_to="host dense oracle, same graph"
                              if m in FAULT_ORACLE_MODELS
                              else "BENCH_faults.json",
                              oracle=want if m in FAULT_ORACLE_MODELS
                              else None,
                              baseline_rho2_mean=baseline["rho2_mean"])
        rows.append(dict(spec=spec, nodes=a.n, rho2_healthy=sweep.rho2_healthy,
                         curve=[dict(rate=r["rate"], rho2_mean=r["rho2_mean"],
                                     connectivity_prob=r["connectivity_prob"])
                                for r in sweep.rows],
                         attacks=attacks, seconds=time.time() - t0))
    assert interlacing and batched, (interlacing, batched)
    curves_s = time.time() - t_all
    t0 = time.time()
    a = Analysis(FAULT_SIM["spec"], device=dev)
    sim = a.fault_sweep(rates=(FAULT_SIM["rate"],),
                        samples=FAULT_SIM["samples"], seed=FAULT_SIM["seed"],
                        iters=FAULT_SIM["iters"], simulate=True,
                        workload=FAULT_WORKLOAD["spec"],
                        workload_samples=FAULT_WORKLOAD["samples"]).rows[0]
    got = {k: sim[k] for k in FAULT_SIM_REF}
    for k, want in FAULT_SIM_REF.items():
        assert _close(got[k], want, SIM_REL_TOL, 1e-12), (k, got, want)
    got_wl = {k: sim[k] for k in FAULT_WORKLOAD_REF}
    for k, want in FAULT_WORKLOAD_REF.items():
        assert _close(got_wl[k], want, SIM_REL_TOL, 1e-12), (k, got_wl, want)
    return dict(rows=rows, curves_seconds=curves_s,
                simulate=dict(FAULT_SIM, **got, reference=FAULT_SIM_REF,
                              workload=dict(FAULT_WORKLOAD, **got_wl,
                                            reference=FAULT_WORKLOAD_REF),
                              times_are="simulated (modeled interconnect)",
                              seconds=time.time() - t0),
                all_interlacing_hold=bool(interlacing),
                one_batched_solve_per_rate=bool(batched),
                seconds=time.time() - t_all, spmv_launches=KS.launches(),
                device_busy_ms="not measured")


# --------------------------------------------------------------------------
# slice 9: the training-workload path
# --------------------------------------------------------------------------

#: workload_sim's figures against BENCH_workloads.json's workload_table:
#: the reference's float32 ECMP (SIM_REL_TOL) plus one unit of each
#: column's last rounded digit
WORKLOAD_KEYS = {"step_ms": 1e-4, "compute_ms": 1e-4, "dp_ms": 1e-4,
                 "tp_ms": 1e-4, "moe_ms": 1e-4, "exposed_frac": 1e-4,
                 "dropped_frac": 1e-6}
#: the phase's rank correlation against the one of the figures it is held
#: to (the baseline's correlations describe the reference's own xpander)
WORKLOAD_CORRELATION_TOL = 1e-4
#: the report's step time is printed to three decimals of a millisecond
REPORT_STEP_TOL_MS = 5e-4
#: the family whose workload run the phase repeats under the profiler
WORKLOAD_PROFILED = "lps(13,5)"


def _workload_row(res) -> dict:
    """benchmarks/workload_sim.py's figures of one WorkloadResult,
    unrounded (ms of the modeled cluster)."""
    return dict(step_ms=res.step_seconds * 1e3,
                compute_ms=res.compute_seconds * 1e3,
                dp_ms=res.dp_seconds * 1e3, tp_ms=res.tp_seconds * 1e3,
                moe_ms=res.moe_seconds * 1e3,
                exposed_frac=res.exposed_comm_fraction,
                dropped_frac=res.dropped_frac)


def topology_report_check(spec: str, workload: str, placement: str,
                          want_step_ms: float) -> dict:
    """``python -m repro_torch.topology_report SPEC --workload W
    --placement P`` in a subprocess on the card: exit code 0 and the step
    time it prints equal to ``want_step_ms`` (to its printed digits)."""
    cmd = [sys.executable, "-m", "repro_torch.topology_report", spec,
           "--workload", workload, "--placement", placement]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.time()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    m = re.search(r"step time\s+:\s+([\d.]+) ms", out.stdout)
    assert m, out.stdout[-2000:]
    step = float(m.group(1))
    assert abs(step - want_step_ms) <= REPORT_STEP_TOL_MS, (step,
                                                            want_step_ms)
    return dict(command=" ".join(cmd[1:]), returncode=out.returncode,
                step_ms=step, phase_step_ms=want_step_ms,
                seconds=time.time() - t0)


def workload_sim(torch, np, KS, dev, sessions: dict) -> dict:
    """benchmarks/workload_sim.py on the card: the nine collective_sim
    families (their sessions: routing, rho2 and the xpander search reused)
    x the three training jobs at world 64, random placement.  One job runs
    through ``survey(workload=...)``, the others through
    ``Analysis.simulate(workload=...)``; every row is held to
    BENCH_workloads.json's workload_table (SIM_HOST_CHECKED families to the
    port's host run on the card's graph), the plans to the HLO audit and
    the step times to the spectral order.  Every step time is simulated:
    seconds of the modeled cluster, not of the card."""
    from repro_torch.api import survey
    from repro_torch.core import workloads as W
    from repro_torch.specs import (COLLECTIVE_SIM_SPECS,
                                   COLLECTIVE_SIM_SPECTRAL_ORDER,
                                   WORKLOAD_SIM_PLACEMENT,
                                   WORKLOAD_SIM_WORKLOADS)

    bench = _baseline("BENCH_workloads.json")
    base = {(r["spec"], r["workload"]): r for r in bench["workload_table"]}
    place = WORKLOAD_SIM_PLACEMENT
    KS.reset_launches()
    t_all = time.time()
    plans = {w: W.plan_workload(w) for w in WORKLOAD_SIM_WORKLOADS}
    crosscheck_ok = all(W.hlo_crosscheck(p)["ok"] for p in plans.values())
    via_survey = WORKLOAD_SIM_WORKLOADS[1]
    t0 = time.time()
    sv = survey([sessions[s][0] for s in COLLECTIVE_SIM_SPECS],
                columns=["spec", "nodes", "rho2"],
                workload=dict(spec=via_survey, placement=place), device=dev)
    survey_s = time.time() - t0
    rows = []
    for spec, srow in zip(COLLECTIVE_SIM_SPECS, sv.rows):
        a, host = sessions[spec]
        for w, plan in plans.items():
            res = a.simulate(workload=plan, placement=place)
            row = dict(spec=spec, nodes=a.n, rho2=a.rho2, workload=w,
                       via="survey" if w == via_survey
                       else "Analysis.simulate", **_workload_row(res),
                       seconds=res.seconds)
            if w == via_survey:
                assert srow["step_time_ms"] == round(row["step_ms"], 6), \
                    (spec, srow, row)
            if spec in SIM_HOST_CHECKED:
                want = dict(_workload_row(host.simulate(workload=plan,
                                                        placement=place)),
                            source="the port's host run, card's graph")
                rel, units = SIM_HOST_REL_TOL, dict.fromkeys(WORKLOAD_KEYS,
                                                             0.0)
            else:
                b = base[(spec, w)]
                want = dict({k: b[k] for k in WORKLOAD_KEYS},
                            source="BENCH_workloads.json")
                rel, units = SIM_REL_TOL, WORKLOAD_KEYS
            for key, unit in units.items():
                assert _close(row[key], want[key], rel, unit), \
                    (spec, w, key, row[key], want[key])
            row["reference"] = want
            rows.append(row)
    rank_ok, correlations = True, {}
    for w in WORKLOAD_SIM_WORKLOADS:
        mine = [r for r in rows if r["workload"] == w]
        step = {r["spec"]: r["step_ms"] for r in mine}
        rank_ok &= all(step[x] < step[y] for x, y in
                       zip(COLLECTIVE_SIM_SPECTRAL_ORDER,
                           COLLECTIVE_SIM_SPECTRAL_ORDER[1:]))
        got = W.spectral_rank_correlation(mine, step_key="step_ms")
        want = W.spectral_rank_correlation(
            [dict(rho2=r["rho2"], step_ms=r["reference"]["step_ms"])
             for r in mine])
        assert abs(got - want) <= WORKLOAD_CORRELATION_TOL, (w, got, want)
        correlations[w] = dict(
            card=got, held_to=want,
            baseline=bench["correctness"]["rank_correlation"][w])
    assert crosscheck_ok == bench["correctness"]["hlo_crosscheck_ok"], \
        crosscheck_ok
    assert rank_ok == bench["correctness"][
        "step_time_rank_matches_spectral"], rank_ok
    launches = KS.launches()
    # one job again on the bench's largest family, uncached, under the
    # profiler: the device's busy time against the host's wall
    a, _ = sessions[WORKLOAD_PROFILED]
    plan = plans[WORKLOAD_SIM_WORKLOADS[0]]
    again, split = _device_split(
        torch, lambda: W.simulate_workload(a.topo, plan, placement=place,
                                           routing=a.routing(), device=dev),
        [("k1_spmv_ms", ("spmv",))])
    want = next(r for r in rows if r["spec"] == WORKLOAD_PROFILED
                and r["workload"] == WORKLOAD_SIM_WORKLOADS[0])
    assert _close(again.step_seconds * 1e3, want["step_ms"], 1e-12), \
        (again.step_seconds, want["step_ms"])
    slim = next(r for r in rows if r["spec"] == "slimfly(13)"
                and r["workload"] == via_survey)
    report = topology_report_check("slimfly(13)", via_survey, place,
                                   slim["step_ms"])
    return dict(rows=rows, seconds=time.time() - t_all,
                survey_seconds=survey_s, via_survey=via_survey,
                placement=place, cases=len(rows),
                times_are="simulated (modeled cluster)",
                hlo_crosscheck_ok=bool(crosscheck_ok),
                step_time_rank_matches_spectral=bool(rank_ok),
                rank_correlation=correlations,
                profiled=dict(spec=WORKLOAD_PROFILED,
                              workload=WORKLOAD_SIM_WORKLOADS[0], **split),
                topology_report=report, spmv_launches=launches)


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
    from repro_torch.core import routing as R
    from repro_torch.core import spectral as S
    from repro_torch.interop import topology_from_arrays
    from repro_torch.kernels import build
    from repro_torch.kernels import cayley_spmv as CS
    from repro_torch.kernels import spmv as KS
    from repro_torch.specs import (LPS_DENSE_THRESHOLD, LPS_SPECS,
                                   SCALE_BENCH_SPECS, TABLE1_SPECS)

    t_start = time.time()

    # -- phase 1: the card and the build ---------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    # every kernel source and the probes, nvcc in parallel
    build.build_all(build.KERNELS + (PROBE_LIB,))
    build_s = time.time() - t0
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, build_seconds=build_s,
              kernels_built=list(build.KERNELS),
              allow_tf32=torch.backends.cuda.matmul.allow_tf32))

    # -- phase 1b: the L2 read bandwidth K1's and K2's sectors read at --
    l2 = measure_l2_read_bw(torch, build)
    l2_bw = l2["l2_read_bytes_per_s"]
    print(f"L2 read bandwidth {l2_bw / 1e12:.4f} TB/s "
          f"({L2_PROBE_BYTES >> 20} MiB read {L2_PROBE_REPS}x per launch; "
          f"{smi})", flush=True)
    emit(dict(phase="l2_read_bandwidth", nvidia_smi=smi, **l2))

    # -- phase 1c: random gathers from a cluster's distributed shared memory
    dsmem = measure_dsmem_gather(torch, build)
    print("dsmem_probe (4-byte loads, G/s): " + ", ".join(
        f"{r['pattern']} C={r['cluster']} {r['gathers_per_s'] / 1e9:.1f}"
        for r in dsmem["by_cluster"]) + f" ({smi})", flush=True)
    emit(dict(phase="dsmem_probe", nvidia_smi=smi, **dsmem))

    # -- phase 2: K1 against its plain version ---------------------------
    t0 = time.time()
    results = [check_kernel_case(torch, KS, CS, c, l2_bw)
               for c in kernel_cases(torch, np, REGISTRY, dev)]
    for r in results:
        emit(dict(phase="kernel_check", kernel="spmv_padded", **r))
    emit(dict(phase="kernel_check_done", cases=len(results),
              seconds=time.time() - t0))

    # -- phase 2a: K1's row path against its batch path, small B ---------
    t0 = time.time()
    threshold = k1_interleave_threshold(torch, np, KS, REGISTRY, dev)
    emit(dict(phase="k1_interleave_threshold", seconds=time.time() - t0,
              **threshold))

    # -- phase 2a': the floor of a single-vector K1 call -----------------
    emit(dict(phase="k1_floor", nvidia_smi=smi,
              **k1_floor(torch, np, KS, REGISTRY, build, dev)))

    # -- phase 2c: K2 against its plain version --------------------------
    t0 = time.time()
    k2_rows = [check_cayley_case(torch, CS, KS, c, l2_bw)
               for c in cayley_cases(torch, np, REGISTRY, dev)]
    for r in k2_rows:
        emit(dict(phase="cayley_kernel_check", kernel="cayley_spmv", **r))
    emit(dict(phase="cayley_kernel_check_done", cases=len(k2_rows),
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
    k1_path_launches = launches
    emit(dict(phase="main_path", rows=res.rows, seconds=main_s,
              spmv_launches=launches,
              counters={k: v for k, v in counts.items()
                        if k.startswith(("spmv/", "lanczos/", "survey/"))}))

    # -- phase 3b: the K2 path, rho2_lanczos(matvec=kernel_matvec) -------
    cayley = cayley_path(torch, S, CS, KS, REGISTRY, dev, iters)
    emit(dict(phase="cayley_path", **cayley))

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
    k1_path_launches += batch_launches
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
    k1_path_launches += oracle_launches
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

    # -- phase 7b: the datacenter-scale survey row (xpander, routing) ----
    scale, scale_operands, scale_analysis = scale_row(torch, dev)
    emit(dict(phase="scale_row", **scale))
    check_scale_row(scale)
    k1_path_launches += scale["spmv_launches"]

    # -- phase 7b2: the scale row's Valiant, UGAL and KSP (slice 8) ------
    schemes, ksp_operands = scale_schemes(torch, np, KS, scale_analysis)
    del scale_analysis
    emit(dict(phase="scale_schemes", nvidia_smi=smi, **schemes))
    k1_path_launches += schemes["spmv_launches"]

    # -- phase 7b': K1 against its plain version at the scale path's shapes
    t0 = time.time()
    assert set(scale_operands) == SCALE_K1_FORMS, sorted(scale_operands)
    scale_k1 = [check_kernel_case(torch, KS, CS, c, l2_bw)
                for c in captured_kernel_cases(torch, np, scale_operands,
                                               "scale path", dev)]
    del scale_operands
    for r in scale_k1:
        emit(dict(phase="kernel_check", kernel="spmv_padded", **r))
    emit(dict(phase="scale_kernel_check_done", cases=len(scale_k1),
              seconds=time.time() - t0))
    results += scale_k1

    # -- phase 7b3: K1 at KSP's form (f64, shared table, shared 0/1 signs)
    ksp_k1 = [check_kernel_case(torch, KS, CS, c, l2_bw)
              for c in captured_kernel_cases(torch, np, ksp_operands,
                                             "scale ksp", dev)]
    assert len(ksp_k1) == len(SCALE_SCHEME_K1_FORMS), ksp_k1
    del ksp_operands
    for r in ksp_k1:
        emit(dict(phase="kernel_check", kernel="spmv_padded", **r))
    results += ksp_k1

    # -- phase 7c: torus(32,2)'s antipodal count, exact in float64 -------
    sig = sigma_exact(REGISTRY, R, KS, dev)
    emit(dict(phase="sigma_exact", **sig))
    k1_path_launches += sig["spmv_launches"]

    # -- phase 7d: sample_fraction=1.0 against exact, nine families ------
    t0 = time.time()
    exactness = routing_exactness(np, REGISTRY, R, KS, dev, SCALE_BENCH_SPECS)
    emit(dict(phase="routing_exactness", seconds=time.time() - t0,
              **exactness))
    k1_path_launches += exactness["spmv_launches"]

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

    # -- phase 9b: dense attention at full depth, qwen2-7b (K3 x 28) -----
    t0 = time.time()
    qwen = qwen_phase(torch, dev)
    qwen["seconds"] = time.time() - t0
    emit(dict(phase="qwen_serving", **qwen))

    # -- phase 10: the reduced model, card against CPU -------------------
    emit(dict(phase="reduced_card_vs_cpu", **reduced_cpu_check(torch, dev)))

    # -- phase 10b: gradients through K5, K3, K4 against the plain path --
    emit(dict(phase="lm_grad_check", **lm_grad_check(torch, dev)))

    # -- phase 11: slice 8, the evaluation path's reference benchmarks --
    # (the routing-scheme bench's MCF LPs run in worker processes on the
    # host while phases 11 and 12 use the card)
    t0 = time.time()
    lp_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=MCF_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    with lp_pool:
        bench, mcf_pending = schemes_bench(np, KS, dev, MCF_SKIP, lp_pool)
        k1_path_launches += bench["spmv_launches"]
        sessions = {}
        with _k1_capture(KS, EVAL_K1_FORMS) as (eval_forms, eval_operands):
            sim = collective_sim(np, KS, dev, sessions)
            emit(dict(phase="collective_sim", nvidia_smi=smi, **sim))
            faults = fault_sweep_phase(np, KS, dev)
            emit(dict(phase="fault_sweep", nvidia_smi=smi, **faults))
        k1_path_launches += sim["spmv_launches"] + faults["spmv_launches"]
        eval_k1 = [check_kernel_case(torch, KS, CS, c, l2_bw)
                   for c in captured_kernel_cases(torch, np, eval_operands,
                                                  "evaluation path", dev)]
        assert len(eval_k1) == len(EVAL_K1_FORMS), sorted(eval_operands)
        del eval_operands
        for r in eval_k1:
            emit(dict(phase="kernel_check", kernel="spmv_padded", **r))
        results += eval_k1
        eval_s = time.time() - t0

        # -- phase 12: slice 9, the training-workload path ---------------
        t0 = time.time()
        with _k1_capture(KS, lambda key: key[0] not in eval_forms) as \
                (wl_forms, wl_operands):
            wl = workload_sim(torch, np, KS, dev, sessions)
        del sessions
        emit(dict(phase="workload_sim", nvidia_smi=smi, **wl))
        k1_path_launches += wl["spmv_launches"]
        # a K1 form the evaluation path did not launch gets its kernel check
        first = {}
        for key in sorted(wl_operands):
            first.setdefault(key[0], key)
        wl_k1 = [check_kernel_case(torch, KS, CS, c, l2_bw)
                 for c in captured_kernel_cases(
                     torch, np, {k: wl_operands[k] for k in first.values()},
                     "workload path", dev)]
        del wl_operands
        for r in wl_k1:
            emit(dict(phase="kernel_check", kernel="spmv_padded", **r))
        results += wl_k1
        wl_s = time.time() - t0

        # -- phase 11's MCF ceilings, from the workers -------------------
        bench.update(schemes_mcf_check(mcf_pending))
    assert not multiprocessing.active_children(), \
        multiprocessing.active_children()
    emit(dict(phase="schemes_bench", nvidia_smi=smi, **bench))
    emit(dict(phase="evaluation_path_done", seconds=eval_s,
              spmv_launches_by_form=dict(eval_forms)))
    emit(dict(phase="workload_path_done", seconds=wl_s,
              spmv_launches=wl["spmv_launches"],
              spmv_launches_by_form=dict(wl_forms),
              new_forms_checked=[r["form"] for r in wl_k1]))
    emit(dict(phase="total", seconds=time.time() - t_start))

    # -- the kernels line, then the last line ----------------------------
    main = results[0]
    assert main["form"] == "lps(61,5) f32 plain+loops", main
    k2 = k2_rows[0]
    assert k2["form"] == "lps(61,5) f32 loops (n,)", k2
    kernels = [dict(
        name="spmv_padded", route="cuda", source=SPMV_SOURCE,
        replaces=SPMV_REPLACES, launches=k1_path_launches,
        max_abs_err=max(r["max_abs_err"] for r in results
                        if r["dtype"] == "float32"),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        l2_bytes=main["l2_bytes"], l2_sector_ms=main["l2_sector_ms"],
        l2_read_bytes_per_s=l2_bw,
        forms=[r["form"] for r in results]), dict(
        name="cayley_spmv", route="cuda", source=CAYLEY_SOURCE,
        replaces=CAYLEY_REPLACES, launches=cayley["cayley_launches"],
        max_abs_err=max(r["max_abs_err"] for r in k2_rows
                        if r["dtype"] == "float32"),
        ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
        bound_by=k2["bound_by"], library_ms=k2["library_ms"],
        l2_bytes=k2["l2_bytes"], l2_sector_ms=k2["l2_sector_ms"],
        l2_read_bytes_per_s=l2_bw,
        form=k2["form"], forms=[r["form"] for r in k2_rows])]
    for name, (source, replaces) in LM_KERNELS.items():
        mine = [r for r in lm_rows if r["kernel"] == name]
        first = mine[0]               # the serving path's case
        assert lm_launches[name] > 0, (name, lm_launches)
        path_launches = lm_launches[name] + qwen["launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_launches, max_abs_err=first["max_abs_err"],
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
