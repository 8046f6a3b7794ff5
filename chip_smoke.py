#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It builds the port's six CUDA kernel sources (K1-K5 and K3's backward)
and its measurement probes
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
  ``benchmarks/baselines`` and their correctness flags;
* slice 10, LM training: qwen2-7b at its published widths, 12 of its 28
  layers, one 4096-token sequence, bf16 with f32 AdamW state and remat,
  6 steps through ``repro_torch.runtime.trainer.Trainer`` (K5 and K3
  forward, K3's backward kernel, K5's plain backward; exact launch
  counts), with
  step 1's loss and every gradient held against the plain path, the step
  time, MFU, peak memory and a profiled step's split; then the reduced
  jamba and qwen2 trained on the card against the CPU, a restart from a
  checkpoint against the straight run, and int8 gradient compression;
* slice 11, sharded execution on DTensor, 4 ranks on the one card (gloo;
  DTensor's collectives staged through the host): the explicit
  expert-parallel MoE at kimi-k2-1t-a32b's expert widths (data 1 x model
  4; two all-to-alls a forward) against the single-device MoE, and
  qwen2-7b at published widths, 2 layers, trained 2 steps on a data 2 x
  model 2 mesh against the single-device step (K5, K3 per shard); the
  scale row's start-vector normals by torch ops on the card, bit for bit
  against the host's numpy draw; and ``python -m repro_torch.quickstart``
  on the card against the host run;
* slice 12, the dry run: the sharded_train step traced over a fake 2 x 2
  world on ``cuda`` (no card memory), its per-rank FLOPs, collectives and
  peak held to what the four real ranks count on one more step; then
  production cells at their published widths on the 16 x 16 and 2 x 16 x
  16 meshes (DRYRUN_CELLS, full depth), per-device FLOPs, bytes,
  collectives, memory and the dominant roofline term at the card's
  constants;
* slice 13: K3's backward kernel (the forward writing each row's
  log-sum-exp) at the table, training, sharded-rank, MQA hd 256 and f32
  forms against the plain tile-by-tile backward, timed beside SDPA's
  backward; its launches counted in every training path and its device
  ms read from its profiler range in the training split; K5's redesign
  timed beside its first design and ``F.rms_norm`` at the (4096, 4096),
  (4096, 3584) and (2048, 3584) bf16 forms.
* slice 14, the float8 expert dispatch and the serving example's other
  branches: kimi-k2-1t-a32b at its published widths, 1 of its 61 layers
  (~38.8 GB of bf16 weights), serving 4 requests of 1024 tokens with the
  bf16 dispatch and then the e4m3 dispatch on the same weights (payload
  bits against the host's quantize of the same slots, logits within a
  bound from e4m3's half ulp); the DTensor ``moe_forward`` with the
  e4m3 dispatch on the 4 ranks (groups on every rank, so DTensor's
  all-to-all carries the e4m3 bytes) against one device; the hill-climb's
  ``fp8_dispatch`` variant of kimi-k2 ``train_4k`` traced on ``cuda``; and
  qwen2-vl-7b (a vision stub: prompts and decode inputs are embeddings)
  at full width and depth, served greedy and sampled at temperature 0.8,
  the card's Gumbel draws and samples bit for bit against the host's.
* slice 15, the sharded MoE lowered as the reference's partitioner lowers
  it (the router's logits whole on each rank, the slots of each rank's
  own experts, the combine summed over the ranks): the DTensor layer's
  staged collectives listed by kind, none an all-gather of slots, and its
  forward timed by part (route and gather, quantize, exchange,
  dequantize, products, combine) with either dispatch; the dry run's
  kimi-k2 cell and its ``fp8_dispatch`` variant under the new lowering,
  their collectives equal by kind.
* slice 16, one collective over several mesh axes
  (``parallel.act.redistribute``), Mamba's in_proj halves moved by one
  all-to-all, attention on kv heads the model axis does not divide: the
  dry run's cross-check also holds the count of collectives over several
  axes at once (the four ranks' flattened groups against the fake
  trace's), and each DRYRUN_CELLS cell prints its collectives by the mesh
  axes their groups span; jamba's 2 x 16 x 16 prefill reads its
  all-reduces below DRYRUN_ALL_REDUCE_GB.  On the rig's ranks (CUDA
  tensors, collectives staged through the host), each lowering runs at
  published widths and is held to one device (LOWERING_TRAIN: a
  falcon-mamba-7b and a gemma-2b layer at data 1 x model 4, falcon-mamba
  at pod 2 x data 2 x model 1, each counted against its fake trace; and
  jamba's MoE layer at pod 2 x data 2 x model 2 on 8 ranks, its combine
  summed over ('pod', 'data') in one all-reduce).

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
import gc
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
    # port-side: the reference has no backward kernel; its backward is the
    # jax.checkpoint recompute of chunked_attention's block scan, in JAX
    "flash_attention_backward": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:104"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/kernel.py:54"),
}
#: LM kernel-vs-plain tolerances, numpy allclose style (atol = rtol): the
#: per-dtype TOL of tests/test_kernels.py:17, 3e-5 for f32 attention (its
#: property test), and for K4's f32 final state the reference's 2e-4 scan
#: tolerance (tests/test_kernels.py, mamba sweep)
LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
#: K3's backward kernel against its plain version, relative L2 of each of
#: dq, dk, dv (tests/test_torch_attention_grad.py: f32 products in 3xTF32
#: keep ~1e-6; bf16 rounds P and dS to bf16, 2^-9, before three of the
#: five products, where the plain version keeps dS in f32)
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: K3's training forward's row log-sum-exp against the plain version's,
#: absolute (tests/test_torch_attention_grad.py: lse is O(log S), its f32
#: sums of exponentials ~1e-6 relative; a wrong lse rescales P in the
#: backward, which takes it as given)
LSE_ABS = 1e-4
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

#: slice 14, the float8 expert dispatch: kimi-k2-1t-a32b at its published
#: widths (D 7168, 384 experts, top-8, expert F 2048), 1 of its 61 layers
#: (~19.3 B parameters, ~38.8 GB of bf16 weights, 33.8 GB of them
#: experts), 4 requests of 1024-token prompts and 8 greedy new tokens,
#: served with the bf16 dispatch and then the e4m3 dispatch on the same
#: weights
MOE_FP8_ARCH = "kimi-k2-1t-a32b"
MOE_FP8_LAYERS = 1
MOE_FP8_REQUESTS, MOE_FP8_PROMPT, MOE_FP8_NEW = 4, 1024, 8
#: the e4m3 run's last-position logits against the bf16 run's, relative
#: L2.  Each payload element rounds by at most e4m3's half ulp, 2^-4
#: relative (the per-slot scale puts a slot's largest element at 448, in
#: the normal range); the expert FFN multiplies two linear maps of its
#: input (SiLU-gated), so a slot's output moves by at most about twice
#: that, 2^-3; the gate-weighted combine, the residual sum, the final norm
#: and the head carry a relative perturbation of their input through at
#: most unchanged in L2, and the MoE output is only part of the residual
MOE_FP8_LOGITS_REL_TOL = 2 * 2.0 ** -4
#: the quantize's timing: CUDA-event mean over this many calls
MOE_FP8_QUANTIZE_REPS = 20
#: qwen2-vl-7b at its published widths and all 28 layers (M-RoPE; ~15 GB
#: of bf16 weights), its vision stub fed 4 requests of 1024 random
#: embeddings, 16 new tokens, greedy and at temperature 0.8 from
#: PRNGKey(0) (the serving example's draws)
VL_ARCH = "qwen2-vl-7b"
VL_LAYERS = 28
VL_REQUESTS, VL_PROMPT, VL_NEW = 4, 1024, 16
VL_TEMPERATURE = 0.8
#: the decode steps (and always the last) whose Gumbel draws and samples
#: are recomputed on the host: ~2 s a step there for 4 x 152,064 draws
VL_HOST_CHECKED_STEPS = (0,)
#: the hill-climb's variant, traced on the card's device type at kimi-k2's
#: full depth beside DRYRUN_CELLS' bf16 kimi-k2 cell, within this budget
HILLCLIMB_FP8 = ("kimi-k2-1t-a32b", "train_4k", "fp8_dispatch",
                 {"moe_dispatch_dtype": "float8_e4m3fn"})
HILLCLIMB_BUDGET_S = 90

#: the training phase (slice 10): qwen2-7b at its published widths, 12 of
#: its 28 layers, one sequence of the reference's train_4k length (4096),
#: bf16 parameters and compute, f32 AdamW state, remat, loss_chunk 512;
#: 6 steps through Trainer.run without checkpoints
TRAIN_ARCH = "qwen2-7b"
TRAIN_LAYERS = 12
TRAIN_BATCH = 1
TRAIN_STEPS = 6
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=6)
#: step 1's loss through the kernels against the same step through the
#: plain versions, relative
TRAIN_LOSS_REL_TOL = 1e-3
#: each parameter leaf's gradient through the kernels against the plain
#: path's, relative L2 (bf16).  A leaf's gradient runs back through every
#: kernel output downstream of it: 2L + 1 K5 and L K3 outputs in the
#: forward, and as many again from the remat recompute the backward is
#: evaluated at.  Each output is within SERVE_MIXER_REL_TOL (1e-2; two
#: bf16 roundings) of its plain version, independently between call sites,
#: so the bound is 1e-2 * sqrt(2 (3L + 1)) = 0.086 at L = 12, rounded up to
#: 0.1; the phase reports beside it what one bf16 ulp on every input
#: embedding does to the same gradients (the scale of bf16 rounding in this
#: random-weight model).  A dropped gradient reads 1.0.
TRAIN_GRAD_REL_TOL = 0.1
#: train_reduced: the reduced configs (f32) trained 4 steps on the card and
#: on the CPU from one initial state: each loss within 1e-3 and each grad
#: norm within 1e-3 relative (the card's kernels are within 3e-5 of their
#: plain versions, and Adam turns near-zero gradient entries' rounding into
#: steps of up to lr = 1e-3, which move the next losses by ~1e-4 at most);
#: the restart check holds the reference's own 1e-4
TRAIN_REDUCED_TOL = 1e-3
RESTART_TOL = 1e-4
#: profiler ranges the port's train step and kernel backward run in
RANGE_PREFIX = "repro_torch/"

#: slice 11, sharded execution: 4 ranks on the one card (NCCL refuses two
#: ranks on one device, so the group is gloo, which carries the card's
#: tensors through the host)
SHARDED_RANKS = 4
#: ep_moe: one MoE layer at kimi-k2-1t-a32b's published expert widths (E
#: 384, k 8, D 7168, F 2048, cf 1.25, bf16) on a data 1 x model 4 mesh, 4
#: groups of 1,024 tokens (C = ceil(1024 * 8 / 384 * 1.25) = 27), seed 0
EP_ARCH = "kimi-k2-1t-a32b"
EP_MESH = (1, 4)
EP_GROUPS, EP_TOKENS, EP_SEED = 4, 1024, 0
#: its output against the single-device moe_forward, relative L2 (bf16).
#: Both run the same products on the same bf16 operands; only their f32
#: accumulation order (cuBLAS tiling of different matrix shapes) differs,
#: ~1e-6 relative before each rounding to bf16, so a rounding flips in a
#: few elements, each by one bf16 ulp (2^-8 relative).  Four rounded
#: results can flip on the way (gate, up and down products, and the bf16
#: combine of k gated outputs): 4 * 2^-8 = 1.6e-2.  The dispatch table
#: (which assignments take which slot, which are dropped) must be equal.
EP_REL_TOL = 4 * 2.0 ** -8
#: sharded_train: qwen2-7b at published widths, 2 of its 28 layers
#: (1.56 B parameters), bf16 with f32 AdamW state, B 4, S 1024, on a data
#: 2 x model 2 mesh, 2 steps, against the single-device step from the same
#: initial parameters
SHARDED_ARCH = "qwen2-7b"
SHARDED_LAYERS = 2
SHARDED_MESH = (2, 2)
SHARDED_BATCH, SHARDED_SEQ, SHARDED_STEPS = 4, 1024, 2
SHARDED_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
#: step 1's loss, relative.  The mesh splits contractions: FSDP over
#: 'data' (d_model) and TP over 'model' (heads, d_ff, vocab); each split
#: product is a sum of bf16-rounded partials, one more rounding (2^-8
#: relative at most) than the single-device product.  About 2L * 4 + 2 =
#: 10 split products lie on a token's path; their roundings are
#: independent, so a token's loss moves by ~2^-8 * sqrt(10) relative at
#: most, and the mean over B * S = 4096 tokens by that over sqrt(4096):
#: ~1.9e-4.  Bound: 1e-3.
SHARDED_LOSS_REL_TOL = 1e-3
#: step 1's global gradient norm, relative: every gradient element carries
#: per-element perturbations of the same order (2^-8 * sqrt(20) with the
#: backward's split products, ~1.7e-2 at most), which the norm over 1.56 B
#: elements averages down; bound the reference's own sharded-execution
#: tolerance, 2e-2
SHARDED_GNORM_REL_TOL = 2e-2
# step 2's loss and grad norm are held at the same bounds: the ranks'
# AdamW writes each local shard from its gradient (elementwise, exact
# shard by shard), so the parameters entering step 2 part from the
# single-device ones only where step 1's gradients did, and most where a
# gradient element near zero flips the sign of its unit-size AdamW step:
# an element whose first-order effect on the loss is ~0
#: step 1's gradient of each leaf of at most SHARDED_LEAF_ELEMENTS elements
#: (the norms and the q / k / v biases, which the global norm cannot see
#: beside 1.56 B elements), relative L2, gathered whole on rank 0.  Each
#: element is a sum over the B * S tokens of terms that carry the
#: backward's perturbations (2^-8 * sqrt(20) at most, as for the grad
#: norm) plus one more bf16 rounding where the data shards' partial sums
#: meet: 2^-8 * sqrt(21) = 1.8e-2 at most for the leaf's RMS.  Bound 2e-2;
#: a leaf that loses a shard's share (a missing partial-sum reduction) is
#: off by ~0.7
SHARDED_LEAF_ELEMENTS = 1 << 20
SHARDED_LEAF_REL_TOL = 2e-2
#: the sharded_train step's optimizer collectives by kind and axes, as the
#: dry run's trace on the CPU counts them (torch 2.13; held there by
#: tests/test_torch_dryrun.py): the replicated parameters' gradient sums in
#: one all-reduce over 'data' (one bucket: every leaf bf16), and the global
#: norm's per-leaf square-sums in one over the whole mesh.  Each rank on
#: the card (torch 2.11) and the card's fake trace must count the same
SHARDED_OPTIMIZER_COLLECTIVES = {"all-reduce @data": 1,
                                 "all-reduce @data+model": 1}
#: slice 16's lowerings on the rig's ranks, each at its config's published
#: widths, 1 layer, bf16, one train step on a batch of B 4, S
#: LOWERING_SEQ, held to one device's step on the same card from the same
#: seed at the sharded_train bounds (one layer has fewer split products on
#: a token's path than their two), and counted by the dry run's Accounting
#: against its fake trace of the same step:
#: - falcon-mamba-7b at data 1 x model 4: in_proj's product stays on its
#:   'model' columns; the reference partitioner's four permutes a pass
#:   (forward, remat's recompute; w columns back for each in the backward)
#:   move its halves (``models.mamba._HalvesExchange``, staged through the
#:   host), and no all-gather makes the whole (B, S, 2 Di);
#: - gemma-2b at data 1 x model 4: its 8 query heads divide the axis, its
#:   one kv head does not, so q and the output stay on their heads and only
#:   k and v move (``models.transformer._kv_whole_attention``);
#: - falcon-mamba-7b at pod 2 x data 2 x model 1: the sums over ('pod',
#:   'data') run one collective over both, none one axis at a time
LOWERING_TRAIN = (("falcon-mamba-7b", (1, 4)), ("gemma-2b", (1, 4)),
                  ("falcon-mamba-7b", (2, 2, 1)))
#: their steps' sequence length, half the sharded_train step's: with the
#: in_proj halves moved as the reference moves them the whole smoke ran
#: past 700 s of its 1,200 s limit at 1024 (H100 80GB HBM3, 700 W)
LOWERING_SEQ = 512
#: and, on LOWERING_MOE_RANKS ranks of their own (the combine sums over
#: ('pod', 'data') only where 'model' shards the experts), the DTensor
#: moe_forward of one MoE layer at jamba-v0.1-52b's widths (E 16, k 2, D
#: 4096, F 14336, bf16) at pod 2 x data 2 x model 2, one group of 1,024
#: tokens a rank, 8 experts a rank, seed 0: the combine's whole-batch (8,
#: 1024, 4096) sum run as one all-reduce over 'model' (2 ranks) and one
#: over ('pod', 'data') (4 ranks), three one axis at a time before, against
#: the single-device layer at EP_REL_TOL (the same products; each rank's
#: sums add the others' zeros and one bf16 rounding of the 'model' pair)
LOWERING_MOE_ARCH, LOWERING_MOE_MESH = "jamba-v0.1-52b", (2, 2, 2)
LOWERING_MOE_RANKS = 8
LOWERING_MOE_GROUPS, LOWERING_MOE_TOKENS = 8, 1024
#: slice 17's lowerings that need more than four ranks, in the same launch
#: after the MoE layer, each held as LOWERING_TRAIN holds its cases, in the
#: dtype given:
#: - qwen2-7b at data 1 x model 8: its 28 query heads do not divide the
#:   axis, its 4 kv heads do, so each rank computes its kv group's 7 heads
#:   and keeps its own 448 columns of the output, those of wo's row shard
#:   (``models.transformer._kv_group_attention``): no reduce-scatter of a
#:   padded output; in the backward the output's gradient is gathered over
#:   the 2 ranks of a kv group and dq / dk / dv over the 4 groups, as the
#:   reference's partitioner gathers them.  In float32: in bf16 at this
#:   mesh the final norm's gradient reads 5.2e-2 from one device's (every
#:   other leaf 1.3e-2 at most; in f32 every leaf ~3e-6;
#:   tools/lowering_leaf_errors.py, H100 80GB HBM3, 700 W), and that is
#:   the reference's own lowering: its partitioned HLO all-reduces the
#:   head's input gradient, the 8 vocabulary blocks' partial sums, in bf16
#:   a loss chunk at a time, as the port does; summed so, the final norm's
#:   gradient reads 4.6e-2 from one product's at 2,048 tokens, summed in
#:   float32 1.0e-2 (tools/head_partial_sums.py;
#:   tests/test_torch_lowering_faults.py holds the port's 8 CPU ranks to
#:   it).  The bound is not raised for it;
#: - falcon-mamba-7b at pod 2 x data 2 x model 2: in_proj's halves move
#:   by the reference's permutes at M = 2; its 65,024 rows outnumber the
#:   batch's 2,048 tokens, so the tokens move, not the table, as XLA's
#:   partitioner does there (tools/embedding_layouts.py)
LOWERING_TRAIN_8 = (("qwen2-7b", (1, 8), "float32"),
                    ("falcon-mamba-7b", (2, 2, 2), "bfloat16"))
#: and in the same launch, the embedding lookup alone and its backward on
#: h2o-danube-3-4b's (32,000, 3840) bf16 table at pod 2 x data 2 x model 2,
#: B 16, in two of the three layouts the reference's partitioner gives it
#: (``parallel.act.embed_layout``, read by tools/embedding_layouts.py).
#: The batch lies on ('pod', 'data'), the table's D on 'data' alone:
#: - S 2048 (32,768 tokens): the table has fewer rows than the batch has
#:   tokens, so it moves (``parallel.act._TableToColumns``: one permute
#:   over 'data' and 'model' each way, of a rank's (V / 2, D / 2));
#: - S 2000 (32,000 tokens, as many as the table has rows): XLA gathers
#:   the table's whole rows over 'model' (``parallel.act._rows_lookup``:
#:   the row blocks gathered, the tokens permuted over 'data' and 'model',
#:   the result gathered over ('pod', 'model') and its D over 'data', the
#:   result's gradient over ('pod', 'data'), the table's all-reduced over
#:   ('pod', 'model')).
#: All staged through the host.  A train step at those 32,768 tokens took
#: 17.7 s a rank and 41 s of the launch as one more case of
#: LOWERING_TRAIN_8 (chip smoke, H100 80GB HBM3, 700 W); the lookup alone
#: 0.94-2.35 s a rank.  Each rank's output shard equals the plain lookup's,
#: its table-gradient shard within SHARDED_LEAF_REL_TOL of the plain
#: float32 gradient
TABLE_MOVE_ARCH, TABLE_MOVE_MESH = "h2o-danube-3-4b", (2, 2, 2)
TABLE_MOVE_BATCH = 16
#: (layout, S) of the lookup's cases
TABLE_MOVE_CASES = (("table", 2048), ("rows", 2000))
#: a rank's device memory budget: its allocator's reserved peak, 15.37 GB
#: (12.59 GB of it allocated by the ep_moe forward), plus its CUDA context
#: and cuBLAS workspace, ~0.6 GB, and slack; the card must have this free
#: for each of the SHARDED_RANKS ranks before they start
SHARDED_RANK_BUDGET_BYTES = 16_500_000_000
#: slice 12, the dry run: the sharded_train config traced over a fake 2 x 2
#: world on the card's device type (K3 / K4 / K5 by their dispatcher ops'
#: fake implementations), against what each real rank counts on one more,
#: untimed step.  Both runs execute the same program and are counted by the
#: same Accounting, so FLOPs agree to the launch (bound 0.5 %) and the
#: collectives exactly by kind (the staged ones counted as the collective
#: they stand in for).  The peak is a prediction: the trace's most live
#: bytes beside the arguments, against the rank's allocator peak after
#: placement, which also holds the staging's card-side copies, the caching
#: allocator's 512-byte rounding and cuBLAS's workspace (bound 15 %)
DRYRUN_FLOPS_REL_TOL = 5e-3
DRYRUN_PEAK_REL_TOL = 0.15
#: the production cells traced at their published widths and depths on the
#: card: (arch, shape, multi_pod).  In the smoke with kimi-k2 cut to 16 of
#: 61 layers, the cells traced in 6.3-10.3 s and the phase took 37.6 s;
#: kimi-k2 at ~0.3-0.4 s a layer adds ~15 s at 61, so the phase reads ~55
#: s, and a host ~1.8 times slower (as in one smoke run) still fits
DRYRUN_CELLS = (("qwen2-7b", "train_4k", False),
                ("kimi-k2-1t-a32b", "train_4k", False),
                ("falcon-mamba-7b", "decode_32k", False),
                ("jamba-v0.1-52b", "prefill_32k", True))
DRYRUN_BUDGET_S = 120
#: a cell's all-reduce GB a device that its trace must stay below: jamba's
#: 2 x 16 x 16 prefill read 426.27 with the combine summed one axis at a
#: time (three whole-batch all-reduces a MoE layer); with ('pod', 'data')
#: summed at once, two (~293 predicted from the 8-layer CPU trace)
DRYRUN_ALL_REDUCE_GB = {"jamba-v0.1-52b__prefill_32k__2x16x16": 300.0}
#: the threefry phase: the scale row's start-vector draw, (24, 65536)
THREEFRY_SHAPE = (24, 65536)

#: enough copies of a case's operands that one timed launch finds the
#: previous copies' bytes evicted from the 50 MB L2, as a Lanczos step does
#: (its reorthogonalization streams up to 91 MB between two matvecs)
COLD_BYTES = 120e6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def _graph_ms(torch, fn, arg_sets, reps: int, stream=None) -> float:
    """Per-call device time of ``fn`` over ``reps`` calls cycling through
    ``arg_sets``, captured into one CUDA graph so host launch overhead does
    not enter; median of 5 replays, timed with CUDA events.  ``stream``:
    the stream to warm up and capture on (an autograd backward must be
    captured on the stream its forward ran on)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
             extra_check=None, rel_l2_tol=None, library_stream=False,
             also_timed=None, time_plain=True) -> dict:
    """One LM kernel case: error against the plain version, then kernel /
    plain / library times (CUDA graph, cold operands) and the bound.  With
    ``rel_l2_tol`` every output is held to the plain version's by relative
    L2 instead of the allclose on the first; ``also_timed`` names more
    functions of the same arguments to time beside the kernel (another
    design of it); ``library_stream``: ``lib_args`` runs on the stream the
    library is captured on (it runs a forward whose backward is timed);
    without ``time_plain`` the plain version is the check only
    (``plain_ms`` None).  ``seconds``: the case's wall time."""
    t0 = time.perf_counter()
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    outs_k = got if isinstance(got, tuple) else (got,)
    outs_p = want if isinstance(want, tuple) else (want,)
    out_k, out_p = outs_k[0], outs_p[0]
    for a, b in zip(outs_k, outs_p, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, form
    if rel_l2_tol is None:
        err, excess = _allclose_err(torch, out_k, out_p, tol)
        if not (math.isfinite(err) and excess <= 0):
            raise AssertionError(f"{name} {form}: |kernel - plain| exceeds "
                                 f"{tol} (max abs {err}, excess {excess})")
        rels = None
    else:
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(outs_k, outs_p))
        rels = [_rel_l2(a, b) for a, b in zip(outs_k, outs_p)]
        if not all(math.isfinite(r) and r <= rel_l2_tol for r in rels):
            raise AssertionError(f"{name} {form}: relative L2 {rels} > "
                                 f"{rel_l2_tol}")
    row = dict(kernel=name, form=form, dtype=str(out_k.dtype).replace(
        "torch.", ""), shape=list(out_k.shape), max_abs_err=err,
        tol=tol if rel_l2_tol is None else None)
    if rels is not None:
        row.update(rel_l2=rels, rel_l2_tol=rel_l2_tol)
    if extra_check is not None:
        row.update(extra_check(got, want))
    copies = max(2, min(64, math.ceil(COLD_BYTES / nbytes)))
    sets = [tuple(a.clone() if hasattr(a, "clone") else a for a in args)
            for _ in range(copies)]
    row["ms"] = _graph_ms(torch, kernel, sets, max(reps, copies))
    for key, fn in (also_timed or {}).items():
        row[key] = _graph_ms(torch, fn, sets, max(reps, copies))
    pr = plain_reps or max(reps, copies)
    row["plain_ms"] = _graph_ms(
        torch, plain, sets[:max(2, min(copies, pr))], pr) if time_plain \
        else None
    row["library_ms"] = None
    if library is not None:
        stream = torch.cuda.Stream() if library_stream else None
        with torch.cuda.stream(stream):
            lib_sets = [lib_args(a) for a in sets]
        row["library_ms"] = _graph_ms(torch, library, lib_sets,
                                      max(reps, copies), stream=stream)
        del lib_sets
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=nbytes, flops=flops, cold_copies=copies)
    del sets
    row["seconds"] = time.perf_counter() - t0
    return row


def sharded_kernel_shapes() -> tuple:
    """The shapes a ``sharded_train`` rank gives K5 and K3: its data shard
    of the batch (SHARDED_BATCH / data rows of SHARDED_SEQ tokens), whole
    d_model at the norms, and its model shard of the heads at attention
    (``per_shard`` runs the kernels on batch- and head-sharded operands).
    Returns ((rows, d_model), (B, S, H, Kv, head_dim))."""
    from repro_torch.serve import serving_config

    cfg = serving_config(SHARDED_ARCH, layers=SHARDED_LAYERS)
    data, model = SHARDED_MESH
    B = SHARDED_BATCH // data
    return ((B * SHARDED_SEQ, cfg.d_model),
            (B, SHARDED_SEQ, cfg.n_heads // model, cfg.n_kv_heads // model,
             cfg.head_dim))


def lm_kernel_checks(torch, dev) -> list:
    """K5, K3 and K4 at the serving path's shapes (bf16 and f32), the
    training phases' shapes (qwen2-7b's S 4096 attention; the reduced
    configs' f32 forms; a sharded_train rank's shards) and ragged cases;
    the first row of each kernel is its serving-path case."""
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
    shard_rows, shard_attn = sharded_kernel_shapes()

    # K5: prefill rows (B*S, D), decode rows (jamba, then qwen2-7b's and
    # kimi-k2's widths, the moe_fp8 phase's), f32, ragged rows and widths,
    # the sharded_train ranks' rows
    # (the three bf16 forms of the redesign's targets also time K5's first
    # design, a warp or a block a row reading it twice, on the same inputs)
    first_design = ("prefill (4096, 4096) bf16",
                    "qwen prefill (4096, 3584) bf16",
                    f"sharded train {shard_rows} bf16")
    for form, (R, D), dt in (("prefill (4096, 4096) bf16", (4096, 4096), bf),
                             ("decode (4, 4096) bf16", (4, 4096), bf),
                             ("qwen prefill (4096, 3584) bf16", (4096, 3584),
                              bf),
                             ("qwen decode (4, 3584) bf16", (4, 3584), bf),
                             ("kimi prefill (4096, 7168) bf16", (4096, 7168),
                              bf),
                             ("kimi decode (4, 7168) bf16", (4, 7168), bf),
                             ("prefill (4096, 4096) f32", (4096, 4096), f32),
                             ("ragged rows (1001, 1024) bf16", (1001, 1024), bf),
                             ("ragged width (37, 4095) f32", (37, 4095), f32),
                             ("reduced train (128, 64) f32", (128, 64), f32),
                             (f"sharded train {shard_rows} bf16", shard_rows,
                              bf)):
        x, w = randn(R, D, dtype=dt), (randn(D) + 1).to(dt)
        es = x.element_size()
        rows.append(_lm_case(
            torch, "rmsnorm", form, K5.rmsnorm_cuda, K5.rmsnorm_ref, (x, w),
            LM_TOL[str(dt)[6:]], 2 * R * D * es + D * es, 4 * R * D,
            PEAK_FLOPS[str(dt)[6:]],
            library=lambda a, b: F.rms_norm(a, (a.shape[-1],), b, 1e-6),
            lib_args=lambda a: a,
            also_timed=({"first_design_ms": K5.block_design_cuda}
                        if form in first_design else None)))

    # K3: the serving prefill (B 4, S 1024, H 32, Kv 8, hd 128), then the
    # qwen2-7b phase's prefill (G = 7), the moe_fp8 phase's kimi-k2 prefill
    # (G = 8, hd 112: zero-filled to the compiled 128), gemma-2b's MQA hd
    # 256, an hd 64 form, the training phases' forms and a sharded_train
    # rank's: each of these holds more work tiles than the card has SMs, so
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
            ("kimi prefill causal bf16", (4, 1024, 64, 8, 112), True, bf),
            ("gemma-2b prefill causal bf16", (4, 1024, 8, 1, 256), True, bf),
            ("hd 64 non-causal bf16", (4, 1024, 16, 2, 64), False, bf),
            ("qwen train causal bf16", (1, 4096, 28, 4, 128), True, bf),
            ("reduced train causal f32", (4, 32, 4, 2, 16), True, f32),
            (f"sharded train causal bf16 {shard_attn}", shard_attn, True, bf)):
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

    # K3's backward kernel: the table form, the training phase's, a
    # sharded_train rank's, the reduced configs' f32 and a ragged MQA hd 256
    # form.  First the training forward's o and row lse against the plain
    # version's (ATTN_TOL, LSE_ABS), then dq, dk, dv against the plain
    # tile-by-tile backward from that saved forward (relative L2
    # BWD_REL_TOL), timed beside SDPA's backward at the same shape (its
    # autograd backward captured in a CUDA graph like the kernel, on the
    # backend SDPA picks: bf16 with grouped K and V (enable_gqa; cuDNN's
    # on the H100), f32 with K and V repeated to the query heads, since no
    # f32 backend but the unfused one takes groups); bound by the five
    # products' 10 hd FLOPs a computed (query, key) pair.  The plain
    # backward is timed at the table form only (the kernels line's row).
    for i, (form, (B, S, H, Kv, hd), causal, dt) in enumerate((
            ("prefill causal bf16", (4, 1024, 32, 8, 128), True, bf),
            ("qwen train causal bf16", (1, 4096, 28, 4, 128), True, bf),
            (f"sharded train causal bf16 {shard_attn}", shard_attn, True, bf),
            ("ragged S=1000 MQA hd 256 causal bf16", (2, 1000, 8, 1, 256),
             True, bf),
            ("prefill causal f32", (2, 1024, 16, 4, 128), True, f32),
            ("reduced train causal f32", (4, 32, 4, 2, 16), True, f32))):
        q, k, v, do = (randn(B, S, n, hd, dtype=dt) for n in (H, Kv, Kv, H))
        o, lse = K3.flash_attention_lse_op(q, k, v, causal)
        o_ref, lse_ref = K3.attention_lse_ref(q, k, v, causal=causal)
        o_err, o_excess = _allclose_err(torch, o, o_ref,
                                        ATTN_TOL[str(dt)[6:]])
        lse_err = float((lse.double() - lse_ref.double()).abs().max())
        if not (math.isfinite(o_err) and o_excess <= 0
                and math.isfinite(lse_err) and lse_err <= LSE_ABS):
            raise AssertionError(
                f"flash_attention_lse {form}: o max abs {o_err} (tol "
                f"{ATTN_TOL[str(dt)[6:]]}), lse max abs {lse_err} (tol "
                f"{LSE_ABS})")
        fwd_check = dict(o_max_abs_err=o_err, o_tol=ATTN_TOL[str(dt)[6:]],
                         lse_max_abs_err=lse_err, lse_tol=LSE_ABS)
        del o_ref, lse_ref
        es = q.element_size()
        G = H // Kv

        def sdpa_bwd_args(a, G=G, causal=causal, gqa=dt == bf):
            qq, kk, vv, _, _, dd = a
            r = 1 if gqa else G
            ins = [t.transpose(1, 2).repeat_interleave(n, 1).detach()
                   .contiguous().requires_grad_()
                   for t, n in ((qq, 1), (kk, r), (vv, r))]
            out = F.scaled_dot_product_attention(*ins, is_causal=causal,
                                                 enable_gqa=gqa)
            return (out, *ins, dd.transpose(1, 2).contiguous())

        rows.append(_lm_case(
            torch, "flash_attention_backward", form,
            lambda *a, causal=causal: K3.flash_attention_backward_op(
                *a, causal),
            lambda *a, causal=causal: K3.attention_backward_ref(
                *a, causal=causal),
            (q, k, v, o, lse, do), None,
            (4 * q.numel() + 4 * k.numel()) * es + lse.numel() * 4,
            10 * B * H * hd * attn_pairs(S, causal),
            TENSOR_FLOPS[str(dt)[6:]],
            library=lambda out, qq, kk, vv, dd: torch.autograd.grad(
                out, (qq, kk, vv), dd, retain_graph=True),
            lib_args=sdpa_bwd_args, reps=8, plain_reps=2,
            rel_l2_tol=BWD_REL_TOL[str(dt)[6:]], library_stream=True,
            extra_check=lambda got, want, c=fwd_check: c,
            time_plain=i == 0))
        del q, k, v, do, o, lse

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
            ("L 1 bf16", (4, 1, 8192, 16), bf, False),
            ("reduced jamba train f32", (4, 32, 128, 8), f32, False)):
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
    import types

    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import mamba_scan as K4
    from repro_torch.kernels import rmsnorm as K5
    bwd = types.SimpleNamespace(launches=K3.backward_launches,
                                reset_launches=K3.reset_backward_launches)
    return {"rmsnorm": K5, "flash_attention": K3,
            "flash_attention_backward": bwd, "mamba_scan": K4}


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

    def route(logits, k, C, E, **kw):
        out = orig(logits, k, C, E, **kw)
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
            "flash_attention": n_attn, "flash_attention_backward": 0,
            "mamba_scan": n_mamba}
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
    if "rmsnorm_" in n and "_kernel" in n:
        return "rmsnorm_ms"
    if "fa_bwd_" in n:
        return "flash_attention_backward_ms"
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
                             "flash_attention_backward_ms", "mamba_scan_ms",
                             "matmul_ms", "other_ms"), 0.0)
    kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(RANGE_PREFIX):
            continue             # (the port's profiler ranges are no kernels)
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
            "flash_attention": n_attn, "flash_attention_backward": 0,
            "mamba_scan": 0}
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


@contextlib.contextmanager
def _captured_quantize(out: dict):
    """Inside the block each ``moe.quantize_slots`` call's input slots and
    its payload and scales are kept (clones on the card) in ``out``."""
    from repro_torch.models import moe as MOE

    orig = MOE.quantize_slots

    def quantize(xe):
        q, scale = orig(xe)
        out.setdefault("calls", []).append(
            (xe.detach().clone(), q.clone(), scale.clone()))
        return q, scale

    MOE.quantize_slots = quantize
    try:
        yield out
    finally:
        MOE.quantize_slots = orig


def _event_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event ms of ``fn()`` over ``reps`` calls after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def moe_fp8_phase(torch, dev) -> dict:
    """Slice 14: kimi-k2 at its published widths, MOE_FP8_LAYERS layer,
    served through ``generate`` with the bf16 dispatch and then with the
    e4m3 dispatch on the same weights and prompts: exact K3 / K5 launch
    counts in both runs; the e4m3 run's payload and scales of group 0 of
    the prefill's slots bit for bit against the host's quantize of the same
    slots; its prefill logits within MOE_FP8_LOGITS_REL_TOL of the bf16
    run's; the dispatch bytes a layer (D + 4 a slot against 2 D) and the
    quantize's time at the prefill's slot shape."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve import generate, serving_config

    cfg16 = serving_config(MOE_FP8_ARCH, layers=MOE_FP8_LAYERS)
    cfg8 = dataclasses.replace(cfg16, moe_dispatch_dtype="float8_e4m3fn")
    D, E, k, F_ = (cfg16.d_model, cfg16.n_experts, cfg16.experts_per_token,
                   cfg16.moe_d_ff)
    assert (D, E, k, F_, cfg16.compute_dtype) == (7168, 384, 8, 2048,
                                                  "bfloat16"), cfg16
    C = MOE.capacity(MOE_FP8_PROMPT, E, k, cfg16.capacity_factor)
    n_attn = sum(s.kind == "attn" for s in cfg16.pattern) * cfg16.n_repeats
    max_len = MOE_FP8_PROMPT + MOE_FP8_NEW
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_params(cfg16, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = weight_bytes = expert_bytes = 0
    for t in _leaves(params):
        n_params += t.numel()
        weight_bytes += t.numel() * t.element_size()
        if t.dim() == 4:                        # (layers, E, D, F) experts
            expert_bytes += t.numel() * t.element_size()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg16.vocab_size,
                            (MOE_FP8_REQUESTS, MOE_FP8_PROMPT),
                            generator=gen, device=dev)
    # warm-up at the served shapes (cuBLAS picks its kernels per shape),
    # not counted
    for cfg in (cfg16, cfg8):
        generate(params, cfg, prompts, 2)
    counters = _lm_counters()
    runs, turns = {}, []
    # in turns, bf16, e4m3, e4m3, bf16: the first run of each is counted
    for name in ("bfloat16", "float8_e4m3fn", "float8_e4m3fn", "bfloat16"):
        cfg = cfg8 if name == "float8_e4m3fn" else cfg16
        for mod in counters.values():
            mod.reset_launches()
        res = generate(params, cfg, prompts, MOE_FP8_NEW)
        turns.append(dict(dispatch=name, prefill_ms=res.prefill_s * 1e3,
                          decode_ms_per_step=(res.decode_s
                                              / (MOE_FP8_NEW - 1) * 1e3)))
        if name not in runs:
            runs[name] = dict(res=res, launches={
                n: mod.launches() for n, mod in counters.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = MOE_FP8_NEW - 1
    want = {"rmsnorm": (2 * cfg16.n_layers + 1) * (1 + steps),
            "flash_attention": n_attn, "flash_attention_backward": 0,
            "mamba_scan": 0}
    for name, r in runs.items():
        assert r["launches"] == want, (name, r["launches"], want)
        lg, toks = r["res"].prefill_logits, r["res"].tokens
        assert lg.shape == (MOE_FP8_REQUESTS, cfg16.vocab_size), lg.shape
        assert torch.isfinite(lg).all(), name
        assert toks.shape == (MOE_FP8_REQUESTS, MOE_FP8_NEW), toks.shape
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg16.vocab_size
    rel = _rel_l2(runs["float8_e4m3fn"]["res"].prefill_logits,
                  runs["bfloat16"]["res"].prefill_logits)
    assert rel <= MOE_FP8_LOGITS_REL_TOL, (rel, MOE_FP8_LOGITS_REL_TOL)

    # the prefill's slots once more, untimed, with the quantize's operands
    # kept: group 0's payload and scales against the host's quantize
    seen = {}
    with _captured_quantize(seen), torch.no_grad():
        again, _ = M.prefill(params, {"tokens": prompts}, cfg8, max_len)
    (xe, q, scale), = seen["calls"]
    assert xe.shape == (MOE_FP8_REQUESTS, E, C, D), xe.shape
    assert q.dtype == torch.float8_e4m3fn and scale.shape == (
        MOE_FP8_REQUESTS, E, C, 1)
    q_h, s_h = MOE.quantize_slots(xe[0].cpu())
    payload_differ = int((q[0].cpu().view(torch.uint8)
                          != q_h.view(torch.uint8)).sum())
    scale_differ = int((scale[0].cpu().view(torch.int32)
                        != s_h.view(torch.int32)).sum())
    assert payload_differ == 0 and scale_differ == 0, (payload_differ,
                                                       scale_differ)
    filled = int((scale[..., 0] > 1e-12).sum())
    slots = MOE_FP8_REQUESTS * E * C
    fp8_bytes = q.numel() * q.element_size() + scale.numel() * 4
    bf16_bytes = xe.numel() * xe.element_size()
    assert fp8_bytes == slots * (D + 4) and bf16_bytes == slots * 2 * D
    quantize_ms = _event_ms(torch, lambda: MOE.quantize_slots(xe),
                            MOE_FP8_QUANTIZE_REPS)
    dequantize_ms = _event_ms(
        torch, lambda: MOE.dequantize_slots(q, scale, xe.dtype),
        MOE_FP8_QUANTIZE_REPS)
    r16, r8 = (runs[n]["res"] for n in ("bfloat16", "float8_e4m3fn"))
    del params, seen, xe, q, scale, again
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        arch=MOE_FP8_ARCH, n_layers=cfg16.n_layers,
        reduced=[f"layers {cfg16.n_layers} of "
                 f"{get_config(MOE_FP8_ARCH).n_layers}: the whole model "
                 "(~1 T parameters) does not fit one 80 GB card"],
        params=n_params, weight_bytes=weight_bytes,
        expert_weight_bytes=expert_bytes,
        d_model=D, experts=E, k=k, d_ff=F_, capacity=C, seed=0,
        init_seconds=init_s, requests=MOE_FP8_REQUESTS,
        prompt_len=MOE_FP8_PROMPT, max_new=MOE_FP8_NEW,
        prefill_ms={n: sum(t["prefill_ms"] for t in turns
                           if t["dispatch"] == n) / 2 for n in runs},
        decode_ms_per_step={n: sum(t["decode_ms_per_step"] for t in turns
                                   if t["dispatch"] == n) / 2 for n in runs},
        turns=turns,
        peak_memory_gb=peak_gb,
        launches={n: r["launches"] for n, r in runs.items()},
        launches_expected=want,
        slots_per_layer=slots, filled_slots=filled,
        dispatch_bytes_per_layer={"bfloat16": bf16_bytes,
                                  "float8_e4m3fn": fp8_bytes},
        dispatch_bytes_per_slot={"bfloat16": 2 * D,
                                 "float8_e4m3fn": D + 4},
        payload_bits_differ=payload_differ, scale_bits_differ=scale_differ,
        payload_checked_elements=E * C * D,
        quantize_ms=quantize_ms, dequantize_ms=dequantize_ms,
        logits_rel_l2_fp8_vs_bf16=rel, logits_rel_tol=MOE_FP8_LOGITS_REL_TOL,
        first_token_agree=int((r8.tokens[:, 0] == r16.tokens[:, 0]).sum()),
        tokens_head={"bfloat16": r16.tokens.tolist(),
                     "float8_e4m3fn": r8.tokens.tolist()})


@contextlib.contextmanager
def _recorded_categorical(out: list):
    """Inside the block each ``threefry.categorical`` call's key, logits
    (on the host) and samples are kept in ``out``."""
    from repro_torch.core import threefry as TF

    orig = TF.categorical

    def categorical(key, logits):
        tok = orig(key, logits)
        out.append((key, logits.cpu().numpy(), tok.cpu().numpy()))
        return tok

    TF.categorical = categorical
    try:
        yield out
    finally:
        TF.categorical = orig


def vl_phase(torch, np, dev) -> dict:
    """Slice 14: qwen2-vl-7b at its published widths and depth through
    ``generate``, its vision stub fed the serving example's embeddings
    (``normal(PRNGKey(0), (B, S, D))``, each decode step
    ``normal(fold_in(key, i), (B, D))``), greedy and then sampled at
    VL_TEMPERATURE: exact K3 / K5 launch counts; the first token the
    prefill's argmax in both; then the sampled run once more, untimed,
    recording each step's logits: its tokens equal the timed run's, and in
    VL_HOST_CHECKED_STEPS and the last step the Gumbel draws on the card
    equal the host's bit for bit and each sample equals the host's
    categorical of the same logits."""
    from repro_torch.core import threefry as TF
    from repro_torch.models import model as M
    from repro_torch.serve import (SAMPLE_FOLD, generate, serving_config,
                                   serving_prompts)

    cfg = serving_config(VL_ARCH)
    assert cfg.n_layers == VL_LAYERS and cfg.frontend == "vision_stub", cfg
    assert cfg.mrope_sections is not None, cfg
    n_attn = sum(s.kind == "attn" for s in cfg.pattern) * cfg.n_repeats
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    key = TF.prng_key(0)
    prompts = serving_prompts(cfg, VL_REQUESTS, VL_PROMPT, key, dev)
    assert prompts.shape == (VL_REQUESTS, VL_PROMPT, cfg.d_model)
    generate(params, cfg, prompts[:, :64], 2, temperature=VL_TEMPERATURE,
             key=key)                           # warm-up, not counted
    counters = _lm_counters()
    runs = {}
    for name, temp in (("greedy", 0.0), ("sampled", VL_TEMPERATURE)):
        for mod in counters.values():
            mod.reset_launches()
        res = generate(params, cfg, prompts, VL_NEW, temperature=temp,
                       key=key)
        runs[name] = dict(res=res, launches={n: mod.launches() for n, mod
                                             in counters.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = VL_NEW - 1
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * (1 + steps),
            "flash_attention": n_attn, "flash_attention_backward": 0,
            "mamba_scan": 0}
    for name, r in runs.items():
        assert r["launches"] == want, (name, r["launches"], want)
        toks, lg = r["res"].tokens, r["res"].prefill_logits
        assert torch.isfinite(lg).all(), name
        assert toks.shape == (VL_REQUESTS, VL_NEW), toks.shape
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    greedy, sampled = runs["greedy"]["res"], runs["sampled"]["res"]
    assert torch.equal(greedy.tokens[:, 0], sampled.tokens[:, 0])
    recorded = []
    with _recorded_categorical(recorded):
        again = generate(params, cfg, prompts, VL_NEW,
                         temperature=VL_TEMPERATURE, key=key)
    assert torch.equal(again.tokens, sampled.tokens)
    assert len(recorded) == steps, len(recorded)
    draws_differ = samples_differ = 0
    t0 = time.time()
    for i, (k_i, logits, tok) in enumerate(recorded):
        assert np.array_equal(k_i, TF.fold_in(key, SAMPLE_FOLD + i))
        if i not in VL_HOST_CHECKED_STEPS and i != steps - 1:
            continue
        g_card = TF.gumbel(k_i, logits.shape, dev).cpu().numpy()
        g_host = TF.gumbel_host(k_i, logits.shape)
        draws_differ += int((g_card.view(np.uint32)
                             != g_host.view(np.uint32)).sum())
        samples_differ += int((TF.categorical_host(k_i, logits)
                               != tok).sum())
    host_check_s = time.time() - t0
    checked = len({*VL_HOST_CHECKED_STEPS, steps - 1})
    assert draws_differ == 0 and samples_differ == 0, (draws_differ,
                                                       samples_differ)
    del params, prompts, recorded
    gc.collect()
    torch.cuda.empty_cache()
    row = dict(arch=VL_ARCH, n_layers=cfg.n_layers, reduced=[],
               frontend=cfg.frontend, params=n_params,
               dtype=cfg.compute_dtype, seed=0, init_seconds=init_s,
               requests=VL_REQUESTS, prompt_len=VL_PROMPT, max_new=VL_NEW,
               temperature=VL_TEMPERATURE, peak_memory_gb=peak_gb,
               launches={n: r["launches"] for n, r in runs.items()},
               launches_expected=want,
               host_checked_steps=sorted({*VL_HOST_CHECKED_STEPS,
                                          steps - 1}),
               draws_checked=checked * VL_REQUESTS * cfg.vocab_size,
               draws_bits_differ=draws_differ,
               samples_checked=checked * VL_REQUESTS,
               samples_differ=samples_differ,
               host_check_seconds=host_check_s,
               tokens_differ_greedy_vs_sampled=int(
                   (greedy.tokens != sampled.tokens).sum()))
    for name, r in runs.items():
        res = r["res"]
        row[name] = dict(
            prefill_ms=res.prefill_s * 1e3,
            prefill_tokens_per_s=VL_REQUESTS * VL_PROMPT / res.prefill_s,
            decode_ms_per_step=res.decode_s / steps * 1e3,
            decode_tokens_per_s=VL_REQUESTS * steps / res.decode_s,
            tokens=res.tokens.tolist())
    return row


def hillclimb_phase(torch, dev, smi: str, dry: dict) -> dict:
    """Slice 14: ``python -m repro_torch.launch.hillclimb``'s
    HILLCLIMB_FP8 variant on the card's device type (fake tensors, no card
    memory), its artifact read back, beside the dry run's bf16 cell of the
    same arch and shape: per-device FLOPs, all-to-all and other collective
    bytes, HBM bytes and peak."""
    from repro_torch.launch import hillclimb
    from repro_torch.launch.dryrun import cell_tag

    arch, shape, variant, overrides = HILLCLIMB_FP8
    out = ROOT / "build" / "hillclimb"
    t0 = time.time()
    line = hillclimb.main(["--arch", arch, "--shape", shape, "--variant",
                           variant, "--overrides", json.dumps(overrides),
                           "--out", str(out), "--device", str(dev.type)])
    seconds = time.time() - t0
    tag = cell_tag(arch, shape, False)
    got = json.loads((out / f"{tag}__{variant}.json").read_text())
    assert got["device"] == "cuda" and got["overrides"] == overrides, got
    base = next(c for c in dry["cells"] if c["tag"] == tag)

    def gb(res):
        return {k: v / 1e9 for k, v in
                res["collectives"]["bytes_by_kind"].items()}

    fp8 = dict(flops_per_device=got["cost"]["flops_per_device"],
               bytes_per_device=got["cost"]["bytes_per_device"],
               collective_gb_by_kind=gb(got),
               peak_gb=got["memory"]["peak_bytes"] / 1e9,
               trace_seconds=got["compile_seconds"])
    bf16 = dict(flops_per_device=base["flops_per_device"],
                bytes_per_device=base["bytes_per_device"],
                collective_gb_by_kind={
                    k: base["collective_gb_by_kind"].get(k, 0.0)
                    for k in fp8["collective_gb_by_kind"]},
                peak_gb=base["peak_gb"], trace_seconds=base["trace_seconds"])
    assert fp8["flops_per_device"] == bf16["flops_per_device"], (fp8, bf16)
    # the slots never cross ranks (each gathers and quantizes its own
    # experts' slots), so the dispatch's dtype moves no collective
    assert fp8["collective_gb_by_kind"] == bf16["collective_gb_by_kind"], (
        fp8, bf16)
    assert seconds <= HILLCLIMB_BUDGET_S, seconds
    print(f"hillclimb {tag} {variant}: {fp8['flops_per_device']:.4e} FLOPs "
          f"a device; collectives "
          f"{ {k: round(v, 3) for k, v in fp8['collective_gb_by_kind'].items() if v} } "
          f"GB (bf16 cell "
          f"{ {k: round(v, 3) for k, v in bf16['collective_gb_by_kind'].items() if v} }); "
          f"HBM {fp8['bytes_per_device']:.4e} bytes (bf16 "
          f"{bf16['bytes_per_device']:.4e}); peak {fp8['peak_gb']:.2f} GB "
          f"(bf16 {bf16['peak_gb']:.2f}); traced in "
          f"{fp8['trace_seconds']:.1f} s ({smi})", flush=True)
    return dict(tag=tag, variant=variant, overrides=overrides, line=line,
                n_layers=base["n_layers"], fp8=fp8, bf16=bf16,
                seconds=seconds, budget_seconds=HILLCLIMB_BUDGET_S)


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
              "flash_attention_backward": n_attn,
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
# phase 10c-d: LM training (slice 10)
# --------------------------------------------------------------------------

def train_launches_per_step(cfg) -> dict:
    """K5, K3 and K4 launches of one train step, derived from the config:
    K5 for every norm1 / norm2 and the final norm, K3 for every attention
    layer without a window, K4 for every Mamba layer; with ``cfg.remat``
    the backward's recompute launches each block's kernels again (the final
    norm is outside the checkpointed repeats); K3's backward kernel once
    for every K3 layer."""
    from repro_torch.models import model as M

    R = cfg.n_repeats
    blocks = M.param_shapes(cfg)["blocks"]
    norms = R * sum(("norm1" in b) + ("norm2" in b) for b in blocks)
    attn = R * sum(s.kind == "attn" and s.window is None for s in cfg.pattern)
    mamba = R * sum(s.kind == "mamba" for s in cfg.pattern)
    again = 2 if cfg.remat else 1
    return {"rmsnorm": norms * again + 1, "flash_attention": attn * again,
            "flash_attention_backward": attn, "mamba_scan": mamba * again}


def train_model_flops(cfg, B: int, S: int) -> float:
    """Model FLOPs of one train step of a dense attention config (remat's
    recompute not counted): 6 * tokens * the matrix-product parameters
    (projections, MLP, head; the embedding is a gather), plus causal
    attention's 4 * B * H * hd * S (S + 1) / 2 a layer forward, times 3 for
    forward and backward."""
    assert all(s.kind == "attn" and not s.moe for s in cfg.pattern), cfg.name
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = D * (H + 2 * Kv) * hd + H * hd * D + 3 * D * cfg.d_ff
    mm = cfg.n_layers * per_layer + D * cfg.vocab_size
    pairs = S * (S + 1) // 2 if cfg.causal else S * S
    return 6.0 * B * S * mm + 3 * 4.0 * B * H * hd * pairs * cfg.n_layers


def _leaf_paths(tree, prefix=""):
    """Leaf paths in ``repro_torch.tree`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}/{i}")
    else:
        yield prefix.lstrip("/")


def _rel32(a, b) -> float:
    """Relative L2 of ``a`` to ``b``, in f32 (full-width leaves are too
    large to double)."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _range_classes(e, out: dict) -> None:
    """Add the device ms of every kernel launched under profiler event
    ``e`` (its CPU descendants), by kernel class, to ``out``."""
    for k in getattr(e, "kernels", ()):
        key = _classify_kernel(k.name)
        out[key] = out.get(key, 0.0) + k.duration / 1e3
    for c in e.cpu_children:
        _range_classes(c, out)


def _train_split(torch, fn) -> tuple:
    """``fn()`` (one train step) under torch.profiler: device ms by kernel
    class, the step's forward / backward / optimizer device ms (the port's
    ``repro_torch/train_step/*`` ranges; the backward runs on autograd's
    device thread, so it is the busy time the other two leave), the
    stop-gap backward's device ms per kernel (``repro_torch/plain_backward/
    *`` ranges) with its own class split, the backward kernels' device ms
    (``repro_torch/kernel_backward/*``: K3's attention backward), and the
    idle share of the host-clock wall.  ``not measured`` where the trace shows no device
    time."""
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
                             "flash_attention_backward_ms", "mamba_scan_ms",
                             "matmul_ms", "other_ms"), 0.0)
    ranges, inside, kernels = {}, {}, 0
    for e in prof.events():
        if e.name.startswith(RANGE_PREFIX):
            if e.device_type == DeviceType.CPU:
                key = e.name[len(RANGE_PREFIX):]
                ranges[key] = ranges.get(key, 0.0) + e.device_time_total / 1e3
                if key.startswith(("plain_backward/", "kernel_backward/")):
                    _range_classes(e, inside.setdefault(key, {}))
            continue             # the ranges' own device-side annotations
        if e.device_type != DeviceType.CUDA:
            continue
        kernels += 1
        classes[_classify_kernel(e.name)] += e.device_time_total / 1e3
    busy = sum(classes.values())
    row = dict(wall_ms=wall * 1e3, device_kernels=kernels)
    if busy <= 0:
        row.update({k: "not measured" for k in classes},
                   device_busy_ms="not measured",
                   device_idle_share="not measured")
        return out, row
    fwd = ranges.get("train_step/forward")
    opt = ranges.get("train_step/optimizer")
    row.update(classes, device_busy_ms=busy,
               device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
               shares={k[:-3]: v / busy for k, v in classes.items()},
               forward_ms=fwd if fwd else "not measured",
               optimizer_ms=opt if opt else "not measured",
               backward_ms=(busy - fwd - opt) if fwd and opt
               else "not measured",
               plain_backward_ms={k.split("/", 1)[1]: v
                                  for k, v in ranges.items()
                                  if k.startswith("plain_backward/")},
               plain_backward_classes={k.split("/", 1)[1]: v
                                       for k, v in inside.items()
                                       if k.startswith("plain_backward/")},
               kernel_backward_ms={k.split("/", 1)[1]: v
                                   for k, v in ranges.items()
                                   if k.startswith("kernel_backward/")},
               kernel_backward_classes={k.split("/", 1)[1]: v
                                        for k, v in inside.items()
                                        if k.startswith("kernel_backward/")})
    pb = sum(row["plain_backward_ms"].values())
    row["plain_backward_share"] = pb / busy
    return out, row


def train_phase(torch, dev) -> dict:
    """qwen2-7b at its published widths, TRAIN_LAYERS of its 28 layers, one
    4096-token sequence, bf16 with f32 AdamW state and remat, trained
    TRAIN_STEPS steps through ``Trainer.run``.  Before it, step 1's loss and
    every leaf's gradient through the kernels are held against the same
    step through the plain versions (and one bf16 ulp on the input
    embeddings is measured beside them); the run's K5 / K3 launches must
    equal the config's count; then one profiled step."""
    from repro_torch import tree as TR
    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serve import serving_config

    cfg = serving_config(TRAIN_ARCH, layers=TRAIN_LAYERS)
    S = SHAPES["train_4k"].seq_len
    assert (cfg.remat, cfg.loss_chunk, cfg.param_dtype, cfg.compute_dtype) \
        == (True, 512, "bfloat16", "bfloat16"), cfg
    per_step = train_launches_per_step(cfg)
    data = DataConfig(global_batch=TRAIN_BATCH, seq_len=S,
                      vocab_size=cfg.vocab_size, seed=0)
    counters = _lm_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- step 1 through the kernels against the plain versions ----------
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in TR.leaves(params))
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in synthetic_batch(data, 0).items()}
    flat, names = TR.leaves(params), list(_leaf_paths(params))

    def grads(b):
        for p in flat:
            p.requires_grad_(True)
        try:
            total, m = M.loss_fn(params, b, cfg)
            g = torch.autograd.grad(total, flat, allow_unused=True)
        finally:
            for p in flat:
                p.requires_grad_(False)
        return float(m["loss"].detach()), g

    for mod in counters.values():
        mod.reset_launches()
    loss_k, g_k = grads(batch)
    check_launches = {n: mod.launches() for n, mod in counters.items()}
    assert check_launches == per_step, (check_launches, per_step)
    with _plain_kernels():
        loss_p, g_p = grads(batch)
    leaves = {}
    for name, a, b in zip(names, g_k, g_p):
        assert a is not None and torch.isfinite(a).all(), name
        leaves[name] = dict(rel_l2=_rel32(a, b),
                            plain_norm=float(b.float().norm()))
    del g_k
    x = M._embed_in(params, batch, cfg).detach()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    sign = torch.randint(0, 2, x.shape, generator=gen, device=dev) * 2 - 1
    x_ulp = (x.float() * (1 + sign * 2.0 ** -8)).to(x.dtype)
    del x, sign
    with _plain_kernels():
        loss_u, g_u = grads({"embeds": x_ulp, "labels": batch["labels"]})
    for name, a, b in zip(names, g_u, g_p):
        leaves[name]["one_ulp_input_rel_l2"] = (None if a is None
                                                else _rel32(a, b))
    del g_u, g_p, x_ulp, flat, params
    torch.cuda.synchronize()
    check_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    check_s = time.time() - t0
    loss_rel = abs(loss_k / loss_p - 1)
    worst = max(leaves, key=lambda n: leaves[n]["rel_l2"])
    ulps = [v["one_ulp_input_rel_l2"] for v in leaves.values()
            if v["one_ulp_input_rel_l2"] is not None]
    assert loss_rel <= TRAIN_LOSS_REL_TOL, (loss_k, loss_p)
    for name, v in leaves.items():
        assert v["plain_norm"] > 0, (name, "plain gradient is zero")
        assert v["rel_l2"] <= TRAIN_GRAD_REL_TOL, (name, v)

    # -- the trainer: TRAIN_STEPS steps through Trainer.run -------------
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, AdamWConfig(**TRAIN_OPT), data,
                 TrainerConfig(total_steps=TRAIN_STEPS, ckpt_dir=None,
                               seed=0), device=dev)
    t0 = time.time()
    tr.init_or_restore()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    for mod in counters.values():
        mod.reset_launches()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        tr.run(steps=1)             # float() of each metric waits for the card
        step_s.append(time.perf_counter() - t)
    launches = {n: mod.launches() for n, mod in counters.items()}
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    assert launches == want, (launches, want)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = list(tr.history)
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    assert all(math.isfinite(v) for v in losses + gnorms), hist
    assert abs(losses[0] - math.log(cfg.vocab_size)) < 2.0, losses
    assert losses[-1] < losses[0] + 1.0, losses
    steady = sorted(step_s[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    flops = train_model_flops(cfg, TRAIN_BATCH, S)
    _, split = _train_split(torch, lambda: tr.run(steps=1))
    del tr
    torch.cuda.empty_cache()
    return dict(
        arch=TRAIN_ARCH, config=cfg.name, n_layers=cfg.n_layers,
        reduced=[f"layers {cfg.n_layers} of {QWEN_LAYERS}",
                 f"global batch {SHAPES['train_4k'].global_batch} -> "
                 f"{TRAIN_BATCH} sequence"],
        params=n_params, dtype=cfg.compute_dtype, seq=S, batch=TRAIN_BATCH,
        remat=cfg.remat, loss_chunk=cfg.loss_chunk, opt=TRAIN_OPT,
        seed=0, check_seconds=check_s, check_peak_memory_gb=check_peak_gb,
        step1_loss_kernels=loss_k, step1_loss_plain=loss_p,
        step1_loss_rel=loss_rel, loss_rel_tol=TRAIN_LOSS_REL_TOL,
        one_ulp_input_loss=loss_u,
        grad_rel_tol=TRAIN_GRAD_REL_TOL, worst_leaf=worst,
        worst_grad_rel_l2=leaves[worst]["rel_l2"],
        one_ulp_input_grad_rel_l2_max=max(ulps),
        one_ulp_input_grad_rel_l2_median=sorted(ulps)[len(ulps) // 2],
        leaves=leaves, init_seconds=init_s,
        losses=losses, grad_norms=gnorms, lrs=[h["lr"] for h in hist],
        trainer_step1_vs_check=losses[0] - loss_k,
        step_seconds=step_s, step_ms=step_ms,
        step_ms_note=f"median of steps 2-{TRAIN_STEPS}",
        tokens_per_s=TRAIN_BATCH * S / (step_ms / 1e3),
        model_flops=flops, mfu=flops / (step_ms / 1e3)
        / TENSOR_FLOPS["bfloat16"],
        mfu_peak="989 TFLOP/s bf16 (H100 SXM data sheet)",
        peak_memory_gb=peak_gb, launches=launches,
        launches_expected=want, launches_per_step=per_step,
        profiled_step=split)


def train_reduced_phase(torch, dev) -> dict:
    """Small training runs in f32: the reduced jamba-v0.1-52b (attention,
    Mamba and MoE: K5, K3, K4) and the reduced qwen2-7b, 4 steps each with
    ``Trainer`` on the card and on the CPU from one initial state (the CPU
    trainer's, carried by a step-0 checkpoint); one profiled card step of
    the jamba (K4's plain backward); the restart check of the reference's
    tests/test_runtime.py on the card; and 6 steps with int8 gradient
    compression.  Counts the card runs' kernel launches."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serve import serving_config

    counters = _lm_counters()
    total = dict.fromkeys(counters, 0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def trainer(cfg, sub, device, ckpt_every=100, **kw):
        return Trainer(cfg, opt, DataConfig(4, 32, cfg.vocab_size),
                       TrainerConfig(ckpt_every=ckpt_every,
                                     ckpt_dir=os.path.join(tmp, sub), **kw),
                       device=device)

    def counted(tr, steps):
        for mod in counters.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        hist = [dict(h) for h in tr.run(steps=steps)[-steps:]]
        secs = time.perf_counter() - t0
        got = {n: mod.launches() for n, mod in counters.items()}
        for n, v in got.items():
            total[n] += v
        return hist, got, secs

    out = {}
    try:
        for arch in ("jamba-v0.1-52b", "qwen2-7b"):
            cfg = serving_config(arch, use_reduced=True)
            cpu = trainer(cfg, arch, "cpu")
            cpu.init_or_restore()
            cpu.save()                          # the shared step-0 state
            card = trainer(cfg, arch, dev)
            assert card.init_or_restore() == 0
            h_card, got, card_s = counted(card, 4)
            want = {k: 4 * v for k, v in train_launches_per_step(cfg).items()}
            assert got == want, (arch, got, want)
            t0 = time.perf_counter()
            h_cpu = cpu.run(steps=4)
            cpu_s = time.perf_counter() - t0
            loss_gap = max(abs(a["loss"] - b["loss"])
                           for a, b in zip(h_card, h_cpu))
            gn_gap = max(abs(a["grad_norm"] / b["grad_norm"] - 1)
                         for a, b in zip(h_card, h_cpu))
            assert all(math.isfinite(h["loss"]) for h in h_card), h_card
            assert loss_gap <= TRAIN_REDUCED_TOL, (arch, h_card, h_cpu)
            assert gn_gap <= TRAIN_REDUCED_TOL, (arch, h_card, h_cpu)
            row = dict(config=cfg.name, launches=got, card_seconds=card_s,
                       cpu_seconds=cpu_s, loss_max_abs_gap=loss_gap,
                       grad_norm_max_rel_gap=gn_gap, tol=TRAIN_REDUCED_TOL,
                       card_losses=[h["loss"] for h in h_card],
                       cpu_losses=[h["loss"] for h in h_cpu])
            if arch == "jamba-v0.1-52b":
                for mod in counters.values():
                    mod.reset_launches()
                _, row["profiled_step"] = _train_split(
                    torch, lambda: card.run(steps=1))
                for n, mod in counters.items():
                    total[n] += mod.launches()
            out[arch] = row

        tiny = reduced(get_config("qwen2-7b"), repeats=1)
        straight = trainer(tiny, "straight", dev, ckpt_every=4)
        straight.init_or_restore()
        h1, _, _ = counted(straight, 8)
        first = trainer(tiny, "restart", dev, ckpt_every=4)
        first.init_or_restore()
        counted(first, 4)
        again = trainer(tiny, "restart", dev, ckpt_every=4)
        resumed = again.init_or_restore()
        assert resumed == 4, resumed
        h3, _, _ = counted(again, 4)
        gap = max(abs(a["loss"] - b["loss"]) for a, b in zip(h3, h1[4:]))
        assert gap <= RESTART_TOL, (h1, h3)
        out["restart"] = dict(config=tiny.name, resumed_at=resumed,
                              loss_max_abs_gap=gap, tol=RESTART_TOL,
                              straight_losses=[h["loss"] for h in h1],
                              resumed_losses=[h["loss"] for h in h3])

        comp = trainer(tiny, "compress", dev, grad_compression=True)
        comp.init_or_restore()
        hc, _, _ = counted(comp, 6)
        losses = [h["loss"] for h in hc]
        assert all(math.isfinite(v) for v in losses), losses
        assert losses[-1] < losses[0] + 1.0, losses
        out["compress_grads"] = dict(config=tiny.name, losses=losses,
                                     grad_norms=[h["grad_norm"] for h in hc])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = total
    return out


# --------------------------------------------------------------------------
# phase 7: where a Lanczos solve's device time goes
# --------------------------------------------------------------------------

def threefry_bits(torch, np, dev) -> dict:
    """The scale row's start-vector draw (THREEFRY_SHAPE) made by torch ops
    on the card (``threefry.normal``) against the host's numpy draw
    (``threefry.normal_host``, the plain version): bit for bit, for two
    keys; and the times of each."""
    from repro_torch.core import threefry as TF

    keys = [TF.prng_key(0), TF.split(0)[1]]
    out = dict(shape=list(THREEFRY_SHAPE), keys=[k.tolist() for k in keys])
    card_s, host_s = [], []
    for key in keys:
        TF.normal(key, (8, 8), dev)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = TF.normal(key, THREEFRY_SHAPE, dev)
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = TF.normal_host(key, THREEFRY_SHAPE)
        host_s.append(time.perf_counter() - t0)
        got = got.cpu().numpy()
        assert got.dtype == want.dtype == np.float32
        differ = int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
        assert differ == 0, (key.tolist(), differ)
    out.update(bits_differ=0, card_seconds=card_s, host_numpy_seconds=host_s)
    return out


def quickstart_phase() -> dict:
    """``repro_torch.quickstart.main(device="cuda")``'s printed figures
    held to the host run's (``device="cpu"``), number for number."""
    import io

    from repro_torch import quickstart as Q

    texts = {}
    seconds = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            Q.main(device=device)
        seconds[device] = time.time() - t0
        texts[device] = buf.getvalue()
    figures = re.findall(r"-?\d+(?:\.\d+)?", texts["cuda"])
    assert figures == re.findall(r"-?\d+(?:\.\d+)?", texts["cpu"]), texts
    assert "Ramanujan: True" in texts["cuda"], texts["cuda"]
    return dict(figures=len(figures), seconds=seconds,
                lines=texts["cuda"].splitlines())


def _ep_single(torch, np, dev) -> tuple:
    """kimi-k2's expert widths, one MoE layer, all 384 experts on the card:
    the single-device ``moe_forward`` and its dispatch table (run first
    and freed: 33.8 GB of experts beside four ranks' shards would not
    fit); and the same layer's forward with the e4m3 dispatch."""
    import dataclasses

    from repro_torch.models.moe import _route_group, capacity, moe_forward
    from repro_torch.parallel.ranks import moe_inputs
    from repro_torch.serve import serving_config

    cfg = serving_config(EP_ARCH, layers=1)
    E, k, D, F_ = cfg.n_experts, cfg.experts_per_token, cfg.d_model, \
        cfg.moe_d_ff
    assert (E, k, D, F_, cfg.capacity_factor, cfg.compute_dtype) == \
        (384, 8, 7168, 2048, 1.25, "bfloat16"), cfg
    C = capacity(EP_TOKENS, E, k, cfg.capacity_factor)
    assert C == 27, C
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    inp = moe_inputs(cfg, EP_GROUPS, EP_TOKENS, EP_SEED, dev)
    expert_bytes = sum(inp[n].numel() * inp[n].element_size()
                       for n in ("wg", "wu", "wd"))
    x = inp.pop("x")
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_one, _ = moe_forward(inp, x, cfg)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t1) * 1e3
        logits = x @ inp["router"].to(x.dtype)
        dispatch_one = _route_group(logits, k, C, E)[0]
        # the same layer with the e4m3 dispatch (slice 14)
        y_fp8, _ = moe_forward(inp, x, dataclasses.replace(
            cfg, moe_dispatch_dtype="float8_e4m3fn"))
    single = dict(y=y_one.float().cpu().numpy(),
                  y_fp8=y_fp8.float().cpu().numpy(),
                  dispatch=dispatch_one.cpu().numpy(),
                  forward_ms=single_ms, expert_bytes=expert_bytes,
                  peak=torch.cuda.max_memory_allocated())
    del inp, x, logits, y_one, y_fp8, dispatch_one
    gc.collect()
    torch.cuda.empty_cache()
    single["seconds"] = time.time() - t0
    return cfg, C, single


def _ep_check(torch, np, cfg, C, single, ranks) -> dict:
    """The EP layer's rank results against the single-device layer: equal
    dispatch tables, outputs within EP_REL_TOL, two all-to-alls a rank of
    the rank's padded slots."""
    E, k, D = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    y_ep, dispatch_ep = ranks[0]["y"], ranks[0]["dispatch"]
    dispatch_one = single["dispatch"]
    assert dispatch_ep.shape == dispatch_one.shape == (EP_GROUPS, E, C)
    dispatch_differ = int(np.sum(dispatch_ep != dispatch_one))
    assert dispatch_differ == 0, dispatch_differ
    rel = _rel_l2(torch.from_numpy(y_ep), torch.from_numpy(single["y"]))
    assert np.all(np.isfinite(y_ep)) and rel <= EP_REL_TOL, rel
    dropped = EP_GROUPS * EP_TOKENS * k - int(np.sum(dispatch_one
                                                     < EP_TOKENS * k))
    exchange_bytes = EP_GROUPS * E * C * D * 2      # a rank's slots, bf16
    for r in ranks:
        assert r["all_to_all"] == 2, r["all_to_all"]
        assert r["all_to_all_bytes"] == 2 * exchange_bytes, r
    return dict(arch=EP_ARCH, experts=E, k=k, d_model=D, d_ff=cfg.moe_d_ff,
                capacity=C, groups=EP_GROUPS, tokens=EP_TOKENS,
                mesh=dict(data=EP_MESH[0], model=EP_MESH[1]),
                expert_weight_bytes=single["expert_bytes"],
                expert_weight_bytes_per_rank=(single["expert_bytes"]
                                              // EP_MESH[1]),
                slots=EP_GROUPS * E * C, assignments_dropped=dropped,
                dispatch_differ=dispatch_differ, rel_l2_vs_single=rel,
                tol=EP_REL_TOL, all_to_all_per_rank=2,
                all_to_all_bytes_per_rank=[r["all_to_all_bytes"]
                                           for r in ranks],
                forward_seconds_per_rank=[r["seconds"] for r in ranks],
                peak_memory_bytes_per_rank=[r["peak_memory_bytes"]
                                            for r in ranks],
                peak_reserved_bytes_per_rank=[r["peak_reserved_bytes"]
                                              for r in ranks],
                single_forward_ms=single["forward_ms"],
                single_peak_memory_bytes=single["peak"],
                single_seconds=single["seconds"])


def _dispatch_check(torch, np, cfg, C, single, ranks) -> dict:
    """The DTensor ``moe_forward`` on the EP mesh (groups on every rank)
    against the single-device layer, with the bf16 and with the e4m3
    dispatch: equal dispatch tables, outputs within EP_REL_TOL; the bytes
    of the staged all-to-alls that carry the dispatch (the slots' local
    shape before the exchange holds all E experts), a rank, beside the
    bf16 dispatch's; each rank's staged collectives by kind, none of them
    an all-gather of slots (the combine scatters each rank's own experts'
    slots and sums the result over the ranks); the forward's seconds by
    part (``models.moe.timed_parts``, CUDA events), a rank."""
    E, D = cfg.n_experts, cfg.d_model
    r0 = ranks[0]
    dispatch_differ = {dt: int(np.sum(r0[dt]["dispatch"]
                                      != single["dispatch"]))
                       for dt in ("bfloat16", "float8_e4m3fn")}
    assert not any(dispatch_differ.values()), dispatch_differ
    out = dict(mesh=dict(data=EP_MESH[0], model=EP_MESH[1]),
               groups=EP_GROUPS, tokens=EP_TOKENS, capacity=C,
               dispatch_differ=dispatch_differ, tol=EP_REL_TOL)
    for dt, want in (("bfloat16", single["y"]),
                     ("float8_e4m3fn", single["y_fp8"])):
        y = r0[dt]["y"]
        rel = _rel_l2(torch.from_numpy(y), torch.from_numpy(want))
        assert np.all(np.isfinite(y)) and rel <= EP_REL_TOL, (dt, rel)
        per_rank, by_kind = [], []
        for r in ranks:
            seen = r[dt]["collectives"]
            moved = [b for kind, b, shape, _ in seen
                     if kind == "all-to-all" and len(shape) == 4
                     and shape[1] == E]
            assert moved, (dt, seen)
            per_rank.append(sum(moved))
            slots = [c for c in seen if c[0] == "all-gather"
                     and len(c[2]) == 4]
            assert not slots, (dt, slots)
            kinds = {}
            for kind, b, _, _ in seen:
                calls, total = kinds.get(kind, (0, 0))
                kinds[kind] = (calls + 1, total + b)
            by_kind.append({k: dict(calls=n, bytes=b)
                            for k, (n, b) in sorted(kinds.items())})
        out[dt] = dict(rel_l2_vs_single=rel,
                       staged_collectives_by_kind_per_rank=by_kind,
                       forward_parts_seconds_per_rank=[r[dt]["parts"]
                                                       for r in ranks],
                       dispatch_all_to_all_bytes_per_rank=per_rank,
                       staged_bytes_per_rank=[r[dt]["staged"]["bytes"]
                                              for r in ranks],
                       forward_seconds_per_rank=[r[dt]["seconds"]
                                                 for r in ranks],
                       peak_memory_bytes_per_rank=[r[dt]["peak_memory_bytes"]
                                                   for r in ranks])
    slots = EP_GROUPS * E * C // SHARDED_RANKS        # a rank's, sent
    b16 = out["bfloat16"]["dispatch_all_to_all_bytes_per_rank"]
    b8 = out["float8_e4m3fn"]["dispatch_all_to_all_bytes_per_rank"]
    assert all(b == slots * 2 * D for b in b16), (b16, slots)
    assert all(b == slots * (D + 4) for b in b8), (b8, slots)
    out["dispatch_bytes_per_slot"] = {"bfloat16": 2 * D,
                                      "float8_e4m3fn": D + 4}
    return out


def _train_single(torch, dev, arch: str = SHARDED_ARCH,
                  layers: int = SHARDED_LAYERS,
                  steps: int = SHARDED_STEPS, seq: int = SHARDED_SEQ,
                  dtype: str = "bfloat16") -> tuple:
    """``arch`` (qwen2-7b) at published widths, ``layers`` layers, its
    parameters and compute in ``dtype``: ``steps`` single-device steps on
    the card from seed 0 (run first and freed), with step 1's gradients of
    the small leaves on the host."""
    import dataclasses

    from repro_torch import tree as TR
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.ranks import train_batch, whole_leaves
    from repro_torch.serve import serving_config
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = serving_config(arch, layers=layers)
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat) == \
        ("bfloat16", "bfloat16", True), cfg
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    opt_cfg = AdamWConfig(**SHARDED_OPT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, opt = init_train_state(cfg, opt_cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in TR.leaves(params))
    names = list(_leaf_paths(params))
    grads = []
    step = make_train_step(cfg, opt_cfg, on_grads=lambda g: grads.append(
        whole_leaves(g, SHARDED_LEAF_ELEMENTS)))
    metrics, step_ms = [], []
    for i in range(steps):
        batch = train_batch(cfg, SHARDED_BATCH, seq, dev, i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    single = dict(metrics=metrics, step_ms=step_ms, params=n_params,
                  grads=grads[0], leaf_names=names,
                  peak=torch.cuda.max_memory_allocated())
    del params, opt, step, batch, m, grads
    gc.collect()                 # autograd's cycles hold the step's tensors
    torch.cuda.empty_cache()
    single["seconds"] = time.time() - t0
    return cfg, opt_cfg, single


def _train_check(cfg, single, ranks) -> dict:
    """The sharded steps' rank results against the single-device steps:
    every rank reads the same metrics, each step's loss and grad norm and
    step 1's small-leaf gradients within their bounds, each rank's K5 / K3
    launches the config's count."""
    import numpy as np

    rows = ranks
    for r in rows:                     # every rank reads the same metrics
        assert r["metrics"] == rows[0]["metrics"], (r["metrics"],
                                                    rows[0]["metrics"])
    assert len(rows[0]["metrics"]) == len(single["metrics"]) == SHARDED_STEPS
    loss_rel, gnorm_rel = [], []
    for mine, one in zip(rows[0]["metrics"], single["metrics"]):
        loss_rel.append(abs(mine["loss"] - one["loss"]) / abs(one["loss"]))
        gnorm_rel.append(abs(mine["grad_norm"] - one["grad_norm"])
                         / abs(one["grad_norm"]))
        assert math.isfinite(mine["loss"]) and \
            loss_rel[-1] <= SHARDED_LOSS_REL_TOL, (mine, one)
        assert gnorm_rel[-1] <= SHARDED_GNORM_REL_TOL, (mine, one)
    mine, one = rows[0]["grads"][0], single["grads"]
    assert sorted(mine) == sorted(one) and one, (sorted(mine), sorted(one))
    leaf_rel = {}
    for j in sorted(one):
        a, b = mine[j].astype(np.float64), one[j].astype(np.float64)
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert math.isfinite(rel) and rel <= SHARDED_LEAF_REL_TOL, \
            (single["leaf_names"][j], rel)
        leaf_rel[single["leaf_names"][j]] = rel
    want = {n: c * SHARDED_STEPS
            for n, c in train_launches_per_step(cfg).items()}
    for r in rows:
        assert r["launches"] == want, (r["launches"], want)
    return dict(arch=SHARDED_ARCH, n_layers=cfg.n_layers,
                params=single["params"], batch=SHARDED_BATCH,
                seq=SHARDED_SEQ, steps=SHARDED_STEPS,
                mesh=dict(data=SHARDED_MESH[0], model=SHARDED_MESH[1]),
                single=single["metrics"], mesh_metrics=rows[0]["metrics"],
                loss_rel=loss_rel, loss_tol=SHARDED_LOSS_REL_TOL,
                grad_norm_rel=gnorm_rel, grad_norm_tol=SHARDED_GNORM_REL_TOL,
                leaf_grad_rel_l2=leaf_rel,
                leaf_grad_rel_l2_max=max(leaf_rel.values()),
                leaf_grad_tol=SHARDED_LEAF_REL_TOL,
                leaf_elements_max=SHARDED_LEAF_ELEMENTS,
                single_step_ms=single["step_ms"],
                rank_step_ms=[[1e3 * t for t in r["seconds"]] for r in rows],
                launches_per_rank=rows[0]["launches"],
                launches={n: sum(r["launches"][n] for r in rows)
                          for n in want},
                host_staged_per_rank=[r["host_staged"] for r in rows],
                peak_memory_bytes_per_rank=[r["peak_memory_bytes"]
                                            for r in rows],
                peak_reserved_bytes_per_rank=[r["peak_reserved_bytes"]
                                              for r in rows],
                allocated_at_reset_bytes_per_rank=[
                    r["allocated_at_reset_bytes"] for r in rows],
                single_peak_memory_bytes=single["peak"],
                single_seconds=single["seconds"])


def dryrun_phase(torch, dev, smi: str, sharded: dict) -> dict:
    """Slice 12: ``repro_torch.launch.dryrun`` on the card's device type.
    The cross-check cell (the sharded_train config, fake 2 x 2) held to what
    each real rank counted on its accounted step (``sharded`` carries them):
    FLOPs within DRYRUN_FLOPS_REL_TOL, collectives equal by kind in calls
    and bytes, the peak within DRYRUN_PEAK_REL_TOL of the rank's allocator
    peak; then DRYRUN_CELLS through ``lower_cell`` at their published
    widths and depths.  No trace allocates card memory (the dry
    run asserts it per cell).  The phase stays within DRYRUN_BUDGET_S."""
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.serve import serving_config

    t_phase = time.time()
    # the accounting on this torch against its hand counts (raises)
    hand = DR.check_hand_counts(str(dev))
    print(f"dryrun hand counts on {dev.type}: {hand} ({smi})", flush=True)
    cfg = serving_config(SHARDED_ARCH, layers=SHARDED_LAYERS)
    pred, pred_rows = DR.trace_step(
        cfg, ShapeSpec("sharded_train", SHARDED_SEQ, SHARDED_BATCH, "train"),
        dict(data=SHARDED_MESH[0], model=SHARDED_MESH[1]), device=str(dev))
    p_flops = pred["cost"]["flops_per_device"]
    p_peak = pred["memory"]["peak_bytes"]
    p_flat = _flattened(DR.collective_axes(pred_rows))
    ranks = []
    for acc, peak, base in zip(sharded["accounting_per_rank"],
                               sharded["peak_memory_bytes_per_rank"],
                               sharded["allocated_at_reset_bytes_per_rank"]):
        flops_rel = abs(acc["flops"] - p_flops) / p_flops
        peak_rel = (peak - p_peak) / p_peak
        ranks.append(dict(flops=acc["flops"], flops_rel=flops_rel,
                          collective_bytes=acc["collective_bytes"],
                          collective_counts=acc["collective_counts"],
                          optimizer=acc["counts_by_part"].get("optimizer"),
                          flattened=sum(acc["flattened_counts"].values()),
                          peak_memory_bytes=peak, peak_rel=peak_rel,
                          allocated_at_reset_bytes=base,
                          temp_bytes=acc["temp_bytes"]))
    cross = dict(arch=SHARDED_ARCH, n_layers=cfg.n_layers,
                 batch=SHARDED_BATCH, seq=SHARDED_SEQ,
                 mesh=dict(data=SHARDED_MESH[0], model=SHARDED_MESH[1]),
                 predicted=dict(flops=p_flops,
                                collective_bytes=pred["collectives"][
                                    "bytes_by_kind"],
                                collective_counts=pred["collectives"][
                                    "count_by_kind"],
                                flattened=p_flat,
                                optimizer=pred["collectives_by_part"].get(
                                    "optimizer"),
                                argument_bytes=pred["memory"][
                                    "argument_bytes"],
                                temp_bytes=pred["memory"]["temp_bytes"],
                                peak_bytes=p_peak),
                 trace_seconds=pred["compile_seconds"], ranks=ranks,
                 flops_tol=DRYRUN_FLOPS_REL_TOL,
                 peak_tol=DRYRUN_PEAK_REL_TOL)
    emit(dict(phase="dryrun_cross_check", nvidia_smi=smi, **cross))
    r0 = ranks[0]
    print(f"dryrun cross-check: {SHARDED_ARCH} {cfg.n_layers} layers, mesh "
          f"{SHARDED_MESH[0]}x{SHARDED_MESH[1]}: predicted "
          f"{p_flops:.6e} FLOPs a rank, measured "
          f"{[r['flops'] for r in ranks]}; collectives equal by kind, "
          f"{p_flat} over several mesh axes at once predicted, "
          f"{[r['flattened'] for r in ranks]} counted; the optimizer's "
          f"{cross['predicted']['optimizer']} predicted, "
          f"{[r['optimizer'] for r in ranks]} counted; peak "
          f"predicted {p_peak / 1e9:.3f} GB, measured "
          f"{[round(r['peak_memory_bytes'] / 1e9, 3) for r in ranks]} GB "
          f"({100 * r0['peak_rel']:+.1f} %): the rank's allocator peak above "
          f"its placed state, {(r0['peak_memory_bytes'] - r0['allocated_at_reset_bytes']) / 1e9:.3f} GB, "
          f"against its own step's tally of live tensors, "
          f"{r0['temp_bytes'] / 1e9:.3f} GB, and the fake trace's "
          f"{pred['memory']['temp_bytes'] / 1e9:.3f} GB: the rest is the "
          f"one-card rig's staged collectives, which copy each gathered "
          f"tensor back and concatenate it on the card ({smi})", flush=True)
    for r in ranks:
        assert r["flops_rel"] <= DRYRUN_FLOPS_REL_TOL, (r, cross["predicted"])
        assert r["collective_bytes"] == cross["predicted"][
            "collective_bytes"], (r, cross["predicted"])
        assert r["collective_counts"] == cross["predicted"][
            "collective_counts"], (r, cross["predicted"])
        assert r["flattened"] == p_flat, (r, cross["predicted"])
        # the optimizer's all-reduces: this torch's rank and fake trace, and
        # the CPU trace's count (tests/test_torch_dryrun.py recomputes it)
        assert r["optimizer"] == cross["predicted"]["optimizer"] == \
            SHARDED_OPTIMIZER_COLLECTIVES, (r["optimizer"],
                                            cross["predicted"]["optimizer"])
        assert abs(r["peak_rel"]) <= DRYRUN_PEAK_REL_TOL, (r, p_peak)
    cells = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        res, rows = DR.lower_cell(arch, shape, multi_pod, device=str(dev))
        assert res["device"] == "cuda" and res["cost"][
            "flops_per_device"] > 0, res
        coll_gb = {k: v / 1e9 for k, v in
                   res["collectives"]["bytes_by_kind"].items() if v}
        by_axes = DR.collective_axes(rows)
        row = dict(tag=DR.cell_tag(arch, shape, multi_pod),
                   n_layers=get_config(arch).n_layers, reduced=[],
                   flops_per_device=res["cost"]["flops_per_device"],
                   bytes_per_device=res["cost"]["bytes_per_device"],
                   collective_gb_by_kind=coll_gb,
                   collectives_by_axes={
                       k: dict(count=v["count"], gb=v["bytes"] / 1e9)
                       for k, v in by_axes.items()},
                   flattened_collectives=_flattened(by_axes),
                   argument_gb=res["memory"]["argument_bytes"] / 1e9,
                   peak_gb=res["memory"]["peak_bytes"] / 1e9,
                   card_gb=DR.HW_H100["hbm_bytes"] / 1e9,
                   dominant=res["roofline"]["dominant"],
                   roofline=res["roofline"],
                   trace_seconds=res["compile_seconds"],
                   model_flops=res["model_flops"],
                   useful_flops_ratio=res["useful_flops_ratio"])
        cells.append(row)
        print(f"dryrun {row['tag']} ({row['n_layers']} layers): "
              f"{row['flops_per_device']:.4e} FLOPs, "
              f"{row['bytes_per_device']:.4e} bytes a device; collectives "
              f"{ {k: round(v, 3) for k, v in coll_gb.items()} } GB; "
              f"{row['flattened_collectives']} over several mesh axes at "
              f"once; by axes "
              f"{ {k: (v['count'], round(v['gb'], 3)) for k, v in row['collectives_by_axes'].items()} } "
              f"(count, GB); argument {row['argument_gb']:.2f} GB, peak "
              f"{row['peak_gb']:.2f} GB of {row['card_gb']:.0f}; "
              f"{row['dominant']}-bound; traced in "
              f"{row['trace_seconds']:.1f} s ({smi})", flush=True)
    for row in cells:
        limit = DRYRUN_ALL_REDUCE_GB.get(row["tag"])
        assert limit is None or row["collective_gb_by_kind"].get(
            "all-reduce", 0.0) < limit, (row["tag"], limit,
                                         row["collective_gb_by_kind"])
    seconds = time.time() - t_phase
    assert seconds <= DRYRUN_BUDGET_S, seconds
    return dict(hand_counts=hand, cross_check=cross, cells=cells,
                seconds=seconds, budget_seconds=DRYRUN_BUDGET_S)


def _grouped_check(np, ranks) -> dict:
    """Slice 16 on the rig's ranks (CUDA tensors, collectives staged
    through the host): ``act.redistribute`` of a sum over ('data',
    'model') and of a gather of one dim over both, against DTensor's own
    ``redistribute``: results and gradients equal bit for bit (small
    integers in float64), one collective over both axes each way where
    DTensor runs two."""
    want = {"sum": ("all-reduce", None),
            "gather": ("all-gather", "reduce-scatter")}
    for got in ranks:
        for case, (fwd, bwd) in want.items():
            mine, theirs = got[case, "grouped"], got[case, "dtensor"]
            assert np.array_equal(mine["y"], theirs["y"]), case
            assert np.array_equal(mine["grad"], theirs["grad"]), case
            assert mine["forward"] == mine["flattened"] == {fwd: 1}, mine
            assert theirs["forward"] == {fwd: 2}, theirs
            assert mine["backward"] == ({bwd: 1} if bwd else {}), mine
            assert theirs["backward"] == ({bwd: 2} if bwd else {}), theirs
    return {case: dict(grouped_rows=ranks[0][case, "grouped"]["rows"],
                       dtensor_rows=ranks[0][case, "dtensor"]["rows"])
            for case in want}


def _lowering_singles(torch, dev) -> dict:
    """Slice 16's single-device runs, each on the card and freed before
    the ranks start: one train step of each LOWERING_TRAIN and
    LOWERING_TRAIN_8 config (1 layer), and the MoE layer at LOWERING_MOE_ARCH's widths (all its
    experts) with its dispatch table."""
    from repro_torch.models.moe import _route_group, capacity, moe_forward
    from repro_torch.parallel.ranks import moe_inputs
    from repro_torch.serve import serving_config

    out = {}
    for arch in dict.fromkeys(a for a, _ in LOWERING_TRAIN):
        out[arch] = _train_single(torch, dev, arch, layers=1, steps=1,
                                  seq=LOWERING_SEQ)
    for arch, _, dtype in LOWERING_TRAIN_8:
        out[arch, dtype] = out[arch] if dtype == "bfloat16" and \
            arch in out else _train_single(torch, dev, arch, layers=1,
                                           steps=1, seq=LOWERING_SEQ,
                                           dtype=dtype)
    # the layer's widths and dtype (its pattern repeats every 8 layers)
    cfg = serving_config(LOWERING_MOE_ARCH, layers=8)
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(LOWERING_MOE_TOKENS, E, k, cfg.capacity_factor)
    torch.cuda.empty_cache()
    inp = moe_inputs(cfg, LOWERING_MOE_GROUPS, LOWERING_MOE_TOKENS,
                     EP_SEED, dev)
    x = inp.pop("x")
    with torch.no_grad():
        y, _ = moe_forward(inp, x, cfg)
        dispatch = _route_group(x @ inp["router"].to(x.dtype), k, C, E)[0]
    out["moe"] = (cfg, C, dict(y=y.float().cpu().numpy(),
                               dispatch=dispatch.cpu().numpy()))
    del inp, x, y, dispatch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def row_gather_collectives(V: int, D: int, B: int, S: int, mesh) -> list:
    """The collectives of the row-gather lookup (``parallel.act.
    _rows_lookup``) and its backward on a (pod, data, model) mesh whose
    batch lies on ('pod', 'data'), in order, as (kind, mesh axes, elements
    a rank), as the reference's HLO has them (the tokens' permute an
    all-to-all here)."""
    pod, data, M = mesh
    return [("all-gather", "model", V * D // data),
            ("all-to-all", "data+model", B * S // (pod * data)),
            ("all-gather", "pod+model", B * S * D // data),
            ("all-gather", "data", B * S * D),
            ("all-gather", "pod+data", B * S * D),
            ("all-reduce", "pod+model", V * D // data)]


def _collective_kinds(collectives, mesh) -> list:
    """A rank's collectives (op with the axes its group spans, operand
    shapes) as (kind, axes, elements): an all-gather's elements its
    result's."""
    import math

    sizes = dict(zip(("pod", "data", "model")[-len(mesh):], mesh))
    out = []
    for op, shapes in collectives:
        axes = op.rsplit(" @", 1)[1]
        n = sum(math.prod(sh) for sh in shapes)
        kind = next(k for k in ("all-gather", "all-to-all", "all-reduce",
                                "reduce-scatter") if _is_op(op, k))
        if kind == "all-gather":
            n *= math.prod(sizes[a] for a in axes.split("+"))
        out.append((kind, axes, n))
    return out


def _table_move_check(case, ranks) -> dict:
    """One TABLE_MOVE case on the rig's ranks: the layout
    ``parallel.act.embed_layout`` picks is the case's; each rank's output
    shard equal to the plain lookup's, its table-gradient shard within
    SHARDED_LEAF_REL_TOL of the plain gradient; the table moved by one
    permute over 'data' and 'model' each way, of a rank's (V / M, D /
    data), where it moves, and the row-gather layout's collectives
    (:func:`row_gather_collectives`) where the rows are gathered."""
    from repro_torch.parallel.act import embed_layout
    from repro_torch.serve import serving_config

    layout, S = case
    cfg = serving_config(TABLE_MOVE_ARCH, layers=1)
    B = TABLE_MOVE_BATCH
    pod, data, M = TABLE_MOVE_MESH
    V, D = cfg.vocab_size, cfg.d_model
    assert embed_layout(V, D, B * S // (pod * data), B * S, data, M,
                        True) == layout, case
    block = (V // M, D // data)
    for r in ranks:
        assert r["out_max_abs"] == 0.0, r
        assert r["grad_rel_l2"] <= SHARDED_LEAF_REL_TOL, r
        moved = [tuple(c[1][0]) for c in r["collectives"]
                 if _is_op(c[0], "all-to-all")
                 and c[0].endswith(" @data+model")]
        if layout == "table":
            assert moved == [block] * 2, (moved, block)
        else:
            got = _collective_kinds(r["collectives"], TABLE_MOVE_MESH)
            assert got == row_gather_collectives(V, D, B, S,
                                                 TABLE_MOVE_MESH), got
    return dict(arch=cfg.name, lookup_only=True, layout=layout,
                mesh=dict(zip(("pod", "data", "model"), TABLE_MOVE_MESH)),
                batch=B, seq=S, rows=V,
                out_max_abs=max(r["out_max_abs"] for r in ranks),
                grad_rel_l2_max=max(r["grad_rel_l2"] for r in ranks),
                table_permutes=2 * (layout == "table"),
                collectives=[c[0] for c in ranks[0]["collectives"]],
                rank_seconds=[r["seconds"] for r in ranks])


def _lowering_train_check(np, cfg, single, ranks, mesh_shape, dev,
                          B: int = SHARDED_BATCH, S: int = LOWERING_SEQ
                          ) -> dict:
    """One LOWERING_TRAIN case on the rig's ranks: its step against the
    single-device step (every rank reads the same metrics; loss, grad norm
    and the small leaves' gradients within the sharded_train bounds; K3 /
    K4 / K5 launches the config's count), and what each rank's Accounting
    counted against the fake trace of the same step on the same mesh
    (collectives and their bytes by kind, and those over several mesh
    axes at once), with the slices' own facts: the Mamba halves moved by
    the reference's permutes and never gathered whole, q never moved where
    only the kv heads miss the axis, no change over ('pod', 'data') made
    one axis at a time, and the optimizer's all-reduces the fake trace's,
    at most one per (axes, dtype) and one for the norm."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as DR

    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"], (r["metrics"],
                                                     ranks[0]["metrics"])
    mine, one = ranks[0]["metrics"][0], single["metrics"][0]
    loss_rel = abs(mine["loss"] - one["loss"]) / abs(one["loss"])
    gnorm_rel = abs(mine["grad_norm"] - one["grad_norm"]) / abs(
        one["grad_norm"])
    assert math.isfinite(mine["loss"]) and \
        loss_rel <= SHARDED_LOSS_REL_TOL, (cfg.name, mine, one)
    assert gnorm_rel <= SHARDED_GNORM_REL_TOL, (cfg.name, mine, one)
    got, want = ranks[0]["grads"][0], single["grads"]
    assert sorted(got) == sorted(want) and want, (sorted(got), sorted(want))
    leaf_rel = {}
    for j in sorted(want):
        a, b = got[j].astype(np.float64), want[j].astype(np.float64)
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert math.isfinite(rel) and rel <= SHARDED_LEAF_REL_TOL, \
            (cfg.name, single["leaf_names"][j], rel)
        leaf_rel[single["leaf_names"][j]] = rel
    launches = train_launches_per_step(cfg)
    for r in ranks:
        assert r["launches"] == launches, (cfg.name, r["launches"], launches)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    pred, pred_rows = DR.trace_step(cfg, ShapeSpec("t", S, B, "train"),
                                    dict(zip(names, mesh_shape)),
                                    device=str(dev))
    p_flat = _flattened(DR.collective_axes(pred_rows))
    for r in ranks:
        acc = r["accounting"]
        assert acc["collective_counts"] == pred["collectives"][
            "count_by_kind"], (cfg.name, acc, pred["collectives"])
        assert acc["collective_bytes"] == pred["collectives"][
            "bytes_by_kind"], (cfg.name, acc, pred["collectives"])
        assert sum(acc["flattened_counts"].values()) == p_flat, \
            (cfg.name, acc["flattened_counts"], p_flat)
    M = mesh_shape[-1]
    b = B // math.prod(mesh_shape[:-1])         # a rank's rows of the batch
    rows = ranks[0]["collectives"]
    facts = {}
    if M > 1 and any(sp.kind == "mamba" for sp in cfg.pattern):
        # the reference's permutes a pass (at M = 4: 2 w, w, w, w columns)
        # in the forward and its recompute, w columns back for each in the
        # backward
        from repro_torch.models.mamba import _halves_permutes

        w = cfg.d_inner // M
        used = [sent for pairs, sent, _, _ in _halves_permutes(M) if pairs]
        halves = sorted(tuple(c[1][0]) for c in rows
                        if _is_op(c[0], "all-to-all")
                        and c[0].endswith(" @model"))
        want = sorted(([(b, S, w * len(sent)) for sent in used] * 2
                       + [(b, S, w)] * len(used)) * cfg.n_layers)
        whole = [c for c in rows if _is_op(c[0], "all-gather")
                 and c[0].endswith(" @model")
                 and tuple(c[1][0]) == (b, S, 2 * w)]
        assert halves == want and not whole, (halves, whole)
        facts["halves_permutes"] = len(halves)
    if cfg.n_heads and M > 1 and cfg.n_heads % M and \
            cfg.n_kv_heads > 1 and M % cfg.n_kv_heads == 0:
        # each rank its kv group's heads and its own columns of the output:
        # the padded output is never reduce-scattered over 'model'; the
        # backward gathers dO over the R ranks of a kv group (w columns a
        # rank) and dq / dk / dv over the Kv groups, on subgroups of
        # 'model' labelled by their size, as the fake trace does
        scattered = [c for c in rows if _is_op(c[0], "reduce-scatter")
                     and c[0].endswith(" @model")]
        assert not scattered, (cfg.name, scattered)
        Kv, hd = cfg.n_kv_heads, cfg.head_dim
        G, R = cfg.n_heads // Kv, M // Kv

        def subgroup_gathers(rows):
            return sorted((c[0].rsplit(" @", 1)[1], tuple(c[1][0]))
                          for c in rows if _is_op(c[0], "all-gather")
                          and " @model[" in c[0])

        got = subgroup_gathers(rows)
        want = sorted([(f"model[{R}]", (b, S, G * hd // R)),
                       (f"model[{Kv}]", (b, S, G, hd))]
                      + [(f"model[{Kv}]", (b, S, 1, hd))] * 2) * \
            cfg.n_layers
        assert got == want == subgroup_gathers(
            [(r[0], r[1]) for r in pred_rows]), (cfg.name, got, want)
        facts["kv_group_heads"] = cfg.n_heads // cfg.n_kv_heads
        facts["kv_group_gathers"] = {
            k: sum(g[0] == k for g in got)
            for k in (f"model[{R}]", f"model[{Kv}]")}
    if len(mesh_shape) == 3 and mesh_shape[0] > 1 and \
            mesh_shape[1] == M > 1:
        # where the reference's partitioner moves the table (fewer rows
        # than the batch's tokens: the batch lies on 'pod', which holds no
        # shard of D), one permute over 'data' and 'model' in the forward
        # and one back in the backward, a rank's (V / M, D / data);
        # elsewhere the tokens move and no table block does (no step here
        # lies in the band where XLA gathers the table's whole rows)
        from repro_torch.parallel.act import embed_layout

        moved = [tuple(c[1][0]) for c in rows if _is_op(c[0], "all-to-all")
                 and c[0].endswith(" @data+model")]
        block = (cfg.vocab_size // M, cfg.d_model // mesh_shape[1])
        layout = embed_layout(cfg.vocab_size, cfg.d_model, b * S, B * S,
                              mesh_shape[1], M, True)
        assert layout != "rows", (cfg.name, layout)
        table = layout == "table"
        assert moved == [block] * 2 * table, (cfg.name, moved, block)
        facts["table_permutes"] = len(moved)
    # the optimizer: at most one all-reduce per (axes, dtype) of the
    # gradients' sums and one for the global norm, as the fake trace counts
    from repro_torch import tree as TR
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.optim.adamw import AdamWConfig

    opt = ranks[0]["accounting"]["counts_by_part"].get("optimizer", {})
    for r in ranks:
        assert r["accounting"]["counts_by_part"].get("optimizer", {}) == \
            opt == pred["collectives_by_part"].get("optimizer", {}), \
            (cfg.name, r["accounting"]["counts_by_part"], pred[
                "collectives_by_part"])
    dtypes = len({p.dtype for p in TR.leaves(
        train_state_specs(cfg, AdamWConfig())[0])})
    assert opt and all(k.startswith("all-reduce") for k in opt) and \
        sum(opt.values()) <= dtypes * len(opt) + 1, (cfg.name, opt)
    facts["optimizer_collectives"] = opt
    if cfg.n_heads and M > 1 and cfg.n_heads % M == 0 and \
            cfg.n_kv_heads % M:
        # told apart by their heads (gemma-2b: q's 2 a rank or 8, kv's 1)
        assert cfg.n_kv_heads not in (cfg.n_heads // M, cfg.n_heads), cfg
        q = [c for c in rows if len(c[1][0]) == 4
             and c[1][0][2] in (cfg.n_heads // M, cfg.n_heads)]
        kv = [c for c in rows if len(c[1][0]) == 4
              and c[1][0][2] == cfg.n_kv_heads]
        assert not q and kv, (q, kv)
        facts["kv_collectives"] = len(kv)
        # q's, k's and v's input gradients reduced one by one over
        # 'model', as the reference's partitioner reduces them: beside the
        # gate's and up projection's (2 a layer) and, where 'model' shards
        # the vocabulary, the head's (one a loss chunk of (b, c, D)), 3 a
        # layer
        c = min(cfg.loss_chunk, S)
        chunks = S // c if cfg.vocab_size % M == 0 else 0
        own = [r for r, fns in zip(rows, ranks[0]["collective_issuers"])
               if _is_op(r[0], "all-reduce") and r[0].endswith(" @model")
               and "_ReducedGrad.backward" in fns
               and tuple(r[1][0]) in ((b, S, cfg.d_model),
                                      (b, c, cfg.d_model))]
        assert len(own) - chunks - 2 * cfg.n_layers == 3 * cfg.n_layers, \
            (cfg.name, len(own))
        facts["qkv_all_reduces"] = 3 * cfg.n_layers
    if len(mesh_shape) == 3 and mesh_shape[0] > 1 and mesh_shape[1] > 1:
        colls = [c[0].rsplit(" @", 1) for c in rows]
        pairs = [(a, b) for a, b in zip(colls, colls[1:])
                 if len(a) == len(b) == 2 and a[0] == b[0]
                 and {a[1], b[1]} == {"pod", "data"}]
        assert p_flat > 0 and not pairs, (p_flat, pairs)
    return dict(arch=cfg.name, n_layers=cfg.n_layers,
                mesh=dict(zip(names, mesh_shape)), batch=B, seq=S,
                loss=mine["loss"], single_loss=one["loss"],
                loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                leaf_grad_rel_l2_max=max(leaf_rel.values()),
                launches_per_rank=ranks[0]["launches"],
                collective_counts=ranks[0]["accounting"][
                    "collective_counts"],
                collective_bytes=ranks[0]["accounting"]["collective_bytes"],
                flattened=p_flat, **facts,
                rank_step_ms=[1e3 * r["seconds"][0] for r in ranks],
                single_step_ms=single["step_ms"][0])


def _lowering_moe_check(torch, np, cfg, C, single, ranks) -> dict:
    """The MoE layer at LOWERING_MOE_MESH against the single-device layer:
    equal dispatch tables, output within EP_REL_TOL, and on every rank the
    whole-batch (G, S, D) combine summed by two all-reduces, one of the
    'model' pair and one of the four ('pod', 'data') ranks."""
    r0 = ranks[0]["bfloat16"]
    differ = int(np.sum(r0["dispatch"] != single["dispatch"]))
    assert differ == 0, differ
    rel = _rel_l2(torch.from_numpy(r0["y"]), torch.from_numpy(single["y"]))
    assert np.all(np.isfinite(r0["y"])) and rel <= EP_REL_TOL, rel
    whole = (LOWERING_MOE_GROUPS, LOWERING_MOE_TOKENS, cfg.d_model)
    sums = []
    for r in ranks:
        seen = r["bfloat16"]["collectives"]
        combine = [n for kind, _, shape, n in seen if kind == "all-reduce"
                   and tuple(shape) == whole and n > 1]
        pod, data, model = LOWERING_MOE_MESH
        assert combine == [model, pod * data], seen
        sums.append(combine)
    return dict(arch=LOWERING_MOE_ARCH, experts=cfg.n_experts,
                d_model=cfg.d_model, d_ff=cfg.moe_d_ff, capacity=C,
                mesh=dict(zip(("pod", "data", "model"), LOWERING_MOE_MESH)),
                groups=LOWERING_MOE_GROUPS, tokens=LOWERING_MOE_TOKENS,
                dispatch_differ=differ, rel_l2_vs_single=rel,
                tol=EP_REL_TOL, combine_all_reduce_group_sizes=sums,
                staged_collectives_rank0=[
                    (kind, list(shape), n) for kind, _, shape, n in
                    ranks[0]["bfloat16"]["collectives"]],
                forward_seconds_per_rank=[r["bfloat16"]["seconds"]
                                          for r in ranks])


def _is_op(op: str, kind: str) -> bool:
    """Whether an Accounting row's op (``staged all-to-all @model``, or a
    functional collective's name on a CPU mesh) is a collective of
    ``kind`` (``all-to-all``)."""
    return kind in op or kind.replace("-", "_") in op


def _flattened(by_axes: dict) -> int:
    """The collectives of ``dryrun.collective_axes`` over several mesh axes
    at once."""
    return sum(v["count"] for k, v in by_axes.items() if "+" in k)


@contextlib.contextmanager
def _headroom(torch, dev, every_s: float = 0.2):
    """The least host memory available (``MemAvailable`` of
    /proc/meminfo) and the least free card memory (every process's use
    counted) seen while the block runs, read by a thread every ``every_s``
    seconds: what the ranks sharing the host and the card left."""
    import threading

    low = dict(host_available_min_bytes=None, card_free_min_bytes=None)
    stop = threading.Event()

    def host_available() -> int:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
        return -1

    def read():
        for key, now in (("host_available_min_bytes", host_available()),
                         ("card_free_min_bytes",
                          torch.cuda.mem_get_info(dev)[0])):
            if low[key] is None or now < low[key]:
                low[key] = now

    def sample():
        while not stop.wait(every_s):
            read()

    read()
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield low
    finally:
        stop.set()
        thread.join()
        read()


def sharded_phase(torch, np, dev) -> tuple:
    """Slice 11 on SHARDED_RANKS ranks of the one card, in one launch:
    ``ep_moe`` (kimi-k2's expert widths, data 1 x model 4, each rank
    drawing its 96 experts from the same per-expert seeds) and
    the DTensor ``moe_forward`` of the same layer with the groups on every
    rank, with the bf16 and the e4m3 dispatch (slice 14);
    ``sharded_train`` (qwen2-7b, SHARDED_LAYERS layers, data 2 x model 2,
    parameters, AdamW state and batch placed by the sharding rules, the
    step inside ``activation_mesh``), each held to its single-device run on
    the same card, which goes first and is freed.  The ranks share the card
    over gloo, so DTensor's collectives are staged through the host
    (``run_ranks(stage_through_host=True)``); the card must have
    SHARDED_RANK_BUDGET_BYTES free for each rank before they start.  Last,
    each rank runs the sharded_train step once more, untimed, counted by
    the dry run's ``Accounting`` (``accounting_per_rank``: what
    :func:`dryrun_phase` holds its fake trace to), the grouped
    redistribute against DTensor's, and slice 16's LOWERING_TRAIN steps,
    each held to its single-device step and its fake trace; then
    LOWERING_MOE_RANKS ranks run the MoE layer at LOWERING_MOE_MESH and
    slice 17's LOWERING_TRAIN_8 steps, held the same way (``lowering``).  Returns the two phases' rows and the first launch's
    seconds."""
    from repro_torch.launch.dryrun import accounted_train_step
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.parallel.ranks import (embedding_rank, ep_moe_rank,
                                            grouped_redistribute_rank,
                                            moe_forward_rank, run_jobs,
                                            sharded_train_steps)
    from repro_torch.serve import serving_config

    ep_cfg, C, ep_single = _ep_single(torch, np, dev)
    train_cfg, opt_cfg, train_single = _train_single(torch, dev)
    low_single = _lowering_singles(torch, dev)
    low_moe_cfg, low_C, low_moe_single = low_single.pop("moe")
    low_jobs = []
    for mesh_shape in dict.fromkeys(m for _, m in LOWERING_TRAIN):
        cfgs = [low_single[a][0] for a, m in LOWERING_TRAIN
                if m == mesh_shape]
        low_jobs.append((sharded_train_steps, (
            cfgs, opt_cfg, SHARDED_BATCH, LOWERING_SEQ, mesh_shape, str(dev),
            1, SHARDED_LEAF_ELEMENTS, True)))

    # what this process still holds on the card beside the four ranks, and
    # what the card has free for them (every process's memory counted)
    gc.collect()
    torch.cuda.empty_cache()
    memory = dict(parent_reserved_bytes=torch.cuda.memory_reserved(),
                  free_bytes_before_ranks=torch.cuda.mem_get_info(dev)[0],
                  rank_budget_bytes=SHARDED_RANK_BUDGET_BYTES,
                  ranks=SHARDED_RANKS)
    need = SHARDED_RANKS * SHARDED_RANK_BUDGET_BYTES
    assert memory["free_bytes_before_ranks"] >= need, \
        f"sharded: {memory} -- the ranks need {need} bytes free"
    t0 = time.time()
    with _headroom(torch, dev) as headroom:
        ranks = run_ranks(run_jobs, SHARDED_RANKS, [
            (ep_moe_rank, (dict(seed=EP_SEED, G=EP_GROUPS, S=EP_TOKENS),
                           ep_cfg, EP_MESH, str(dev))),
            # slice 14: the DTensor layer, bf16 then e4m3 dispatch
            (moe_forward_rank, (dict(seed=EP_SEED, G=EP_GROUPS,
                                     S=EP_TOKENS), ep_cfg, EP_MESH, str(dev),
                                ("bfloat16", "float8_e4m3fn"))),
            (sharded_train_steps, ([train_cfg], opt_cfg, SHARDED_BATCH,
                                   SHARDED_SEQ, SHARDED_MESH, str(dev),
                                   SHARDED_STEPS, SHARDED_LEAF_ELEMENTS)),
            # the same step once more, counted for the dry run's cross-check
            (accounted_train_step, (train_cfg, opt_cfg, SHARDED_BATCH,
                                    SHARDED_SEQ, SHARDED_MESH, str(dev))),
            # slice 16: one collective over both axes against DTensor's two
            (grouped_redistribute_rank, (SHARDED_MESH, str(dev))),
            # and its lowerings at published widths, held to one device
            *low_jobs], device=str(dev), stage_through_host=True)
    ranks_s = time.time() - t0
    ep = _ep_check(torch, np, ep_cfg, C, ep_single, [r[0] for r in ranks])
    ep["dtensor_dispatch"] = _dispatch_check(torch, np, ep_cfg, C, ep_single,
                                             [r[1] for r in ranks])
    train = _train_check(train_cfg, train_single, [r[2][0] for r in ranks])
    train["accounting_per_rank"] = [r[3] for r in ranks]
    train["grouped_redistribute"] = _grouped_check(np, [r[4] for r in ranks])
    by_mesh = {m: [r[5 + j] for r in ranks] for j, m in enumerate(
        dict.fromkeys(m for _, m in LOWERING_TRAIN))}
    lowering = []
    for arch, mesh_shape in LOWERING_TRAIN:
        cfg, _, single = low_single[arch]
        at = [a for a, m in LOWERING_TRAIN if m == mesh_shape].index(arch)
        lowering.append(_lowering_train_check(
            np, cfg, single, [r[at] for r in by_mesh[mesh_shape]],
            mesh_shape, dev))
    # the MoE layer's ranks and slice 17's steps, once the four have ended
    t1 = time.time()
    with _headroom(torch, dev) as headroom8:
        ranks8 = run_ranks(run_jobs, LOWERING_MOE_RANKS, [
            (moe_forward_rank, (dict(seed=EP_SEED, G=LOWERING_MOE_GROUPS,
                                     S=LOWERING_MOE_TOKENS),
                                low_moe_cfg, LOWERING_MOE_MESH, str(dev))),
            *[(sharded_train_steps, ([low_single[a, dt][0]], opt_cfg,
                                     SHARDED_BATCH, LOWERING_SEQ, m,
                                     str(dev), 1, SHARDED_LEAF_ELEMENTS,
                                     True))
              for a, m, dt in LOWERING_TRAIN_8],
            *[(embedding_rank, (serving_config(TABLE_MOVE_ARCH, layers=1),
                                TABLE_MOVE_BATCH, S, TABLE_MOVE_MESH,
                                str(dev)))
              for _, S in TABLE_MOVE_CASES]],
            device=str(dev), stage_through_host=True)
    launch8_s = time.time() - t1
    lowering.append(_lowering_moe_check(
        torch, np, low_moe_cfg, low_C, low_moe_single,
        [r[0] for r in ranks8]))
    lowering[-1]["launch_seconds"] = launch8_s
    for j, (arch, mesh_shape, dtype) in enumerate(LOWERING_TRAIN_8):
        cfg, _, single = low_single[arch, dtype]
        lowering.append(_lowering_train_check(
            np, cfg, single, [r[1 + j][0] for r in ranks8], mesh_shape,
            dev))
    for j, case in enumerate(TABLE_MOVE_CASES):
        lowering.append(_table_move_check(
            case, [r[1 + len(LOWERING_TRAIN_8) + j] for r in ranks8]))
    train["lowering"] = lowering
    memory["headroom"] = {SHARDED_RANKS: headroom,
                          LOWERING_MOE_RANKS: headroom8}
    ep.update(memory)
    train.update(memory)
    return ep, train, ranks_s


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
    by_kernel = {}
    for r in lm_rows:
        by_kernel[r["kernel"]] = by_kernel.get(r["kernel"], 0.0) + r["seconds"]
    emit(dict(phase="lm_kernel_check_done", cases=len(lm_rows),
              seconds=time.time() - t0, seconds_by_kernel=by_kernel))

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

    # -- phase 7a: the scale row's normals, card against host bits -----
    bits = threefry_bits(torch, np, dev)
    emit(dict(phase="threefry_bits", nvidia_smi=smi, **bits))

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

    # -- phase 9c: slice 14, kimi-k2 with the bf16 and e4m3 dispatch -----
    t0 = time.time()
    moe_fp8 = moe_fp8_phase(torch, dev)
    moe_fp8["seconds"] = time.time() - t0
    emit(dict(phase="moe_fp8", nvidia_smi=smi, **moe_fp8))
    print(f"moe_fp8: {MOE_FP8_ARCH} {moe_fp8['n_layers']} layer at published "
          f"widths, {moe_fp8['weight_bytes'] / 1e9:.2f} GB of weights: "
          f"prefill {moe_fp8['prefill_ms']['bfloat16']:.1f} ms (bf16 "
          f"dispatch) / {moe_fp8['prefill_ms']['float8_e4m3fn']:.1f} ms "
          f"(e4m3); dispatch {moe_fp8['dispatch_bytes_per_layer']['bfloat16']}"
          f" / {moe_fp8['dispatch_bytes_per_layer']['float8_e4m3fn']} bytes a "
          f"layer; quantize {moe_fp8['quantize_ms'] * 1e3:.1f} us; payload "
          f"bits equal the host's; logits rel L2 "
          f"{moe_fp8['logits_rel_l2_fp8_vs_bf16']:.4f} (tol "
          f"{MOE_FP8_LOGITS_REL_TOL}) ({smi})", flush=True)

    # -- phase 9d: slice 14, qwen2-vl-7b's vision stub, greedy and sampled
    t0 = time.time()
    vl = vl_phase(torch, np, dev)
    vl["seconds"] = time.time() - t0
    emit(dict(phase="vl_serving", nvidia_smi=smi, **vl))
    print(f"vl_serving: {VL_ARCH} {vl['n_layers']} layers, "
          f"{VL_REQUESTS} x {VL_PROMPT} stub embeddings: prefill "
          f"{vl['greedy']['prefill_tokens_per_s']:.0f} tokens/s, decode "
          f"{vl['greedy']['decode_ms_per_step']:.2f} ms a step greedy, "
          f"{vl['sampled']['decode_ms_per_step']:.2f} ms at T "
          f"{VL_TEMPERATURE}; {vl['draws_checked']} Gumbel draws bit for bit "
          f"the host's ({smi})", flush=True)

    # -- phase 10: the reduced model, card against CPU -------------------
    emit(dict(phase="reduced_card_vs_cpu", **reduced_cpu_check(torch, dev)))

    # -- phase 10b: gradients through K5, K3, K4 against the plain path --
    emit(dict(phase="lm_grad_check", **lm_grad_check(torch, dev)))

    # -- phase 10c: LM training at full width, qwen2-7b (K5, K3) --------
    t0 = time.time()
    train = train_phase(torch, dev)
    train["seconds"] = time.time() - t0
    emit(dict(phase="train", nvidia_smi=smi, **train))
    attn_bwd = train["profiled_step"].get("kernel_backward_ms", {}).get(
        "flash_attention", "not measured")
    print(f"train: qwen2-7b {train['n_layers']} layers, S {train['seq']}: "
          f"{train['step_ms']:.1f} ms a step, "
          f"{train['tokens_per_s']:.0f} tokens/s, MFU {train['mfu']:.4f} "
          f"of 989 TFLOP/s, attention backward {attn_bwd} ms a step (K3's "
          f"backward kernel), peak {train['peak_memory_gb']:.2f} GB ({smi})",
          flush=True)

    # -- phase 10d: reduced training card vs CPU, restart, compression --
    t0 = time.time()
    train_small = train_reduced_phase(torch, dev)
    train_small["seconds"] = time.time() - t0
    emit(dict(phase="train_reduced", nvidia_smi=smi, **train_small))

    # -- phase 10e: slice 11, sharded execution, 4 ranks on the card ----
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ep, sharded, ranks_s = sharded_phase(torch, np, dev)
    sharded_s = time.time() - t0
    emit(dict(phase="ep_moe", nvidia_smi=smi, **ep))
    print(f"ep_moe: {EP_ARCH} experts, {SHARDED_RANKS} ranks (data "
          f"{EP_MESH[0]} x model {EP_MESH[1]}) on one card: 2 all-to-alls "
          f"a forward, {ep['all_to_all_bytes_per_rank'][0] // 2} bytes each "
          f"per rank; forward {max(ep['forward_seconds_per_rank']):.3f} s; "
          f"dispatch equal; rel L2 {ep['rel_l2_vs_single']:.2e} "
          f"(tol {EP_REL_TOL:.2e}) ({smi})", flush=True)
    dd = ep["dtensor_dispatch"]
    print(f"dtensor dispatch: {EP_ARCH} experts, groups on every rank: "
          f"dispatch all-to-all "
          f"{dd['float8_e4m3fn']['dispatch_all_to_all_bytes_per_rank'][0]} "
          f"bytes a rank in e4m3 against "
          f"{dd['bfloat16']['dispatch_all_to_all_bytes_per_rank'][0]} in "
          f"bf16; rel L2 to one device "
          f"{dd['float8_e4m3fn']['rel_l2_vs_single']:.2e} / "
          f"{dd['bfloat16']['rel_l2_vs_single']:.2e} (tol {EP_REL_TOL:.2e}); "
          f"dispatch tables equal ({smi})", flush=True)
    for dt in ("bfloat16", "float8_e4m3fn"):
        parts = dd[dt]["forward_parts_seconds_per_rank"]
        print(f"dtensor dispatch {dt}: forward s a rank by part "
              f"{ {k: [round(p[k], 4) for p in parts] for k in parts[0]} }; "
              f"rank 0's staged collectives "
              f"{dd[dt]['staged_collectives_by_kind_per_rank'][0]} ({smi})",
              flush=True)
    emit(dict(phase="sharded_train", nvidia_smi=smi, **sharded))
    emit(dict(phase="sharded", seconds=sharded_s, ranks_seconds=ranks_s))
    print("rank launches: " + "; ".join(
        f"{n} ranks left at least {h['host_available_min_bytes'] / 1e9:.2f} "
        f"GB of host memory available and {h['card_free_min_bytes'] / 1e9:.2f}"
        f" GB of the card free" for n, h in sharded["headroom"].items())
          + f" ({smi})", flush=True)
    print(f"sharded_train: {SHARDED_ARCH} {sharded['n_layers']} layers, "
          f"mesh data {SHARDED_MESH[0]} x model {SHARDED_MESH[1]}, B "
          f"{SHARDED_BATCH} S {SHARDED_SEQ}: losses "
          f"{[round(m['loss'], 6) for m in sharded['mesh_metrics']]} vs "
          f"{[round(m['loss'], 6) for m in sharded['single']]} single; "
          f"small-leaf gradients within "
          f"{sharded['leaf_grad_rel_l2_max']:.2e} (tol "
          f"{SHARDED_LEAF_REL_TOL:.0e}); step ms per rank "
          f"{[round(t[-1], 1) for t in sharded['rank_step_ms']]}; "
          f"{sharded['host_staged_per_rank'][0]['bytes']} bytes of the "
          f"rig's host copies per rank; phase {sharded_s:.1f} s ({smi})",
          flush=True)
    grouped = sharded["grouped_redistribute"]
    print(f"grouped redistribute on the rig's ranks: sum and gather over "
          f"('data', 'model') equal DTensor's bit for bit; rank 0's "
          f"collectives {grouped['sum']['grouped_rows']} + "
          f"{grouped['gather']['grouped_rows']} against DTensor's "
          f"{grouped['sum']['dtensor_rows']} + "
          f"{grouped['gather']['dtensor_rows']} ({smi})", flush=True)

    for row in sharded["lowering"]:
        emit(dict(phase="sharded_lowering", nvidia_smi=smi, **row))
        mesh = " x ".join(f"{a} {n}" for a, n in row["mesh"].items())
        if "lookup_only" in row:
            how = (f" moved by {row['table_permutes']} permutes"
                   if row["layout"] == "table" else
                   "'s whole rows gathered over 'model' (collectives "
                   "the reference's)")
            print(f"sharded lowering: {row['arch']} embedding lookup alone "
                  f"at {mesh}, B {row['batch']} S {row['seq']}: the "
                  f"{row['rows']}-row table{how}, output equal to the "
                  f"plain lookup, table gradient within "
                  f"{row['grad_rel_l2_max']:.2e}; "
                  f"{max(row['rank_seconds']):.2f} s a rank ({smi})",
                  flush=True)
        elif "loss" in row:
            print(f"sharded lowering: {row['arch']} 1 layer at {mesh}, B "
                  f"{row['batch']} S {row['seq']}: loss {row['loss']:.6f} vs "
                  f"{row['single_loss']:.6f} single (rel "
                  f"{row['loss_rel']:.2e}), small-leaf gradients within "
                  f"{row['leaf_grad_rel_l2_max']:.2e}; collectives "
                  f"{ {k: v for k, v in row['collective_counts'].items() if v} }"
                  f" counted = the fake trace's, "
                  f"{row['flattened']} over several mesh axes at once"
                  + (f", {row['halves_permutes']} halves permutes"
                     if "halves_permutes" in row else "")
                  + f", optimizer {row['optimizer_collectives']}"
                  + (f", {row['kv_collectives']} of k / v and none of q"
                     if "kv_collectives" in row else "")
                  + f"; step ms {[round(t, 1) for t in row['rank_step_ms']]}"
                  f" ({smi})", flush=True)
        else:
            print(f"sharded lowering: {row['arch']} MoE layer at {mesh}: "
                  f"rel L2 {row['rel_l2_vs_single']:.2e} (tol "
                  f"{row['tol']:.2e}), dispatch equal, the whole-batch "
                  f"combine summed by all-reduces of "
                  f"{row['combine_all_reduce_group_sizes'][0]} ranks "
                  f"(forward {max(row['forward_seconds_per_rank']):.3f} s) "
                  f"({smi})", flush=True)

    # -- phase 10f: slice 12, the dry run on the card's device type -----
    dry = dryrun_phase(torch, dev, smi, sharded)
    emit(dict(phase="dryrun", nvidia_smi=smi, **dry))

    # -- phase 10g: slice 14, the hill-climb's fp8_dispatch variant ------
    emit(dict(phase="hillclimb_fp8", nvidia_smi=smi,
              **hillclimb_phase(torch, dev, smi, dry)))

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
    emit(dict(phase="quickstart", **quickstart_phase()))
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
        first = mine[0]               # the serving path's (table) case
        path_launches = (lm_launches[name] + qwen["launches"][name]
                         + sum(r[name] for r in moe_fp8["launches"].values())
                         + sum(r[name] for r in vl["launches"].values())
                         + train["launches"][name]
                         + train_small["launches"][name]
                         + sharded["launches"][name])
        assert path_launches > 0, (name, path_launches)
        # the forward kernels run on the serving path, the backward in
        # training
        assert (lm_launches[name] > 0) == (name != "flash_attention_backward"), \
            (name, lm_launches)
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
