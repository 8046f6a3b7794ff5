"""The dry run and the hill-climb (``repro_torch.launch.dryrun``,
``repro_torch.launch.hillclimb``) on the CPU, and the sharded serving steps.

* Against the reference's own dry run: ``repro.launch.dryrun.lower_cell``
  run in a subprocess with 512 XLA host devices (and ``jax.make_mesh``
  given Auto axes: jax 0.9.0 makes them Explicit, and the reference's
  ``with_sharding_constraint`` then refuses them), for four 16 x 16
  cells: 1-layer ``hubert-xlarge``, ``falcon-mamba-7b``, ``qwen2-7b``
  (28 / 4 heads on a model axis of 16: a kv group's heads a rank) and
  ``kimi-k2-1t-a32b`` (384 experts, 24 a model rank) ``train_4k``.
  Per-device FLOPs within 1 % of the reference's HLO count (measured:
  equal to 5 digits, falcon-mamba +0.01 %, kimi-k2 equal), argument bytes
  within 1 %, the analytic figures equal, the same keys.  Each cell's
  collective elements within 10 % of the reference's (kimi-k2's within
  3 %; the HLO's collectives read one by one, with their trip counts and
  the functions on their stacks), the head's FSDP gathers as many and as
  large as the reference's, the optimizer's sums one all-reduce per mesh
  axes and one for the norm; kimi-k2's attention within 1.5 times the
  reference's, its all-to-alls equal, no slot tensor in a collective;
  falcon-mamba's in_proj halves moved by the reference's permutes, never
  gathered whole; hubert-xlarge's hidden state all-reduced over 'model'
  as many times as the reference's.  kimi-k2's cell once more at 2 x 16
  x 16: FLOPs within 1 %, collective elements within 10 %, the
  whole-batch combine all-reduced twice (over 'model', over 'pod' and
  'data' at once), no collective issued once per axis over ('pod',
  'data'), and the embedding's group within 10 % of the reference's (the
  table moves).  chip_smoke's count of the sharded_train step's optimizer
  collectives is this torch's trace's.  And 1-layer
  ``falcon-mamba-7b`` ``decode_32k``: the
  all-gathers' elements a device within 5 % of the reference's (XLA's
  CPU backend gathers bf16 weights as f32, so its bytes are twice the
  program's; elements compare).
* Against hand counts: a 16 x 16 matmul's per-device FLOPs; a column- then
  row-parallel MLP on a 1 x 4 mesh has one all-reduce of B S D elements.
* Fake against real: on 4 gloo CPU ranks, a 1-layer reduced config's
  train step counted by ``Accounting`` on each rank, against the fake
  2 x 2 trace of the same step (FLOPs and collectives by kind equal); in
  the same launch the sharded prefill and two decode steps (2 x 2) against
  the single-device steps.
* The cell list and tags equal the reference's; cells leave no process
  group and no tensors behind; the uneven-heads train steps of qwen2-7b and
  gemma-2b complete at 16 x 16; the hill-climb writes its artifact and
  line, the float8 dispatch's variant too.
* The float8 expert dispatch: 1-layer ``grok-1-314b`` ``train_4k`` with
  the dispatch in bf16 and in e4m3, held to the reference's own lowering
  of the same overrides: per-device FLOPs within 1 %, and the e4m3
  dispatch changing each collective kind's bytes by the same ratio in
  both packages (1: no dispatch exchange at 16 x 16, see the test);
  kimi-k2's cell with either dispatch: the same collectives.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES, ShapeSpec, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import run_ranks
from repro_torch.parallel.ranks import (run_jobs, serving_tokens,
                                        sharded_serving_steps, train_batch,
                                        whole_leaves)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import make_decode_step, make_prefill_step
from test_torch_harness import ROOT

#: the parity cells: (arch, shape), one layer, 16 x 16
PARITY = [("hubert-xlarge", "train_4k"), ("falcon-mamba-7b", "train_4k"),
          ("qwen2-7b", "train_4k"), ("kimi-k2-1t-a32b", "train_4k")]
PARITY_FLOPS_REL = 1e-2
#: the cell whose collectives are held to the reference's most closely:
#: kimi-k2, whose 384 experts spread over the model axis (24 a rank); each
#: collective's elements a device (XLA's CPU backend widens bf16
#: collectives to f32, so bytes do not compare), totalled over kinds.
#: Measured: the port -1.83 % (3.2392e10 against 3.2997e10; -2.72 % before
#: the head's 9 gathers and the routing probabilities' gathers over
#: 'data').  The combine (2.25e10 of the total), the expert weights'
#: gathers and gradient reductions, the head's, the router's and the
#: all-to-alls are the reference's, element for element; attention moves
#: 3.52e8 against the reference's 4.40e8, and its q / k / v input
#: gradients are summed before one all-reduce where the reference runs
#: three (-9.4e8; see ``models.transformer._attn_sublayer``).  The count
#: is exact (a trace, no noise); 3 % is the bound the repair was asked to
#: meet.
EP_CELL = ("kimi-k2-1t-a32b", "train_4k")
EP_ELEMENTS_REL = 3e-2
#: attention's collectives in the reference's HLO of EP_CELL, elements a
#: device (tools/dryrun_attribution.py: k and v gathered over 8 of the
#: model ranks, dK / dV summed over pairs); the port's may be 1.5 times
ATTENTION_REF_ELEMENTS = 4.4006e8
ATTENTION_REL = 1.5
#: the other cells' collectives, in total (see MAMBA_CELL, MULTIPOD_CELL)
COLLECTIVE_ELEMENTS_REL = 1e-1
#: the Mamba cell whose collectives are held to the reference's:
#: falcon-mamba-7b train_4k, one layer, 16 x 16.  in_proj's product stays
#: on its 'model' shards and its halves move as the reference's partitioner
#: moves them (four permutes a pass, 4.6976e8 elements against 4.7024e8);
#: the embedding, whose 65,024 rows are fewer than a rank's 65,536 tokens,
#: moves the table and not the activations.  Measured: +0.21 % (1.9422e9
#: against 1.9381e9; -6.01 % before, +174.5 % before that)
MAMBA_CELL = ("falcon-mamba-7b", "train_4k")
#: kimi-k2's cell at 2 x 16 x 16 (one layer): a sum over ('pod', 'data')
#: is one all-reduce over both, as GSPMD's replica groups span them
#: (counted with DTensor's own merging of per-axis collectives off, as
#: ``Accounting`` counts every trace: torch 2.11 has none); the embedding
#: moves its table, as the reference's does there.  Measured: -0.87 %
#: (2.9892e10 against 3.0154e10; +0.77 % before, +69.8 % before that)
MULTIPOD_CELL = ("kimi-k2-1t-a32b", "train_4k")
#: the head's FSDP all-gathers a train step in the reference's HLO of each
#: parity cell: once for the forward's 8 loss chunks, once in each chunk's
#: recompute (``models.model._GatheredHead``; 16 before, one a chunk and
#: pass)
HEAD_GATHERS = 9
#: the cell whose hidden-state all-reduces over 'model' are counted against
#: the reference's: hubert-xlarge (no MoE, no Mamba, a vocabulary the model
#: axis does not divide); 8 in its HLO (5 before: the port summed q's, k's
#: and v's input gradients, and the gate's and up projection's, before
#: reducing them)
HIDDEN_CELL = ("hubert-xlarge", "train_4k")
HIDDEN_ALL_REDUCES = 8
#: the serving cell whose all-gathers are held to the reference's: the
#: embedding lookup in each rank's own block of the table, the table never
#: gathered
GATHER_PARITY = ("falcon-mamba-7b", "decode_32k")
GATHER_ELEMENTS_REL = 5e-2
#: the float8 expert dispatch's cell: one MoE layer of grok-1-314b
#: train_4k, with the dispatch in the compute dtype and in e4m3, held to
#: the reference's lowering of both (kimi-k2's cell, where the experts
#: spread over 'model', is in PARITY and EP_CELL, its e4m3 dispatch held
#: to its bf16 one in the port)
FP8_CELL = ("grok-1-314b", "train_4k")
DISPATCH_DTYPES = ("bfloat16", "float8_e4m3fn")
PARITY_ARGS_REL = 1e-2
#: the fake-against-real config: reduced qwen2-7b, one layer, B 4, S 16
REAL_MESH = (2, 2)
REAL_B, REAL_S = 4, 16
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
#: serving on 2 x 2: reduced qwen2-7b with 6 heads and 3 kv heads (which do
#: not divide the model axis) and reduced jamba (attention, Mamba, MoE)
SERVE_B, SERVE_S, SERVE_STEPS = 4, 12, 2
#: f32 on the host: the mesh only reorders sums (split contractions), ~1e-7
#: relative; 1e-5 leaves a hundredfold margin
SERVE_REL = 1e-5

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def make_mesh(shape, names, *args, **kwargs):
    kwargs.setdefault("axis_types", (AxisType.Auto,) * len(names))
    return _make_mesh(shape, names, *args, **kwargs)


jax.make_mesh = make_mesh
import re
import numpy as np
import repro.launch.dryrun as RD
from hlo_frames import stack_functions

texts = []
_analyze = RD.H.analyze_hlo


def analyze(hlo):
    texts.append(hlo)
    return _analyze(hlo)


RD.H.analyze_hlo = analyze
ONE = {k: (1 if v else 0) for k, v in RD.H._DTYPE_BYTES.items()}


def elements_by_kind(hlo):
    # each collective kind's elements a device, by hlo_analysis's
    # convention (an all-gather's output, any other kind's operands), with
    # its trip-count multipliers: its bytes with every element one byte
    saved = dict(RD.H._DTYPE_BYTES)
    RD.H._DTYPE_BYTES.update(ONE)
    try:
        return _analyze(hlo).collective_bytes
    finally:
        RD.H._DTYPE_BYTES.update(saved)


def collective_rows(hlo):
    # each collective instruction once: [kind, operand shapes (an
    # all-gather's output), elements, calls (trip-count multiplied), the
    # functions on its stack]
    H = RD.H
    comps, shapes, entry = H.parse_module(hlo)
    mult, stack = {}, [(entry, 1.0)]
    while stack:
        name, m = stack.pop()
        if name not in comps:
            continue
        mult[name] = mult.get(name, 0.0) + m
        for inst in comps[name]:
            for callee, k, _ in H._callees(inst):
                stack.append((callee, m * k))
    functions = stack_functions(hlo)
    rows = []
    for cname, insts in comps.items():
        m = mult.get(cname, 0.0)
        for inst in insts if m else ():
            kind = inst.op.replace("-start", "")
            if kind not in H._COLLECTIVES:
                continue
            arrays = (inst.shape,) if kind == "all-gather" else tuple(
                shapes.get(o, "") for o in inst.operands)
            dims = [[int(d) for d in filter(None, ds.split(","))]
                    for a in arrays for _, ds in H._ARRAY_RE.findall(a)]
            rows.append([kind, dims, m * sum(int(np.prod(d)) for d in dims),
                         m, functions(inst.line)])
    return rows


out = {}
for arch, shape, *rest in json.loads(sys.argv[1]):
    extra = rest[0] if rest else {}
    multi_pod = bool(rest[1]) if len(rest) > 1 else False
    result, _ = RD.lower_cell(arch, shape, multi_pod,
                              overrides={"n_layers": 1, **extra})
    gathered = 0
    for m in re.finditer(r"= \w+\[([\d,]*)\]\S* all-gather\(", texts[-1]):
        n = 1
        for d in filter(None, m.group(1).split(",")):
            n *= int(d)
        gathered += n
    key = "/".join([arch, shape, *extra.values()]
                   + (["2x16x16"] if multi_pod else []))
    out[key] = dict(result=result, all_gather_elements=gathered,
                    collective_elements=elements_by_kind(texts[-1]),
                    collective_rows=collective_rows(texts[-1]))
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_cells():
    """The reference's dry run of the parity cells, started at once in its
    subprocess; the result is read when a test first needs it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        (str(ROOT / "src"), str(ROOT / "tools"))))
    fp8 = [(*FP8_CELL, {"moe_dispatch_dtype": dt}) for dt in DISPATCH_DTYPES]
    cells = PARITY + [GATHER_PARITY] + fp8 + [(*MULTIPOD_CELL, {}, True)]
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(cells)],
                            env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    result = {}

    def get():
        if not result:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            result.update(json.loads(out.strip().splitlines()[-1]))
        return result

    yield get
    proc.kill()
    proc.communicate()


def _uneven_serving_cfg():
    return dataclasses.replace(reduced(get_config("qwen2-7b"), repeats=1),
                               n_heads=6, n_kv_heads=3,
                               name="qwen2-7b-reduced-h6")


@pytest.fixture(scope="module")
def launched(reference_cells):
    """One launch of 4 gloo CPU ranks: the accounted train step of the
    fake-against-real config, and the sharded serving steps."""
    serve = [_uneven_serving_cfg(), reduced(get_config("jamba-v0.1-52b"),
                                            repeats=1)]
    return run_ranks(run_jobs, 4, [
        (D.accounted_train_step, (_real_cfg(), OPT, REAL_B, REAL_S,
                                  REAL_MESH, "cpu")),
        (sharded_serving_steps, (serve, SERVE_B, SERVE_S, REAL_MESH, "cpu",
                                 SERVE_STEPS))], device="cpu")


def _real_cfg():
    return reduced(get_config("qwen2-7b"), repeats=1)


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


# --------------------------------------------------------------------------
# hand counts
# --------------------------------------------------------------------------

def test_a_16x16_matmul_counts_its_local_product():
    """(4096 x 3584) @ (3584 x 18944), rows on 'data' and columns on
    'model': each rank multiplies (256 x 3584) by (3584 x 1184), 2 * 256 *
    3584 * 1184 = 2,172,649,472 FLOPs, not the global 5.562e11, and moves
    nothing between ranks."""
    from torch.distributed.tensor import Shard

    acc, placements = D.matmul_probe("cpu")
    assert placements == (Shard(0), Shard(1))
    assert acc.flops == 2 * 256 * 3584 * 1184 == 2_172_649_472
    assert sum(acc.collective_counts.values()) == 0


def test_column_then_row_parallel_mlp_has_one_all_reduce():
    """x (B, S, D) replicated; w1 (D, F) split on columns, w2 (F, D) on
    rows, on a 1 x 4 mesh: the forward's one collective is the all-reduce
    of the (B, S, D) partial sums, B S D * 4 bytes (f32).  The dry run's
    own check of both probes (run on the card by the smoke) agrees."""
    from torch.distributed.tensor import Replicate

    B, S, Dm, F = 2, 8, 16, 32
    assert D.MLP_PROBE == dict(B=B, S=S, D=Dm, F=F)
    acc, placements = D.mlp_probe("cpu")
    assert placements == (Replicate(), Replicate())
    assert acc.collective_counts == dict(
        {k: 0 for k in acc.collective_counts}, **{"all-reduce": 1})
    assert acc.collective_bytes["all-reduce"] == B * S * Dm * 4
    assert acc.flops == 2 * B * S * Dm * (F // 4) * 2
    assert D.check_hand_counts("cpu")["matmul_flops"] == 2_172_649_472


def test_the_accounting_refuses_a_torch_without_the_propagation_modules(
        monkeypatch):
    """Where DTensor's sharding propagation lives in no module the
    accounting knows, it cannot skip the propagation's global ops, and
    refuses to count."""
    monkeypatch.setattr(D, "_PROPAGATION", ("_no_such_module.py",))
    with pytest.raises(RuntimeError, match="sharding propagation"):
        D.Accounting("cpu")


# --------------------------------------------------------------------------
# against the reference's dry run
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_cells():
    """The port's 1-layer traces, each made once: (arch, shape, overrides
    as a sorted tuple, elements) -> (result, rows); with ``elements`` every
    tensor's bytes are taken as its element count."""
    cache = {}

    def get(arch, shape, elements=False, multi_pod=False, **overrides):
        key = (arch, shape, tuple(sorted(overrides.items())), elements,
               multi_pod)
        if key not in cache:
            nbytes = D._nbytes
            if elements:
                D._nbytes = lambda t: t.numel()
            try:
                cache[key] = D.lower_cell(arch, shape, multi_pod, overrides={
                    "n_layers": 1, **overrides}, device="cpu")
            finally:
                D._nbytes = nbytes
        return cache[key]

    def functions(arch, shape, elements=False, multi_pod=False):
        """Each collective row of the trace with the set of the port's
        functions on the stack that issued it (a forward's callers, or the
        backward method of the port's own autograd function)."""
        rows = get(arch, shape, elements, multi_pod)[1]
        return [(r, set(r[4])) for r in rows if r[2] == 0]

    get.functions = functions
    return get


@pytest.mark.parametrize("arch,shape", PARITY)
def test_per_device_counts_match_the_references_dry_run(reference_cells,
                                                         port_cells, arch,
                                                         shape):
    """The port's 1-layer trace on 16 x 16 (the plain path) against the
    reference's compiled HLO: per-device FLOPs within 1 %, argument bytes
    within 1 %, model FLOPs and parameter counts equal, the same keys but
    for the documented additions and Nones.  On EP_CELL also the
    collectives: their elements a device within COLLECTIVE_ELEMENTS_REL
    of the reference's in total, the all-to-alls equal, and no collective
    carrying a slot tensor (G, E, C, D) or its scales: the slots never
    cross ranks, as in the reference's lowering."""
    mine, _ = port_cells(arch, shape)
    ref = reference_cells()[f"{arch}/{shape}"]["result"]
    gap = mine["cost"]["flops_per_device"] / ref["cost"]["flops_per_device"] - 1
    assert abs(gap) < PARITY_FLOPS_REL, gap
    assert _rel(mine["memory"]["argument_bytes"],
                ref["memory"]["argument_bytes"]) < PARITY_ARGS_REL
    for k in ("model_flops", "params", "active_params", "chips", "mesh",
              "arch", "shape"):
        assert mine[k] == ref[k], k
    assert set(ref) <= set(mine)
    assert set(mine) - set(ref) == {"device", "hw", "bytes_by_op",
                                    "collectives_by_part"}
    for part in ("memory", "cost", "collectives", "roofline"):
        assert set(mine[part]) == set(ref[part]), part
    assert mine["cost"]["xla_cost_flops"] is None
    assert set(mine["collectives"]["bytes_by_kind"]) == set(
        ref["collectives"]["bytes_by_kind"])
    assert mine["device"] == "cpu" and mine["hw"]["peak_flops"] == 989.4e12
    if (arch, shape) == EP_CELL:
        _hold_ep_collectives(reference_cells, port_cells, arch, shape)


def _hold_ep_collectives(reference_cells, port_cells, arch, shape):
    from repro_torch.models.moe import capacity

    want = reference_cells()[f"{arch}/{shape}"]["collective_elements"]
    got, rows = port_cells(arch, shape, elements=True)
    got = got["collectives"]["bytes_by_kind"]
    total, ref_total = sum(got.values()), sum(want.values())
    assert abs(total / ref_total - 1) < EP_ELEMENTS_REL, (got, want)
    assert got["all-to-all"] == want["all-to-all"] > 0
    cfg = get_config(arch)
    C = capacity(SHAPES[shape].seq_len, cfg.n_experts,
                 cfg.experts_per_token, cfg.capacity_factor)
    colls = [r for r in rows if r[2] == 0]          # the collectives' rows
    slots = [r for r in colls if any(len(s) == 4 and s[2] == C
                                     for s in r[1])]
    assert not slots, slots
    # attention: q and the output stay on their heads' shards (no
    # collective of a (B, S, H / M, hd) tensor); k and v, (B, S, Kv hd / M)
    # a rank, are gathered over 'model' and their gradients reduced back
    M, hd, S = 16, cfg.head_dim, SHAPES[shape].seq_len
    assert not [r for r in colls if any(s[-2:] == (cfg.n_heads // M, hd)
                                        for s in r[1])]
    kv = [r for r in colls if any(len(s) == 3 and s[1] == S and s[2] ==
                                  cfg.n_kv_heads * hd // M for s in r[1])]
    assert kv and all(r[0].endswith(" @model") for r in kv)
    assert sum(r[3] for r in kv) <= ATTENTION_REL * ATTENTION_REF_ELEMENTS


def test_mamba_cell_collectives_match_the_references(reference_cells,
                                                      port_cells):
    """MAMBA_CELL: the port's collective elements a device within
    COLLECTIVE_ELEMENTS_REL of the reference's in total; no all-gather
    yields in_proj's whole (B, L, 2 Di) product (a rank's batch, the whole
    sequence, both halves); its halves move over 'model' as the
    reference's partitioner moves them, four permutes a pass of 2 w, w, w
    and w columns (w = Di / M) in the forward and its recompute, and w
    columns back for each in the backward, and the group's elements are
    within COLLECTIVE_ELEMENTS_REL of the reference's (its collective-
    permutes and all-to-alls of w or 2 w columns)."""
    arch, shape = MAMBA_CELL
    want = reference_cells()[f"{arch}/{shape}"]["collective_elements"]
    got, rows = port_cells(arch, shape, elements=True)
    total = sum(got["collectives"]["bytes_by_kind"].values())
    assert abs(total / sum(want.values()) - 1) < COLLECTIVE_ELEMENTS_REL, (
        got["collectives"]["bytes_by_kind"], want)
    cfg, cell = get_config(arch), SHAPES[shape]
    B, L, Di = cell.global_batch // 16, cell.seq_len, cfg.d_inner
    colls = [r for r in rows if r[2] == 0]
    gathers = [r for r in colls if "all_gather" in r[0]]
    assert gathers and all(r[3] != B * L * 2 * Di for r in gathers)
    # the reference's four permutes a pass (2 w, w, w, w columns) in the
    # forward and its recompute, w columns back for each in the backward
    w = Di // 16
    halves = [r for r in colls if "all_to_all_single" in r[0]
              and r[0].endswith(" @model")]
    assert sorted(r[1][0] for r in halves) == sorted(
        [(B, L, 2 * w)] * 2 + [(B, L, w)] * 10)
    ref = [r for r in reference_cells()[f"{arch}/{shape}"][
        "collective_rows"] if r[0] == "collective-permute" and r[1][0][
        -1] in (w, 2 * w)]
    group = sum(r[3] for r in halves)
    want_group = sum(r[2] for r in ref) + sum(
        r[2] for r in reference_cells()[f"{arch}/{shape}"][
            "collective_rows"] if r[0] == "all-to-all" and r[1][0][-1] in (
            w, 2 * w) and len(r[1]) == 16)
    assert abs(group / want_group - 1) < COLLECTIVE_ELEMENTS_REL, (
        group, want_group)


@pytest.mark.parametrize("arch,shape", PARITY)
def test_cell_collectives_match_the_references(reference_cells, port_cells,
                                               arch, shape):
    """Each parity cell's collective elements a device, all kinds in total,
    within COLLECTIVE_ELEMENTS_REL of the reference's (EP_CELL within
    EP_ELEMENTS_REL).  Kinds are not compared: XLA's CPU backend forms no
    reduce-scatter (the port's reduce-scatters are its all-reduces, equal
    in elements)."""
    want = sum(reference_cells()[f"{arch}/{shape}"][
        "collective_elements"].values())
    got, _ = port_cells(arch, shape, elements=True)
    total = sum(got["collectives"]["bytes_by_kind"].values())
    bound = EP_ELEMENTS_REL if (arch, shape) == EP_CELL else \
        COLLECTIVE_ELEMENTS_REL
    assert abs(total / want - 1) < bound, (total, want)


@pytest.mark.parametrize("arch,shape", PARITY)
def test_head_gathers_match_the_references(reference_cells, port_cells, arch,
                                           shape):
    """The head weight's d_model (FSDP) shard is all-gathered over 'data'
    as many times a step as the reference's HLO gathers it, HEAD_GATHERS
    (once for the forward's loss chunks, once in each chunk's recompute),
    and the same elements: (D, V / M) gathered, V / M = V where the model
    axis does not divide the vocabulary."""
    cfg = get_config(arch)
    Dm, V, M = cfg.d_model, cfg.vocab_size, 16
    Vl = V // M if V % M == 0 else V
    ref = [r for r in reference_cells()[f"{arch}/{shape}"]["collective_rows"]
           if r[0] == "all-gather" and r[1] == [[Dm, Vl]]]
    _, rows = port_cells(arch, shape, elements=True)
    mine = [r for r in rows if r[2] == 0 and "all_gather" in r[0]
            and r[0].endswith(" @data") and r[1] == [(Dm // M, Vl)]]
    assert len(mine) == sum(r[3] for r in ref) == HEAD_GATHERS
    assert sum(r[3] for r in mine) == sum(r[2] for r in ref) > 0


def test_hidden_state_all_reduces_match_the_references(reference_cells,
                                                       port_cells):
    """HIDDEN_CELL's hidden state (B / 16, S, D) is all-reduced over
    'model' as many times a step as in the reference's HLO,
    HIDDEN_ALL_REDUCES: attention's and the MLP's outputs in the forward,
    attention's in the recompute, and in the backward each of the five
    column-parallel products' input gradients on its own
    (``act.reduced_grad``), as the reference's partitioner reduces each
    product's partial sum."""
    arch, shape = HIDDEN_CELL
    cfg, cell = get_config(arch), SHAPES[shape]
    whole = [cell.global_batch // 16, cell.seq_len, cfg.d_model]
    ref = sum(r[3] * r[1].count(whole) for r in reference_cells()[
        f"{arch}/{shape}"]["collective_rows"] if r[0] == "all-reduce")
    _, rows = port_cells(arch, shape, elements=True)
    mine = [r for r in rows if r[2] == 0 and "all_reduce" in r[0]
            and r[0].endswith(" @model") and r[1] == [tuple(whole)]]
    assert len(mine) == ref == HIDDEN_ALL_REDUCES


def test_multipod_embedding_moves_the_table_as_the_reference(
        reference_cells, port_cells):
    """MULTIPOD_CELL's embedding lookup, where the batch lies on ('pod',
    'data') and the table's D on 'data' alone: the table moves (a permute
    over 'data' and 'model', its rows gathered over 'data'; the gradient
    summed over ('pod', 'data') in one all-reduce and permuted back) and
    the looked-up rows are gathered over 'model', as in the reference's
    HLO; the group's elements (the collectives issued under the lookup or
    by its backward) within COLLECTIVE_ELEMENTS_REL of the reference's
    (its collectives whose stack holds ``_embed_in``)."""
    arch, shape = MULTIPOD_CELL
    ref = sum(r[2] for r in reference_cells()[f"{arch}/{shape}/2x16x16"][
        "collective_rows"] if "_embed_in" in r[4])
    rows = port_cells.functions(arch, shape, elements=True, multi_pod=True)
    group = [(r, f) for r, f in rows
             if f & {"_embed_in", "_TableToColumns.backward"}]
    mine = sum(r[3] for r, _ in group)
    assert ref > 0 and abs(mine / ref - 1) < COLLECTIVE_ELEMENTS_REL, (
        mine, ref)
    assert any("_TableToColumns.backward" in f for _, f in group)


@pytest.mark.parametrize("arch,shape", PARITY)
def test_optimizer_sums_in_one_all_reduce_per_axes(port_cells, arch, shape):
    """The optimizer step's collectives are all-reduces: the replicated
    leaves' gradient sums one per (mesh axes, dtype) (the parameters'
    dtypes: bf16, and f32 for Mamba's A_log and D), and the global norm's
    square-sums one over the whole mesh."""
    from repro_torch import tree as T
    from repro_torch.launch.specs import train_state_specs

    cfg = get_config(arch)
    params, _ = train_state_specs(cfg, OPT)
    dtypes = len({p.dtype for p in T.leaves(params)})
    got, _ = port_cells(arch, shape, elements=True)
    opt = got["collectives_by_part"]["optimizer"]
    whole = "all-reduce @data+model"
    assert 1 <= opt[whole] <= 1 + dtypes, opt
    assert all(k.startswith("all-reduce @") and n <= dtypes
               for k, n in opt.items() if k != whole), opt


def test_optimizer_collectives_equal_the_card_smokes():
    """chip_smoke's SHARDED_OPTIMIZER_COLLECTIVES, which each rank of the
    card's sharded_train step (torch 2.11) must count, is what the dry
    run's CPU trace of that config counts on this torch (the depth and
    width of the smoke's; a short sequence: the optimizer does not see
    it)."""
    from repro_torch.serve import serving_config
    from test_torch_harness import load_chip_smoke

    smoke = load_chip_smoke()
    cfg = serving_config(smoke.SHARDED_ARCH, layers=smoke.SHARDED_LAYERS)
    data, model = smoke.SHARDED_MESH
    pred, _ = D.trace_step(cfg, ShapeSpec("t", 64, smoke.SHARDED_BATCH,
                                          "train"),
                           dict(data=data, model=model), device="cpu")
    assert pred["collectives_by_part"]["optimizer"] == \
        smoke.SHARDED_OPTIMIZER_COLLECTIVES


def _per_axis_pairs(rows, axes=("pod", "data")) -> list:
    """Consecutive collectives of one kind, one over each of ``axes``: a
    change over both made one axis at a time."""
    colls = [r[0].rsplit(" @", 1) for r in rows if r[2] == 0]
    return [(a, b) for a, b in zip(colls, colls[1:])
            if len(a) == len(b) == 2 and a[0] == b[0]
            and {a[1], b[1]} == set(axes)]


def test_multipod_cell_sums_over_pod_and_data_at_once(reference_cells,
                                                       port_cells):
    """MULTIPOD_CELL at 2 x 16 x 16: FLOPs within PARITY_FLOPS_REL and
    collective elements within COLLECTIVE_ELEMENTS_REL of the reference's;
    the whole-batch combine (B, S, D) is all-reduced twice, over 'model'
    and over 'pod' and 'data' at once (three times before, one an axis),
    and no change over ('pod', 'data') runs one collective an axis."""
    arch, shape = MULTIPOD_CELL
    ref = reference_cells()[f"{arch}/{shape}/2x16x16"]
    mine, _ = port_cells(arch, shape, multi_pod=True)
    gap = (mine["cost"]["flops_per_device"]
           / ref["result"]["cost"]["flops_per_device"] - 1)
    assert abs(gap) < PARITY_FLOPS_REL, gap
    assert mine["chips"] == ref["result"]["chips"] == 512
    got, rows = port_cells(arch, shape, elements=True, multi_pod=True)
    total = sum(got["collectives"]["bytes_by_kind"].values())
    want = sum(ref["collective_elements"].values())
    assert abs(total / want - 1) < COLLECTIVE_ELEMENTS_REL, (
        got["collectives"]["bytes_by_kind"], ref["collective_elements"])
    cfg, cell = get_config(arch), SHAPES[shape]
    whole = cell.global_batch * cell.seq_len * cfg.d_model
    combine = sorted(r[0].rsplit(" @", 1)[1] for r in rows
                     if r[2] == 0 and "all_reduce" in r[0] and r[3] == whole)
    assert combine == ["model", "pod+data"], combine
    assert not _per_axis_pairs(rows)
    assert D.collective_axes(rows)["pod+data"]["count"] > 0


def test_decode_all_gathers_match_the_references_dry_run(reference_cells,
                                                         monkeypatch):
    """falcon-mamba-7b decode_32k, 1 layer, 16 x 16: the elements the
    port's step all-gathers a device (the head's and in_proj's FSDP shards,
    the tokens, the logits; not the (V, D) embedding table, which each
    rank reads in its own block) within 5 % of the reference's HLO
    all-gathers.  Elements, not bytes: XLA's CPU backend widens the bf16
    gathers to f32 (``all-gather`` of a ``convert``), so its bytes are
    twice a TPU's.  The port's trace is counted once more with every
    tensor's bytes taken as its element count."""
    arch, shape = GATHER_PARITY
    want = reference_cells()[f"{arch}/{shape}"]["all_gather_elements"]
    monkeypatch.setattr(D, "_nbytes", lambda t: t.numel())
    mine, _ = D.lower_cell(arch, shape, False, overrides={"n_layers": 1},
                           device="cpu")
    got = mine["collectives"]["bytes_by_kind"]["all-gather"]
    assert want > 0 and abs(got / want - 1) < GATHER_ELEMENTS_REL, (got,
                                                                    want)


@pytest.fixture(scope="module")
def fp8_cells(port_cells):
    """The port's 1-layer trace of FP8_CELL with each dispatch dtype."""
    return {dt: port_cells(*FP8_CELL, moe_dispatch_dtype=dt)[0]
            for dt in DISPATCH_DTYPES}


@pytest.mark.parametrize("dispatch", DISPATCH_DTYPES)
def test_fp8_dispatch_cell_matches_the_references_dry_run(
        reference_cells, fp8_cells, dispatch):
    """grok-1-314b train_4k, one layer, 16 x 16, with the dispatch in the
    compute dtype and in e4m3: the port's trace (no longer refused) within
    PARITY_FLOPS_REL of the reference's per-device FLOPs, with the same
    model FLOPs and parameter counts."""
    mine = fp8_cells[dispatch]
    ref = reference_cells()["/".join((*FP8_CELL, dispatch))]["result"]
    gap = mine["cost"]["flops_per_device"] / ref["cost"]["flops_per_device"] - 1
    assert abs(gap) < PARITY_FLOPS_REL, gap
    for k in ("model_flops", "params", "active_params", "chips"):
        assert mine[k] == ref[k], k


def test_fp8_dispatch_changes_the_collectives_as_the_reference_does(
        reference_cells, fp8_cells):
    """Each collective kind's bytes and calls with the e4m3 dispatch, over
    those with the compute dtype's, are the same ratio in both packages:
    1.  The cell's token groups lie on 'data' only, so the EP constraint
    (groups on 'data', experts on 'model') is a local slice in both
    GSPMD's lowering and the port's: no dispatch exchange to shrink, and
    the port's backward sums the slots' partial gradients in the compute
    dtype before their cast to e4m3, as GSPMD does, never as float8
    partials.  The FLOPs do not change either (the quantize is
    elementwise)."""
    ref = {dt: reference_cells()["/".join((*FP8_CELL, dt))]["result"]
           for dt in DISPATCH_DTYPES}
    for cells in (ref, fp8_cells):
        bf, f8 = (cells[dt]["collectives"] for dt in DISPATCH_DTYPES)
        assert f8["bytes_by_kind"] == bf["bytes_by_kind"]
        assert f8["count_by_kind"] == bf["count_by_kind"]
        assert (cells[DISPATCH_DTYPES[1]]["cost"]["flops_per_device"]
                == cells[DISPATCH_DTYPES[0]]["cost"]["flops_per_device"])


def test_ep_cell_collectives_are_equal_with_either_dispatch(port_cells):
    """kimi-k2's cell, where the experts spread over 'model': the port's
    collectives by kind, in calls and bytes, and its FLOPs are equal with
    the dispatch in bf16 and in e4m3.  Each rank gathers and quantizes its
    own experts' slots, so no payload crosses the EP boundary to shrink
    (the reference's slots never cross ranks either)."""
    bf = port_cells(*EP_CELL)[0]                   # bf16: its own dtype
    f8 = port_cells(*EP_CELL, moe_dispatch_dtype=DISPATCH_DTYPES[1])[0]
    assert get_config(EP_CELL[0]).moe_dispatch_dtype == DISPATCH_DTYPES[0]
    assert f8["collectives"] == bf["collectives"]
    assert f8["cost"]["flops_per_device"] == bf["cost"]["flops_per_device"]


def test_float8_elements_count_one_byte():
    """The accounting's bytes of a float8 tensor: one an element."""
    t = torch.zeros(3, 5, dtype=torch.float8_e4m3fn)
    assert D._nbytes(t) == 15
    assert D._nbytes(t.float()) == 60


# --------------------------------------------------------------------------
# fake against real, and the sharded serving steps
# --------------------------------------------------------------------------

def test_fake_trace_predicts_what_each_rank_counts(launched):
    """The 2 x 2 fake trace of the reduced step, rank 0's view, equals
    what each real gloo rank counts on its own step: FLOPs, and
    collectives by kind in calls and bytes."""
    cfg = _real_cfg()
    pred, _ = D.trace_step(cfg, ShapeSpec("t", REAL_S, REAL_B, "train"),
                           {"data": 2, "model": 2}, device="cpu")
    for rank in launched:
        got = rank[0]
        assert got["flops"] == pred["cost"]["flops_per_device"] > 0
        assert got["collective_bytes"] == pred["collectives"]["bytes_by_kind"]
        assert got["collective_counts"] == pred["collectives"]["count_by_kind"]
    assert pred["collectives"]["count_by_kind"]["all-reduce"] > 0


def _single_serving(cfg):
    """The single-device prefill and decode steps from the same seed,
    tokens and positions."""
    from repro_torch.models.model import init_params

    L = SERVE_S + SERVE_STEPS
    params = init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": train_batch(cfg, SERVE_B, SERVE_S, "cpu")["tokens"]}
    logits, caches = make_prefill_step(cfg, max_len=L)(params, batch)
    steps, after = [logits], [whole_leaves(caches)]
    decode = make_decode_step(cfg)
    for i, tok in enumerate(serving_tokens(cfg, SERVE_B, SERVE_STEPS)):
        logits, caches = decode(params, torch.from_numpy(tok), caches,
                                torch.tensor(SERVE_S + i, dtype=torch.int32))
        steps.append(logits)
    after.append(whole_leaves(caches))
    return [t.numpy() for t in steps], after


@pytest.mark.parametrize("case", range(2))
def test_sharded_serving_steps_match_single_device(launched, case):
    """Prefill logits and caches, and two decode steps' logits and caches,
    on a 2 x 2 mesh (parameters, batch and caches placed by the rules)
    against one device, within 1e-5 relative (f32)."""
    row = launched[0][1][case]
    cfg = [_uneven_serving_cfg(), reduced(get_config("jamba-v0.1-52b"),
                                          repeats=1)][case]
    assert row["arch"] == cfg.name
    logits, caches = _single_serving(cfg)
    assert len(row["logits"]) == len(logits) == 1 + SERVE_STEPS
    for got, want in zip(row["logits"], logits, strict=True):
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= SERVE_REL * np.linalg.norm(want)
    for got, want in zip(row["caches"], caches, strict=True):
        assert sorted(got) == sorted(want)
        for j in want:
            scale = max(np.linalg.norm(want[j]), 1.0)
            assert np.linalg.norm(got[j] - want[j]) <= SERVE_REL * scale, j


def test_decode_with_a_tensor_position_is_bit_for_bit_the_int_one():
    """A 0-d tensor position (read on the device, never on the host) gives
    the int position's logits and caches bit for bit."""
    from repro_torch.models.model import init_params

    cfg = reduced(get_config("jamba-v0.1-52b"), repeats=1)
    params = init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": train_batch(cfg, 2, 6, "cpu")["tokens"]}
    _, caches = make_prefill_step(cfg, max_len=8)(params, batch)
    tok = torch.tensor([3, 5])
    a = make_decode_step(cfg)(params, tok, caches, 6)
    b = make_decode_step(cfg)(params, tok, caches,
                              torch.tensor(6, dtype=torch.int32))
    for x, y in zip(whole_leaves(a).values(), whole_leaves(b).values(),
                    strict=True):
        assert np.array_equal(x, y)


# --------------------------------------------------------------------------
# cells, the world, the repairs, the hill-climb
# --------------------------------------------------------------------------

def test_cell_list_and_tags_equal_the_references(reference_cells):
    """--all --both-meshes: every config but lm100m times its cells_for
    times both meshes, as the reference lists them, with its tags."""
    from test_torch_harness import load_reference

    ref = load_reference()
    base = ref.config_base
    want = [(a, s.name, mp) for a in base.list_configs() if a != "lm100m"
            for s in base.cells_for(base.get_config(a)) for mp in (False, True)]
    assert D.cell_list(True, both_meshes=True) == want
    assert [D.cell_tag(*c) for c in want[:2]] == [
        f"{want[0][0]}__{want[0][1]}__16x16",
        f"{want[0][0]}__{want[0][1]}__2x16x16"]


def _dtensors() -> int:
    from torch.distributed.tensor import DTensor

    gc.collect()
    return sum(type(o) is DTensor for o in gc.get_objects())


def test_cells_leave_no_process_group_or_tensors_behind():
    """A cell makes its fake world and takes it down, and keeps no DTensor
    alive; inside a group of another size it refuses to run."""
    import torch.distributed as dist

    for _ in range(2):
        D.lower_cell("falcon-mamba-7b", "long_500k", False,
                     overrides={"n_layers": 1}, device="cpu")
        assert not dist.is_initialized()
    before = _dtensors()
    D.lower_cell("falcon-mamba-7b", "long_500k", False,
                 overrides={"n_layers": 1}, device="cpu")
    assert _dtensors() == before
    with D.fake_world(4):
        with pytest.raises(RuntimeError, match="fake one of 256"):
            D.lower_cell("falcon-mamba-7b", "long_500k", False,
                         overrides={"n_layers": 1}, device="cpu")


#: rank 0's (query heads, kv heads) in the padded layout at 16 x 16
UNEVEN_RANK0_HEADS = {"qwen2-7b": (7, 1), "gemma-2b": (1, 1)}


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma-2b"])
def test_uneven_heads_train_step_completes_at_16x16(arch, monkeypatch):
    """28 and 8 query heads on a 16-wide model axis: the step runs the
    padded-heads layout (each model rank its own kv group, or its own
    query head of gemma-2b's one kv head) and completes.  Rank 0's
    attention gets its query heads and each of its kv heads once (qwen2-7b:
    7 query heads over 1 kv head, not the kv head copied 7 times)."""
    from repro_torch.models import transformer as T

    seen = []
    attend = T._attend

    def recording(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return attend(q, k, v, **kw)

    monkeypatch.setattr(T, "_attend", recording)
    result, _ = D.lower_cell(arch, "train_4k", False,
                             overrides={"n_layers": 1}, device="cpu")
    assert result["cost"]["flops_per_device"] > 0
    assert result["memory"]["argument_bytes"] > 0
    nq, nkv = UNEVEN_RANK0_HEADS[arch]
    assert seen and set(seen) == {(nq, nkv, nkv)}, seen


def test_the_cli_needs_a_card_unless_asked(tmp_path):
    """Without --device cpu the tool traces the card's program, and raises
    where there is none; with it, it traces the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k",
                "--out", str(tmp_path)])


def test_hillclimb_writes_its_variant_and_refuses_fp8(tmp_path, monkeypatch,
                                                      capsys):
    """The hill-climb writes its artifact and line beside the baseline; the
    reference's documented variant, the float8 dispatch, which the port
    refused before it carried it, now traces and writes its JSON too."""
    from repro_torch.launch import hillclimb

    monkeypatch.chdir(tmp_path)
    base = tmp_path / "experiments" / "dryrun"
    base.mkdir(parents=True)
    tag = "falcon-mamba-7b__long_500k__16x16"
    (base / f"{tag}.json").write_text(json.dumps(dict(roofline=dict(
        compute_s=1.0, memory_s=2.0, collective_s=3.0,
        dominant="collective"))))
    line = hillclimb.main(["--arch", "falcon-mamba-7b", "--shape",
                           "long_500k", "--variant", "one_layer",
                           "--overrides", '{"n_layers": 1}', "--device",
                           "cpu", "--out", "perf"])
    assert line in capsys.readouterr().out
    assert line.startswith("one_layer: compute=")
    assert "(baseline: 1.0000/2.0000/3.0000 collective)" in line
    got = json.loads((tmp_path / "perf" / f"{tag}__one_layer.json")
                     .read_text())
    assert got["variant"] == "one_layer"
    assert got["overrides"] == {"n_layers": 1}
    fp8 = {"moe_dispatch_dtype": "float8_e4m3fn", "n_layers": 1}
    line = hillclimb.main(["--arch", "grok-1-314b", "--shape", "train_4k",
                           "--variant", "fp8_dispatch", "--overrides",
                           json.dumps(fp8), "--device", "cpu", "--out",
                           "perf"])
    assert line.startswith("fp8_dispatch: compute=")
    got = json.loads((tmp_path / "perf" /
                      "grok-1-314b__train_4k__16x16__fp8_dispatch.json")
                     .read_text())
    assert got["variant"] == "fp8_dispatch" and got["overrides"] == fp8
    assert got["arch"] == "grok-1-314b" and got["cost"][
        "flops_per_device"] > 0
