"""The port's training-workload path — the sharding-rule table
(``parallel/sharding``), the workload lowering (``core/workloads``) and its
entry points (``Analysis.simulate(workload=)``, ``survey(workload=)``,
``fault_sweep(workload=)``) — against the JAX reference on the CPU.

Follows the reference's ``tests/test_workloads.py`` case for case, with the
port on ``device="cpu"``, and adds parity with the reference itself: the
partition specs, the plans (every field, the same closed-form arithmetic)
and the synthetic HLO are held exactly for every model config and layout;
simulated times within 1e-5 relative (the reference's ECMP loads are
float32, the port's float64); placement is numpy in both, so identical.
Every simulated time is a second of the modeled cluster.  Tests marked
``cuda`` run on the card and skip elsewhere.
"""
import dataclasses
import importlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import Analysis, WORKLOAD_COLUMNS, build, survey
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.core import faults as F
from repro_torch.core import workloads as W
from repro_torch.core.placement import place_ranks
from repro_torch.models.moe import capacity
from repro_torch.parallel import sharding as PSH
from test_torch_harness import ROOT, load_chip_smoke, load_reference

CPU = "cpu"
DENSE = "qwen2_7b"          # prefix of qwen2-7b (dense, 28 attn+mlp layers)
MOE = "grok_1_314b"         # prefix of grok-1-314b (8 experts, all-MoE)
#: simulated times: float64 ECMP in the port, float32 in the reference
SIM_REL_TOL = 1e-5
#: (dp, tp) layouts the rule table and the plans are held to; tp = 3
#: exercises the divisibility guard
LAYOUTS = [(1, 1), (2, 2), (16, 4), (64, 8), (8, 3)]
EPS = (1, 2, 8)


@pytest.fixture(scope="module")
def ref():
    r = load_reference()
    for name in ("repro.core.workloads", "repro.parallel.sharding",
                 "repro.launch.hlo_analysis"):
        setattr(r, name.rsplit(".", 1)[-1], importlib.import_module(name))
    return r


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread avoids oversubscribing the
    cores the test workers and the JAX reference share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_topo(ref, g):
    return ref.graphs.Topology(
        g.name, g.n, g.edges.copy(),
        loops=None if g.loops is None else g.loops.copy(), meta=dict(g.meta))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _same_structure(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same_structure(x, y) for x, y in zip(a, b))
    return not isinstance(b, (dict, list))


# --------------------------------------------------------------------------
# spec parsing
# --------------------------------------------------------------------------

def test_parse_resolves_prefix_and_round_trips(ref):
    ws = W.parse_workload(f"{MOE}@dp=8,tp=2,ep=4")
    assert ws.arch == "grok-1-314b"          # unique-prefix resolution
    assert (ws.dp, ws.tp, ws.ep) == (8, 2, 4)
    assert ws.world == 16
    assert W.parse_workload(ws.spec) == ws   # canonical string round-trips
    assert W.parse_workload(ws) is ws
    assert ws.spec == ref.workloads.parse_workload(
        f"{MOE}@dp=8,tp=2,ep=4").spec


def test_parse_defaults_and_shape_key():
    ws = W.parse_workload(DENSE)
    assert (ws.dp, ws.tp, ws.ep, ws.shape) == (1, 1, 1, "train_4k")
    assert "shape=" not in ws.spec           # default shape omitted
    ws2 = W.parse_workload(f"{DENSE}@dp=2,shape=train_4k")
    assert ws2.shape == "train_4k"


@pytest.mark.parametrize("bad", [
    "no_such_model@dp=2",                    # unknown model
    "qwen2@dp=2",                            # ambiguous: qwen2-7b / qwen2-vl-7b
    f"{DENSE}@zz=3",                         # unknown key
    f"{DENSE}@dp",                           # missing =value
    f"{DENSE}@dp=x",                         # non-integer
    f"{DENSE}@dp=0",                         # < 1
    f"{DENSE}@dp=7",                         # 7 does not divide global_batch 256
    f"{DENSE}@dp=4,ep=2",                    # dense arch cannot take ep > 1
    f"{MOE}@dp=4,ep=8",                      # ep must divide dp
    f"{MOE}@dp=6,ep=3",                      # ep must divide n_experts (8)
    f"{DENSE}@shape=decode_32k",             # non-train shape
    f"{DENSE}@shape=nope",                   # unknown shape
])
def test_parse_rejects_invalid_specs(ref, bad):
    with pytest.raises(W.WorkloadSpecError) as mine:
        W.parse_workload(bad)
    # WorkloadSpecError is a ValueError, so generic handlers still catch it
    with pytest.raises(ValueError):
        W.parse_workload(bad)
    with pytest.raises(ref.workloads.WorkloadSpecError) as theirs:
        ref.workloads.parse_workload(bad)
    assert str(mine.value) == str(theirs.value)


# --------------------------------------------------------------------------
# the sharding-rule table and the plans, against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_configs())
def test_param_pspecs_equal_the_reference(ref, arch):
    """Leaf for leaf, as tuples, on the logical (data=dp, model=tp) mesh;
    the shape trees carry plain tuples here and ``Shape`` leaves there."""
    cfg, rcfg = get_config(arch), ref.config_base.get_config(arch)
    for dp, tp in LAYOUTS:
        mine = PSH.param_pspecs(cfg, W._LogicalMesh(dp, tp))
        theirs = ref.sharding.param_pspecs(
            rcfg, ref.workloads._LogicalMesh(dp, tp))
        assert _same_structure(mine, theirs), (arch, dp, tp)
        got = [tuple(p) for p in _leaves(mine)]
        want = [tuple(p) for p in _leaves(theirs)]
        assert got == want, (arch, dp, tp)
        assert all(isinstance(p, PSH.P) for p in _leaves(mine))


@pytest.mark.parametrize("arch", list_configs())
def test_plans_and_hlo_equal_the_reference(ref, arch):
    """Every valid layout of every config: the spec checks agree, and each
    plan equals the reference's field for field (``==``) with the same
    synthetic HLO text and the same audit."""
    planned = 0
    for dp, tp in LAYOUTS:
        for ep in EPS:
            spec = f"{arch}@dp={dp},tp={tp},ep={ep}"
            try:
                want = ref.workloads.plan_workload(spec)
            except ref.workloads.WorkloadSpecError as e:
                with pytest.raises(W.WorkloadSpecError, match=re.escape(
                        str(e))):
                    W.plan_workload(spec)
                continue
            got = W.plan_workload(spec)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), spec
            assert got.collective_byte_totals() == \
                want.collective_byte_totals(), spec
            assert got.to_hlo() == want.to_hlo(), spec
            assert got.report() == want.report(), spec
            assert W.hlo_crosscheck(got) == ref.workloads.hlo_crosscheck(
                want), spec
            planned += 1
    assert planned >= len(LAYOUTS)


# --------------------------------------------------------------------------
# closed-form byte pins
# --------------------------------------------------------------------------

def test_dp_allreduce_bytes_equal_param_bytes_at_tp1():
    """With no tensor parallelism every gradient element is all-reduced, so
    the DP phase total must equal the parameter bytes exactly — and both must
    match the analytic ``param_count`` at the param dtype width."""
    plan = W.plan_workload(f"{DENSE}@dp=8")
    cfg = get_config(plan.spec.arch)
    assert plan.param_bytes == cfg.param_count() * 2          # bf16 params
    assert plan.grad_bytes_per_rank == pytest.approx(plan.param_bytes)
    ar = plan.phase("dp_allreduce")
    assert ar.total_bytes == pytest.approx(plan.grad_bytes_per_rank)
    assert ar.ops_per_step == int(np.ceil(plan.param_bytes / W.BUCKET_BYTES))
    assert ar.bytes_per_rank <= W.BUCKET_BYTES


def test_tp_shard_factor_shrinks_dp_bytes():
    """tp=2 halves every 'model'-sharded gradient; the DP total must drop
    strictly below the parameter bytes but stay above bytes/tp (norms and
    the router stay replicated)."""
    p1 = W.plan_workload(f"{DENSE}@dp=8")
    p2 = W.plan_workload(f"{DENSE}@dp=8,tp=2")
    assert p2.grad_bytes_per_rank < p1.grad_bytes_per_rank
    assert p2.grad_bytes_per_rank > p1.grad_bytes_per_rank / 2


def test_tp_phase_moves_full_activation_per_op():
    plan = W.plan_workload(f"{DENSE}@dp=4,tp=2")
    cfg = get_config(plan.spec.arch)
    shape = SHAPES["train_4k"]
    tokens_rank = shape.global_batch * shape.seq_len // 4
    assert plan.tokens_per_rank == tokens_rank
    ag = plan.phase("tp_allgather")
    rs = plan.phase("tp_reducescatter")
    # each op carries the full tokens x d_model activation in compute dtype
    assert ag.bytes_per_rank == tokens_rank * cfg.d_model * 2
    assert rs.bytes_per_rank == ag.bytes_per_rank
    # attn (wq/wo) + dense mlp (wg/wd) = 2 sharded pairs per layer, fwd+bwd
    assert ag.ops_per_step == 2 * (2 * cfg.n_layers)
    assert rs.ops_per_step == ag.ops_per_step


def test_moe_phase_matches_padded_slot_tensor():
    plan = W.plan_workload(f"{MOE}@dp=8,ep=4")
    cfg = get_config(plan.spec.arch)
    shape = SHAPES["train_4k"]
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(shape.seq_len, E, k, cfg.capacity_factor)
    groups_per_rank = shape.global_batch // 8
    slot_elems = groups_per_rank * E * C * cfg.d_model
    disp = plan.phase("moe_dispatch")
    comb = plan.phase("moe_combine")
    disp_width = W._DTYPE_BYTES[cfg.moe_dispatch_dtype]
    assert disp.bytes_per_rank == slot_elems * disp_width
    assert comb.bytes_per_rank == slot_elems * 2      # bf16 return legs
    moe_layers = sum(1 for s in cfg.pattern if s.moe) * cfg.n_repeats
    assert disp.ops_per_step == moe_layers
    assert comb.ops_per_step == 3 * moe_layers        # fwd return + 2 bwd legs


def test_dense_plan_has_no_moe_phase_and_dp1_no_allreduce():
    plan = W.plan_workload(f"{DENSE}@tp=2")
    names = [p.name for p in plan.phases]
    assert "dp_allreduce" not in names                # dp=1: nothing to reduce
    assert "moe_dispatch" not in names
    with pytest.raises(KeyError):
        plan.phase("moe_dispatch")


# --------------------------------------------------------------------------
# logical demand invariants
# --------------------------------------------------------------------------

def test_all_to_all_demand_row_sums_are_routed_fraction(ref):
    """Each rank keeps 1/ep of its slot tensor local; the off-diagonal demand
    row must sum to exactly bytes_per_rank * (ep-1)/ep — and the matrix is
    the reference's, entry for entry."""
    plan = W.plan_workload(f"{MOE}@dp=8,ep=4")
    phase = plan.phase("moe_dispatch")
    groups = W._phase_groups(plan, "ep")
    assert len(groups) == 2                           # (dp/ep) * tp groups
    node_of = np.arange(plan.world)                   # identity placement
    D, rounds = W._phase_demand(phase, groups, node_of, plan.world)
    want = phase.bytes_per_rank * (4 - 1) / 4
    np.testing.assert_allclose(D.sum(axis=1), want, rtol=1e-12)
    assert rounds == phase.ops_per_step               # a2a: one round per op
    rplan = ref.workloads.plan_workload(f"{MOE}@dp=8,ep=4")
    rD, rrounds = ref.workloads._phase_demand(
        rplan.phase("moe_dispatch"), ref.workloads._phase_groups(rplan, "ep"),
        node_of, plan.world)
    np.testing.assert_array_equal(D, rD)
    assert rounds == rrounds


def test_ring_demand_rounds_and_per_edge_payload():
    plan = W.plan_workload(f"{DENSE}@dp=4,tp=2")
    ar = plan.phase("dp_allreduce")
    groups = W._phase_groups(plan, "dp")
    node_of = np.arange(plan.world)
    D, rounds = W._phase_demand(ar, groups, node_of, plan.world)
    # ring all-reduce: 2(g-1) rounds of 1/g payload along each group edge
    assert rounds == 2 * (4 - 1) * ar.ops_per_step
    np.testing.assert_allclose(D.sum(axis=1), ar.bytes_per_rank / 4,
                               rtol=1e-12)
    # DP groups stride by tp, so rank r talks to r +- tp, never r +- 1
    assert D[0, 1] == 0.0 and D[0, 2] > 0.0


def test_colocated_ranks_communicate_for_free():
    """Oversubscription folds whole TP groups onto one node under linear
    placement; their demand lands on the (zeroed) diagonal."""
    plan = W.plan_workload(f"{DENSE}@dp=4,tp=2")     # world 8
    node_of = place_ranks(4, plan.world, strategy="linear")   # 2 ranks/node
    tp = plan.phase("tp_allgather")
    D, _ = W._phase_demand(tp, W._phase_groups(plan, "tp"), node_of, 4)
    assert D.sum() == 0.0                             # every TP pair co-located


# --------------------------------------------------------------------------
# HLO byte audit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [f"{DENSE}@dp=8,tp=2", f"{MOE}@dp=8,ep=4"])
def test_hlo_crosscheck_agrees(spec):
    check = W.hlo_crosscheck(spec)
    assert check["ok"], check
    kinds = check["kinds"]
    plan = W.plan_workload(spec)
    assert set(kinds) == set(plan.collective_byte_totals())
    for row in kinds.values():
        assert row["plan_bytes"] > 0


# --------------------------------------------------------------------------
# rank placement
# --------------------------------------------------------------------------

def test_place_ranks_strategies_and_balance():
    n, world = 8, 20
    for strategy in ("linear", "round_robin", "random"):
        nodes = place_ranks(n, world, strategy=strategy, seed=3)
        assert nodes.shape == (world,)
        loads = np.bincount(nodes, minlength=n)
        assert loads.max() - loads.min() <= 1         # balanced
    assert np.array_equal(place_ranks(n, world, strategy="round_robin"),
                          np.arange(world) % n)
    # random is a seeded relabeling: deterministic per seed, differs by seed
    r0 = place_ranks(n, world, strategy="random", seed=0)
    assert np.array_equal(r0, place_ranks(n, world, strategy="random", seed=0))
    assert any(not np.array_equal(r0, place_ranks(n, world, strategy="random",
                                                  seed=s)) for s in (1, 2, 3))


def test_place_ranks_rejects_bad_arguments():
    with pytest.raises(ValueError):
        place_ranks(0, 4)
    with pytest.raises(ValueError):
        place_ranks(4, 0)
    with pytest.raises(ValueError):
        place_ranks(4, 8, strategy="nope")


# --------------------------------------------------------------------------
# execution + API wiring
# --------------------------------------------------------------------------

def _assert_results_close(got, want, what):
    assert got.n == want.n and got.placement == want.placement, what
    assert got.compute_seconds == want.compute_seconds, what
    for key in ("step_seconds", "comm_seconds", "dp_seconds", "tp_seconds",
                "moe_seconds", "exposed_dp_seconds", "exposed_comm_fraction"):
        assert getattr(got, key) == pytest.approx(
            getattr(want, key), rel=SIM_REL_TOL, abs=1e-12), (what, key)
    assert got.dropped_frac == pytest.approx(want.dropped_frac, abs=1e-9), \
        what
    assert len(got.phase_rows) == len(want.phase_rows), what
    for g, w in zip(got.phase_rows, want.phase_rows):
        for key in ("name", "collective", "group_axis", "group_size", "ops",
                    "rounds", "bytes_per_rank", "dtype"):
            assert g[key] == w[key], (what, key)
        for key in ("seconds", "max_link_bytes"):
            assert g[key] == pytest.approx(w[key], rel=SIM_REL_TOL), \
                (what, g["name"], key)


def test_simulate_workload_composition(ref):
    topo = build("hypercube(3)")                      # n = 8 = world
    res = W.simulate_workload(topo, f"{DENSE}@dp=4,tp=2", placement="random",
                              seed=1, device=CPU)
    assert res.n == 8 and res.plan.world == 8
    # step composition: compute + tp + moe + exposed dp, all non-negative
    want = (res.compute_seconds + res.tp_seconds + res.moe_seconds
            + res.exposed_dp_seconds)
    assert res.step_seconds == pytest.approx(want)
    assert res.exposed_dp_seconds <= res.dp_seconds
    assert 0.0 <= res.exposed_comm_fraction < 1.0
    assert res.dropped_frac == 0.0                    # hypercube is connected
    assert set(res.phase_seconds()) == {p.name for p in res.plan.phases}
    d = res.to_dict()
    assert d["step_ms"] == pytest.approx(res.step_seconds * 1e3, rel=1e-6)
    assert "step time" in res.report() and plan_text_ok(res.plan.report())
    theirs = ref.workloads.simulate_workload(
        _ref_topo(ref, topo), f"{DENSE}@dp=4,tp=2", placement="random",
        seed=1)
    _assert_results_close(res, theirs, "hypercube(3)")
    assert res.report().splitlines()[0] == theirs.report().splitlines()[0]


def plan_text_ok(text: str) -> bool:
    return "workload" in text and "compute/rank" in text


#: small topologies take three jobs (a dense 7B, a 314B MoE at world 8, and
#: the 1T MoE at world 64, oversubscribed); lps(13,5) (n = 2184, the bench's
#: largest family) takes one 64-rank data-parallel phase, since each phase
#: is an all-sources ECMP lowering that dominates the CPU time
SIM_CASES = {
    "torus(4,2)": (f"{DENSE}@dp=4,tp=2", f"{MOE}@dp=8,ep=4",
                   "kimi_k2_1t@dp=16,tp=4,ep=8"),
    "hypercube(5)": (f"{DENSE}@dp=4,tp=2", f"{MOE}@dp=8,ep=4",
                     "kimi_k2_1t@dp=16,tp=4,ep=8"),
    "lps(13,5)": (f"{DENSE}@dp=64",),
}


@pytest.fixture(scope="module")
def routed(ref):
    """(port topology, reference topology, port routing, reference routing)
    per SIM_CASES family, computed once for the three placements."""
    from repro_torch.core.routing import analyze_routing

    out = {}

    def get(spec):
        if spec not in out:
            g = build(spec)
            rg = _ref_topo(ref, g)
            out[spec] = (g, rg, analyze_routing(g, device=CPU),
                         ref.routing.analyze_routing(rg))
        return out[spec]

    return get


@pytest.mark.parametrize("placement", ["linear", "round_robin", "random"])
@pytest.mark.parametrize("spec", list(SIM_CASES))
def test_simulate_workload_matches_reference(ref, routed, spec, placement):
    g, rg, mine, theirs = routed(spec)
    for w in SIM_CASES[spec]:
        got = W.simulate_workload(g, w, placement=placement, seed=2,
                                  routing=mine, device=CPU)
        want = ref.workloads.simulate_workload(rg, w, placement=placement,
                                               seed=2, routing=theirs)
        _assert_results_close(got, want, (spec, placement, w))


def test_analysis_simulate_workload_caches():
    a = Analysis("hypercube(3)", device=CPU)
    r1 = a.simulate(workload=f"{DENSE}@dp=4,tp=2", placement="linear")
    r2 = a.simulate(workload=f"{DENSE}@dp=4,tp=2", placement="linear")
    assert r1 is r2                                   # memoized per (spec, ...)
    r3 = a.simulate(workload=f"{DENSE}@dp=4,tp=2", placement="round_robin")
    assert r3 is not r1
    # a prebuilt plan shares the spec string's entry
    assert a.simulate(workload=W.plan_workload(f"{DENSE}@dp=4,tp=2"),
                      placement="linear") is r1


def test_survey_appends_workload_columns():
    sr = survey(["hypercube(3)"], columns=["spec", "nodes", "rho2"],
                workload=f"{DENSE}@dp=4,tp=2", device=CPU)
    row = sr.rows[0]
    for col in WORKLOAD_COLUMNS:
        assert col in row, col
    assert row["workload"] == W.parse_workload(f"{DENSE}@dp=4,tp=2").spec
    assert row["step_time_ms"] > row["compute_ms"] > 0
    assert row["comm_total_ms"] == pytest.approx(
        row["comm_dp_ms"] + row["comm_tp_ms"] + row["comm_moe_ms"], rel=1e-6)


def test_survey_workload_rows_match_reference(ref):
    """Random placement through the survey's config dict; the config's seed
    does not reach the placement, in either framework."""
    specs = ["hypercube(4)", "torus(4,2)", "petersen"]
    cfg = dict(spec=f"{MOE}@dp=8,tp=2,ep=4", placement="random", seed=5)
    got = survey(specs, columns=["spec", "nodes", "rho2"], workload=cfg,
                 device=CPU)
    want = ref.survey.survey(specs, columns=["spec", "nodes", "rho2"],
                             workload=cfg)
    assert got.columns == want.columns
    for g, w in zip(got.rows, want.rows):
        assert g["workload"] == w["workload"]
        for col in WORKLOAD_COLUMNS[2:]:
            assert g[col] == pytest.approx(w[col], rel=SIM_REL_TOL,
                                           abs=1e-6), (g["spec"], col)
    seeded = survey(specs[:1], columns=["spec"], workload=dict(cfg, seed=0),
                    device=CPU)
    assert seeded.rows[0]["step_time_ms"] == got.rows[0]["step_time_ms"]


def test_fault_sweep_appends_workload_fields():
    a = Analysis("hypercube(3)", device=CPU)
    sweep = a.fault_sweep(rates=[0.05], samples=2,
                          workload=f"{DENSE}@dp=4,tp=2", workload_samples=1)
    row = sweep.rows[0]
    assert row["workload_step_mean"] > 0
    assert row["workload_step_max"] >= row["workload_step_mean"]
    assert 0.0 <= row["workload_dropped_frac_mean"] <= 1.0


def test_fault_sweep_workload_rows_match_reference(ref):
    """Link faults on a small hypercube disconnect some samples: the dropped
    demand and the degraded step times follow the reference's."""
    g = build("hypercube(3)")
    kw = dict(rates=(0.1, 0.4), samples=4, seed=3, iters=60,
              workload=f"{DENSE}@dp=4,tp=2", workload_samples=3)
    got = F.fault_sweep(g, device=CPU, **kw)
    want = ref.faults.fault_sweep(_ref_topo(ref, g), **kw)
    for gr, wr in zip(got.rows, want.rows):
        assert gr["failed_links_mean"] == wr["failed_links_mean"]
        for key in ("workload_step_mean", "workload_step_max"):
            assert gr[key] == pytest.approx(wr[key], rel=SIM_REL_TOL), key
        assert gr["workload_dropped_frac_mean"] == pytest.approx(
            wr["workload_dropped_frac_mean"], abs=1e-9)
    assert any(r["workload_dropped_frac_mean"] > 0 for r in got.rows)


# --------------------------------------------------------------------------
# spectral agreement statistic
# --------------------------------------------------------------------------

def test_spectral_rank_correlation_extremes_and_ties(ref):
    perfect = [dict(rho2=r, step_ms=s) for r, s in
               [(4.0, 10.0), (3.0, 20.0), (2.0, 30.0), (1.0, 40.0)]]
    assert W.spectral_rank_correlation(perfect) == pytest.approx(1.0)
    reverse = [dict(rho2=r, step_ms=s) for r, s in
               [(4.0, 40.0), (3.0, 30.0), (2.0, 20.0), (1.0, 10.0)]]
    assert W.spectral_rank_correlation(reverse) == pytest.approx(-1.0)
    assert W.spectral_rank_correlation([dict(rho2=1.0, step_ms=1.0)]) is None
    assert W.spectral_rank_correlation(
        [dict(rho2=1.0, step_ms=None), dict(rho2=None, step_ms=2.0)]) is None
    # all-tied step times carry no ordering information
    tied = [dict(rho2=r, step_ms=5.0) for r in (3.0, 2.0, 1.0)]
    assert W.spectral_rank_correlation(tied) is None
    rows = [dict(rho2=r, step_ms=s) for r, s in
            [(2.0, 3.0), (2.0, 1.0), (1.0, 2.0), (0.5, 2.0), (3.0, 7.0)]]
    assert W.spectral_rank_correlation(rows) == \
        ref.workloads.spectral_rank_correlation(rows)


# --------------------------------------------------------------------------
# the bench's lists, the report entry point, chip_smoke's constants
# --------------------------------------------------------------------------

def test_workload_bench_lists_equal_the_benchmark(ref):
    import benchmarks.workload_sim as WS
    from repro_torch import specs

    assert specs.WORKLOAD_SIM_WORKLOADS == WS.WORKLOADS
    assert specs.WORKLOAD_SIM_PLACEMENT == WS.PLACEMENT
    assert (W.BUCKET_BYTES, W.DP_OVERLAP_FRACTION) == (
        ref.workloads.BUCKET_BYTES, ref.workloads.DP_OVERLAP_FRACTION)


def test_topology_report_runs_the_workload_block():
    """``python -m repro_torch.topology_report ... --workload`` prints the
    plan and the step time of Analysis.simulate(workload=)."""
    import os

    spec, w = "hypercube(5)", f"{DENSE}@dp=16,tp=4"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.topology_report", spec,
         "--workload", w, "--placement", "random", "--device", CPU],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--- executed training step (workload lowering) ---" in out.stdout
    step = float(re.search(r"step time\s+:\s+([\d.]+) ms",
                           out.stdout).group(1))
    res = Analysis(spec, device=CPU).simulate(workload=w, placement="random")
    assert step == pytest.approx(res.step_seconds * 1e3, abs=5e-4)
    # without a card the default device raises
    if not torch.cuda.is_available():
        bad = subprocess.run(
            [sys.executable, "-m", "repro_torch.topology_report", spec],
            env=env, capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0
        assert "CUDA is not available" in bad.stderr


def test_chip_smoke_fault_workload_constants_are_the_reference(ref):
    """chip_smoke.py holds its fault_sweep(workload=) check to
    FAULT_WORKLOAD_REF: recomputed here with the reference's
    simulate_workload on the sweep's first degraded samples."""
    smoke = load_chip_smoke()
    cfg, wl = smoke.FAULT_SIM, smoke.FAULT_WORKLOAD
    g = build(cfg["spec"])
    results = []
    for i in range(wl["samples"]):
        d = F.apply_faults(g, F.make_scenario(
            g, "link", cfg["rate"], seed=cfg["seed"] + 7919 * i, device=CPU))
        results.append(ref.workloads.simulate_workload(_ref_topo(ref, d),
                                                       wl["spec"]))
    steps = [r.step_seconds for r in results]
    for key, val in (("workload_step_mean", np.mean(steps)),
                     ("workload_step_max", np.max(steps)),
                     ("workload_dropped_frac_mean",
                      np.mean([r.dropped_frac for r in results]))):
        assert val == pytest.approx(smoke.FAULT_WORKLOAD_REF[key], rel=1e-12,
                                    abs=1e-15), key


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Analysis("hypercube(3)", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        W.simulate_workload(build("hypercube(3)"), f"{DENSE}@dp=4,tp=2")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["lps(13,5)", "slimfly(13)"])
def test_cuda_simulate_workload_matches_cpu(spec):
    """The card's run (K1's f64 ECMP batches) against the port's CPU run:
    both float64, so only the summation order differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    g = build(spec)
    for w in ("kimi_k2_1t@dp=16,tp=4,ep=8", f"{DENSE}@dp=16,tp=4"):
        got = W.simulate_workload(g, w, placement="random", device="cuda")
        want = W.simulate_workload(g, w, placement="random", device=CPU)
        _assert_results_close(got, want, (spec, w))
        assert got.step_seconds == pytest.approx(want.step_seconds,
                                                 rel=1e-9)
