"""The port's copy of the HLO roofline parser (``launch/hlo_analysis``)
against the reference's: the reference's own ``tests/test_hlo_analysis.py``
cases, and the reference's ``analyze_hlo`` over the synthetic HLO of the
workload plans (the text the workload lowering audits itself with).
Standard-library parsing on both sides, so every figure is held exactly.
"""
import dataclasses
import importlib

import pytest

from repro_torch.core import workloads as W
from repro_torch.launch import hlo_analysis as H
from test_torch_harness import load_reference

SYNTH = """\
HloModule test

%wide.body (p: (s32[], f32[128,256])) -> (s32[], f32[128,256]) {
  %p = (s32[], f32[128,256]) parameter(0)
  %dot.1 = f32[128,256]{1,0} dot(%lhs, %rhs), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %all-reduce.1 = f32[128,256]{1,0} all-reduce(%dot.1), replica_groups={}, to_apply=%add
}

%cond (p: (s32[], f32[128,256])) -> pred[] {
  %p2 = (s32[], f32[128,256]) parameter(0)
  %compare = pred[] compare(%a, %b), direction=LT
}

ENTRY %main (a: f32[128,64], b: f32[64,256]) -> f32[128,256] {
  %lhs = f32[128,64]{1,0} parameter(0)
  %rhs = f32[64,256]{1,0} parameter(1)
  %while.1 = (s32[], f32[128,256]) while(%init), condition=%cond, body=%wide.body, backend_config={"known_trip_count":{"n":"12"}}
  %all-gather.9 = f32[128,256]{1,0} all-gather(%small), dimensions={0}
}
"""

#: every model family of the bench, dense and MoE, with and without TP
PLAN_SPECS = [
    "kimi_k2_1t@dp=16,tp=4,ep=8", "qwen2_7b@dp=16,tp=4",
    "grok_1_314b@dp=16,tp=4,ep=8", "jamba@dp=8,tp=2,ep=2",
    "falcon_mamba_7b@dp=64,tp=8", "gemma3_12b@dp=2", "qwen2_7b@dp=8,tp=3",
]


@pytest.fixture(scope="module")
def ref_hlo():
    load_reference()
    return importlib.import_module("repro.launch.hlo_analysis")


def test_parse_module_headers_and_instrs(ref_hlo):
    comps, shapes, entry = H.parse_module(SYNTH)
    assert entry == "main"
    assert "wide.body" in comps and "cond" in comps
    assert shapes["dot.1"].startswith("f32[128,256]")
    rcomps, rshapes, rentry = ref_hlo.parse_module(SYNTH)
    assert (shapes, entry) == (rshapes, rentry)
    assert {k: [dataclasses.astuple(i) for i in v] for k, v in comps.items()} \
        == {k: [dataclasses.astuple(i) for i in v] for k, v in rcomps.items()}


def test_trip_count_scaling(ref_hlo):
    stats = H.analyze_hlo(SYNTH)
    # dot flops = 2 * 128*256 * 64 (contracting dim of lhs f32[128,64])
    expect_dot = 2 * 128 * 256 * 64
    assert abs(stats.flops - 12 * expect_dot) < 1e-6
    # all-reduce operand bytes x 12 trips
    ar = 128 * 256 * 4
    assert abs(stats.collective_bytes["all-reduce"] - 12 * ar) < 1e-6
    # entry-level all-gather counted once (output bytes)
    assert abs(stats.collective_bytes["all-gather"] - 128 * 256 * 4) < 1e-6
    assert dataclasses.asdict(stats) == dataclasses.asdict(
        ref_hlo.analyze_hlo(SYNTH))


def test_roofline_terms_dominance(ref_hlo):
    t = H.roofline_terms(197e12, 0.0, 0.0)
    assert t["dominant"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-9
    t = H.roofline_terms(0.0, 0.0, 200e9)
    assert t["dominant"] == "collective" and abs(t["collective_s"] - 1.0) < 1e-9
    for args in ((1e12, 3e9, 1e8), (0.0, 5e11, 0.0)):
        assert H.roofline_terms(*args) == ref_hlo.roofline_terms(*args)
    # the modeled cluster's constants are the reference's, unchanged
    assert H.HW == ref_hlo.HW


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_plan_hlo_parses_as_the_reference_parses_it(ref_hlo, spec):
    """The port's parser and the reference's read the plan's synthetic HLO
    to the same totals, and those are the plan's byte totals."""
    text = W.plan_workload(spec).to_hlo()
    got, want = H.analyze_hlo(text), ref_hlo.analyze_hlo(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    totals = W.plan_workload(spec).collective_byte_totals()
    for kind, b in totals.items():
        assert got.collective_bytes[kind] == pytest.approx(b, rel=1e-9)
    assert got.flops == 0.0 and got.dot_count == 0.0
