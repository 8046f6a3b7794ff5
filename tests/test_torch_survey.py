"""The slice as a whole: Analysis and survey rows of the PyTorch port against
the JAX reference on the same specs (port on the CPU here).

Tolerances: strings, ints and bools equal; rho2 within 1e-3 absolute (the
reference's own Lanczos-vs-dense bar, tests/test_api_analysis.py); floats
derived from rho2 (bounds scale it by n/4, ratios divide it) within 1e-3
relative; ``bw_witness`` equal, since ``canonical_fiedler`` recomputes a
deterministic Fiedler vector on both sides for n <= 4096.
"""
import json

import numpy as np
import pytest

from repro_torch import obs, specs
from repro_torch.api import (Analysis, RAMANUJAN_COLUMNS, TABLE1_COLUMNS,
                             survey)
from repro_torch.core import spectral as PS
from repro_torch.interop import topology_from_arrays
from test_torch_harness import load_reference

CPU = "cpu"
RHO2_DERIVED = {"bw_fiedler_lb", "rho2_gap_ratio", "lambda"}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _compare_rows(got_rows, want_rows, columns):
    assert len(got_rows) == len(want_rows)
    for got, want in zip(got_rows, want_rows):
        assert list(got) == list(want)
        for c in columns:
            g, w = got[c], want[c]
            if c == "rho2":
                assert g == pytest.approx(w, abs=1e-3), (c, got, want)
            elif c in RHO2_DERIVED:
                assert g == pytest.approx(w, rel=1e-3, abs=1e-3), (c, got,
                                                                   want)
            elif isinstance(w, float) and not isinstance(w, bool):
                assert g == pytest.approx(w, rel=1e-12), (c, got, want)
            else:
                assert g == w and type(g) is type(w), (c, got, want)


def test_table1_rows_match_reference(ref):
    cols = [c for c in TABLE1_COLUMNS if c != "seconds"]
    subset = specs.TABLE1_SPECS[:8]
    got = survey(subset, columns=cols, dense_threshold=50, device=CPU)
    want = ref.survey.survey(subset, columns=cols, dense_threshold=50)
    assert all(r["nodes"] <= 4096 for r in got.rows)
    assert [r["instance"] for r in got.rows] == list(
        dict.fromkeys(r["instance"] for r in got.rows))
    _compare_rows(got.rows, want.rows, cols)
    assert got.columns == want.columns == cols


def test_ramanujan_rows_match_reference(ref):
    cols = [c for c in RAMANUJAN_COLUMNS if c != "seconds"]
    subset = specs.LPS_SPECS[:3]
    got = survey(subset, columns=RAMANUJAN_COLUMNS, dense_threshold=0,
                 device=CPU)
    want = ref.survey.survey(subset, columns=RAMANUJAN_COLUMNS,
                             dense_threshold=0)
    for g, w in zip(got.rows, want.rows):
        assert g["backend"] == w["backend"] == "lanczos"
        for c in ("is_ramanujan", "diameter", "bipartite", "nodes", "radix"):
            assert g[c] == w[c], (c, g, w)
        assert g["is_ramanujan"] is True
        assert isinstance(g["seconds"], float)
    _compare_rows([{c: r[c] for c in cols} for r in got.rows],
                  [{c: r[c] for c in cols} for r in want.rows], cols)


def test_same_shape_group_takes_the_batched_path(ref):
    """Two regular, non-bipartite graphs of one (n, k) share one batched
    solve (counter survey/lanczos_groups), and agree with the reference and
    the dense oracle."""
    base = ref.registry.build("random_regular(128,6,0)")
    perm = np.random.default_rng(21).permutation(base.n)
    relabel = ref.graphs.Topology("rr/relabel", base.n, perm[base.edges])
    port_topos = [topology_from_arrays(t.name, t.n, t.edges, t.loops, t.meta)
                  for t in (base, relabel)]
    before = obs.counters("survey/")
    got = survey(port_topos, columns=["instance", "rho2"], dense_threshold=0,
                 device=CPU)
    delta = obs.counter_delta(before, "survey/")
    assert delta == {"survey/lanczos_groups": 1,
                     "survey/lanczos_grouped_instances": 2}
    want = ref.survey.survey([base, relabel], columns=["instance", "rho2"],
                             dense_threshold=0)
    _compare_rows(got.rows, want.rows, ["instance", "rho2"])
    dense = float(PS.laplacian_spectrum(port_topos[0])[1])
    for r in got.rows:
        assert r["rho2"] == pytest.approx(dense, abs=1e-3)


@pytest.mark.parametrize("spec", ["slimfly(5)", "hypercube(5)", "torus(6,2)"])
def test_dense_report_equals_reference(ref, spec):
    """On the dense backend every number is the same host float64 oracle, so
    the paper-style report is identical text."""
    got = Analysis(spec, device=CPU).report()
    want = ref.analysis.Analysis(spec).report()
    assert got == want


def test_lanczos_analysis_matches_reference(ref):
    a = Analysis("torus(12,2)", dense_threshold=100, device=CPU)
    r = ref.analysis.Analysis("torus(12,2)", dense_threshold=100)
    assert a.backend == r.backend == "lanczos"
    assert a.rho2 == pytest.approx(r.rho2, abs=1e-3)
    assert a.lambda_nontrivial == pytest.approx(r.lambda_nontrivial, abs=1e-3)
    assert a.bisection_witness == r.bisection_witness
    assert a.diameter == r.diameter
    for k, v in r.bounds.items():
        assert a.bounds[k] == pytest.approx(v, rel=1e-3), k
    with pytest.raises(RuntimeError, match="dense"):
        a.spectrum
    assert a.fiedler is a.fiedler


def test_irregular_and_loop_regularized_graphs(ref):
    a = Analysis("path(7)", device=CPU)
    assert a.radix is None
    assert a.rho2 == pytest.approx(2 * (1 - np.cos(np.pi / 7)))
    with pytest.raises(RuntimeError, match="irregular"):
        a.ramanujan
    dv = Analysis("data_vortex(5,4)", dense_threshold=10, lanczos_iters=150,
                  device=CPU)
    assert dv.rho2 == pytest.approx(
        float(PS.laplacian_spectrum(dv.topo)[1]), abs=1e-3)


def test_csv_json_and_columns_match_reference(ref):
    cols = ["topology", "spec", "nodes", "radix", "rho2", "rho2_ok"]
    got = survey(["torus(6,2)", "lps(5,13)"], columns=cols, device=CPU)
    want = ref.survey.survey(["torus(6,2)", "lps(5,13)"], columns=cols)
    assert got.to_csv() == want.to_csv()
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert '"torus(6,2)"' in got.to_csv()
    with pytest.raises(KeyError, match="unknown survey column"):
        survey(["torus(6,2)"], columns=["rho2", "thpt_ugal"], device=CPU)


def test_survey_trace_records_spans(tmp_path):
    path = tmp_path / "trace.json"
    survey(["hypercube(6)"], columns=["rho2"], dense_threshold=10,
           trace=path, device=CPU)
    names = {e["name"] for e in obs.trace_events()}
    assert {"survey/build", "survey/row", "registry/build",
            "spectral/rho2_lanczos"} <= names
    assert json.loads(path.read_text())["traceEvents"]
