"""Non-minimal & adaptive routing schemes of the port (Valiant, UGAL, KSP)
and the MCF ceiling, against the JAX reference on the CPU.

Follows the reference's ``tests/test_routing_schemes.py`` case for case
(closed forms, slack-0 KSP = minimal, UGAL = minimal under uniform
traffic, the MCF ceiling over every scheme, sampled-source parity and the
UCB) with the port on ``device="cpu"``, and adds parity cases: every scheme's
loads against the reference's on the same graph and routing, and UGAL's
per-pair decision masks pair for pair on the routing-scheme bench's
families.

Tolerances.  The reference's ECMP casts sigma and the demands to float32
(``repro/core/traffic.py:279``); the port stays in float64.  So loads that
go through ECMP (``minimal``, ``valiant``, ``ugal``) are held at 1e-5
relative to the largest load, the reference's float32 rounding; ``ksp``
runs in float64 in both frameworks and is held at 1e-12.  UGAL's decision
compares float64 loads in the port and float32-accumulated ones in the
reference; no pair of any tested family flips, so the masks are held equal.
The MCF LP is the same scipy/HiGHS code in both: 1e-9 relative.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import Analysis, survey
from repro_torch.api import registry as PR
from repro_torch.core import routing as R
from repro_torch.core import spectral as PS
from repro_torch.core import topologies as T
from repro_torch.core import traffic as TR
from repro_torch.core.ramanujan import lps
from repro_torch.core.synthesis import xpander
from repro_torch.specs import ROUTING_SCHEMES_SPECS
from test_torch_harness import load_reference, ref_topology

CPU = "cpu"
#: loads routed through the reference's float32 ECMP
F32_RTOL = 1e-5
#: float64 in both frameworks (KSP's walk-count DP)
F64_RTOL = 1e-12
MCF_RTOL = 1e-9


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread avoids oversubscribing the
    cores the test workers and the JAX reference share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_loads(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _tol(scheme):
    return F64_RTOL if scheme == "ksp" else F32_RTOL


def _uniform_served(g, routing):
    D = TR.demand_matrix("uniform", g.n)
    return np.where(routing.dist >= 0, D, 0.0)


_CASES = {}


def _case(ref, spec):
    """(port topo, ref topo, port routing, ref routing, canonical Fiedler)
    of one family, built once per module."""
    if spec not in _CASES:
        g = PR.build(spec, device=CPU)
        gr = ref_topology(ref, g)
        f = PS.canonical_fiedler(g)
        np.testing.assert_array_equal(f, ref.spectral.canonical_fiedler(gr))
        _CASES[spec] = (g, gr, R.analyze_routing(g, device=CPU),
                        ref.routing.analyze_routing(gr), f)
    return _CASES[spec]


# --------------------------------------------------------------------------
# every scheme against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["uniform", "adversarial"])
@pytest.mark.parametrize("spec", ["petersen", "hypercube(4)", "slimfly(5)",
                                  "torus(4,2)", "ccc(3)", "butterfly(2,3)",
                                  "dragonfly", "random_regular(48,4,0)"])
def test_every_scheme_equals_reference(ref, spec, pattern):
    g, gr, r, rr, f = _case(ref, spec)
    for scheme in TR.ROUTING_SCHEMES:
        got = TR.evaluate_traffic(g, pattern, scheme=scheme, routing=r,
                                  fiedler=f, device=CPU)
        want = ref.traffic.evaluate_traffic(gr, pattern, scheme=scheme,
                                            routing=rr, fiedler=f)
        tol = _tol(scheme)
        _assert_loads(got.link_loads, want.link_loads, tol)
        assert got.saturation_throughput == pytest.approx(
            want.saturation_throughput, rel=tol), scheme
        assert got.avg_hops == pytest.approx(want.avg_hops, rel=1e-12)
        assert got.total_demand == pytest.approx(want.total_demand,
                                                 rel=1e-12)
        assert got.conservation_error < 1e-12, (scheme, got)
        assert got.scheme == scheme and got.exact


@pytest.mark.parametrize("spec", [s for s in ROUTING_SCHEMES_SPECS
                                  if s != "lps(13,5)"])
def test_ugal_decision_masks_equal_reference(ref, spec):
    """Pair for pair, on the routing-scheme bench's families (all but
    lps(13,5), n 2184, too large for tier-1): the port's float64 loads and
    the reference's float32 ones route the same pairs minimally."""
    g, gr, r, rr, f = _case(ref, spec)
    table = g.gather_operands()[0]
    for pattern in ("uniform", "adversarial"):
        D = TR.demand_rows(pattern, g.n, r.sources, fiedler=f)
        served = np.where(r.dist >= 0, D, 0.0)
        served[np.arange(g.n), r.sources] = 0.0
        mine, L_mine = TR._ugal_decision(table, r, served, chunk=512,
                                         backend=None, device=CPU)
        theirs, L_theirs = ref.traffic._ugal_decision(table, rr, served,
                                                      chunk=512, backend=None)
        np.testing.assert_array_equal(mine, theirs)
        _assert_loads(L_mine, L_theirs, F32_RTOL)


# --------------------------------------------------------------------------
# Valiant closed forms
# --------------------------------------------------------------------------

def test_valiant_complete_graph_closed_form(ref):
    """K_n: every link carries exactly 2/n under uniform Valiant."""
    n = 12
    g = T.complete(n)
    t = TR.evaluate_traffic(g, "uniform", scheme="valiant", device=CPU)
    live = g.gather_operands()[0] >= 0
    np.testing.assert_allclose(t.link_loads[live], 2.0 / n, rtol=1e-12)
    assert t.saturation_throughput == pytest.approx(n / 2.0, rel=1e-12)
    want = ref.traffic.evaluate_traffic(ref_topology(ref, g), "uniform",
                                        scheme="valiant")
    _assert_loads(t.link_loads, want.link_loads, F32_RTOL)


def test_valiant_cycle_loads_all_equal():
    g = T.cycle(10)
    t = TR.evaluate_traffic(g, "uniform", scheme="valiant", device=CPU)
    lv = t.link_loads[g.gather_operands()[0] >= 0]
    np.testing.assert_allclose(lv, lv[0], rtol=1e-12)


# --------------------------------------------------------------------------
# UGAL
# --------------------------------------------------------------------------

@pytest.mark.parametrize("build", [lambda: T.hypercube(4), T.petersen,
                                   lambda: T.slimfly(5)],
                         ids=["hypercube4", "petersen", "slimfly5"])
def test_ugal_reduces_to_minimal_under_uniform(build):
    g = build()
    r = R.analyze_routing(g, device=CPU)
    t_min = TR.evaluate_traffic(g, "uniform", scheme="minimal", routing=r,
                                device=CPU)
    t_ugal = TR.evaluate_traffic(g, "uniform", scheme="ugal", routing=r,
                                 device=CPU)
    np.testing.assert_array_equal(t_min.link_loads, t_ugal.link_loads)
    assert t_min.saturation_throughput == t_ugal.saturation_throughput


def test_nonminimal_adversarial_no_worse_than_minimal_on_expanders(ref):
    for g, check_ugal in ((lps(5, 13), False), (T.slimfly(5), True),
                          (xpander(64, 6, 0, 0, device=CPU), True)):
        r = R.analyze_routing(g, device=CPU)
        kw = dict(routing=r, fiedler=PS.canonical_fiedler(g), device=CPU)
        t_min = TR.evaluate_traffic(g, "adversarial", scheme="minimal", **kw)
        t_val = TR.evaluate_traffic(g, "adversarial", scheme="valiant", **kw)
        assert t_val.saturation_throughput >= \
            t_min.saturation_throughput - 1e-9
        if check_ugal:
            t_ugal = TR.evaluate_traffic(g, "adversarial", scheme="ugal",
                                         **kw)
            assert t_ugal.saturation_throughput >= \
                t_min.saturation_throughput - 1e-9


# --------------------------------------------------------------------------
# k-shortest-path ECMP
# --------------------------------------------------------------------------

@pytest.mark.parametrize("build", [T.petersen, lambda: T.hypercube(4),
                                   lambda: T.slimfly(5)],
                         ids=["petersen", "hypercube4", "slimfly5"])
@pytest.mark.parametrize("pattern", ["uniform", "bit_complement"])
def test_ksp_slack_zero_is_minimal(build, pattern):
    """slack=0 admits exactly the shortest paths with walk-count weights =
    ECMP's path-count weights; both float64 in the port."""
    g = build()
    r = R.analyze_routing(g, device=CPU)
    t_min = TR.evaluate_traffic(g, pattern, scheme="minimal", routing=r,
                                device=CPU)
    t_ksp = TR.evaluate_traffic(g, pattern, scheme="ksp", slack=0,
                                routing=r, device=CPU)
    _assert_loads(t_ksp.link_loads, t_min.link_loads, F64_RTOL)
    assert t_min.saturation_throughput == pytest.approx(
        t_ksp.saturation_throughput, rel=F64_RTOL)


@pytest.mark.parametrize("slack", [1, 2, 3])
def test_ksp_slack_equals_reference(ref, slack):
    """Slacks past 1 admit backtracking walks; the walk-count DP still
    matches the reference's float64 one."""
    g, gr, r, rr, f = _case(ref, "petersen")
    for pattern in ("uniform", "adversarial"):
        D = TR.demand_rows(pattern, g.n, r.sources, fiedler=f)
        table = g.gather_operands()[0]
        got = TR.ksp_link_loads(table, r, D, slack=slack, device=CPU)
        want = ref.traffic.ksp_link_loads(table, rr, D, slack=slack)
        _assert_loads(got[0], want[0], F64_RTOL)
        assert got[1] == pytest.approx(want[1], rel=F64_RTOL)
        assert got[2] == want[2]


def test_ksp_conserves_demand_and_spreads_load():
    g = T.petersen()
    r = R.analyze_routing(g, device=CPU)
    f = PS.canonical_fiedler(g)
    t = TR.evaluate_traffic(g, "adversarial", scheme="ksp", slack=1,
                            routing=r, fiedler=f, device=CPU)
    assert t.conservation_error < 1e-12
    t_min = TR.evaluate_traffic(g, "adversarial", scheme="minimal",
                                routing=r, fiedler=f, device=CPU)
    assert t.avg_hops >= t_min.avg_hops - 1e-9
    assert t.saturation_throughput > 0


def test_ksp_rejects_negative_slack():
    g = T.petersen()
    r = R.analyze_routing(g, device=CPU)
    with pytest.raises(ValueError):
        TR.ksp_link_loads(g.gather_operands()[0], r, _uniform_served(g, r),
                          slack=-1, device=CPU)


# --------------------------------------------------------------------------
# MCF throughput ceiling
# --------------------------------------------------------------------------

def test_mcf_complete_graph_exact():
    n = 12
    assert TR.mcf_throughput_ub(T.complete(n)) == pytest.approx(n - 1,
                                                                rel=1e-6)


@pytest.mark.parametrize("build", [
    T.petersen, lambda: T.hypercube(4), lambda: T.cycle(10),
    lambda: T.torus(4, 2), lambda: T.slimfly(5),
    lambda: T.cube_connected_cycles(3), lambda: T.butterfly(2, 3),
    lambda: T.random_regular(48, 4, seed=0),
], ids=["petersen", "hypercube4", "cycle10", "torus4x2", "slimfly5",
        "ccc3", "butterfly2x3", "rr48"])
@pytest.mark.parametrize("pattern", ["uniform", "adversarial"])
def test_mcf_ub_dominates_every_scheme(ref, build, pattern):
    """No routing scheme may beat the optimal-routing LP ceiling, and the
    ceiling equals the reference's."""
    g = build()
    r = R.analyze_routing(g, device=CPU)
    fiedler = PS.canonical_fiedler(g) if pattern == "adversarial" else None
    ub = TR.mcf_throughput_ub(g, pattern, fiedler=fiedler)
    assert np.isfinite(ub) and ub > 0
    assert ub == pytest.approx(ref.traffic.mcf_throughput_ub(
        ref_topology(ref, g), pattern, fiedler=fiedler), rel=MCF_RTOL)
    for scheme in TR.ROUTING_SCHEMES:
        t = TR.evaluate_traffic(g, pattern, scheme=scheme, routing=r,
                                fiedler=fiedler, device=CPU)
        assert t.saturation_throughput <= ub * (1 + 1e-6) + 1e-9, \
            (scheme, t.saturation_throughput, ub)


def test_mcf_grouping_only_loosens():
    g = T.petersen()
    fine = TR.mcf_throughput_ub(g, groups=g.n)
    coarse = TR.mcf_throughput_ub(g, groups=2)
    assert coarse >= fine - 1e-9


def test_mcf_raises_without_scipy(monkeypatch):
    monkeypatch.setattr(TR, "_scipy_linprog", None)
    with pytest.raises(RuntimeError, match="scipy"):
        TR.mcf_throughput_ub(T.petersen())


# --------------------------------------------------------------------------
# the canonical adversarial demand on degenerate Fiedler eigenspaces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["butterfly(2,3)", "hypercube(4)"])
def test_adversarial_throughput_equals_reference_on_degenerate_fiedler(
        ref, spec):
    """Butterfly and hypercube have degenerate Fiedler eigenspaces; the
    canonical vector makes the adversarial demand identical in both
    frameworks, so every scheme's throughput agrees."""
    g, gr, r, rr, f = _case(ref, spec)
    D = TR.demand_matrix("adversarial", g.n, fiedler=f)
    np.testing.assert_array_equal(
        D, ref.traffic.demand_matrix("adversarial", g.n, fiedler=f))
    for scheme in TR.ROUTING_SCHEMES:
        got = TR.evaluate_traffic(g, "adversarial", scheme=scheme, routing=r,
                                  fiedler=f, device=CPU)
        want = ref.traffic.evaluate_traffic(gr, "adversarial", scheme=scheme,
                                            routing=rr, fiedler=f)
        assert got.saturation_throughput == pytest.approx(
            want.saturation_throughput, rel=_tol(scheme))


def test_canonical_fiedler_matches_lanczos_path():
    g = T.butterfly(2, 3)
    dense = PS.canonical_fiedler(g)
    via = PS.canonical_fiedler(g, PS.fiedler_lanczos(g, iters=120, seed=0,
                                                     device=CPU))
    np.testing.assert_array_equal(dense, via)


# --------------------------------------------------------------------------
# sampled-source parity and the UCB
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", list(TR.ROUTING_SCHEMES))
def test_sampled_fraction_one_matches_exact(scheme):
    g = T.slimfly(5)
    r_exact = R.analyze_routing(g, device=CPU)
    r_full = R.analyze_routing(g, sample_fraction=1.0, seed=0, device=CPU)
    t_exact = TR.evaluate_traffic(g, "uniform", scheme=scheme,
                                  routing=r_exact, device=CPU)
    t_full = TR.evaluate_traffic(g, "uniform", scheme=scheme,
                                 routing=r_full, device=CPU)
    np.testing.assert_array_equal(t_exact.link_loads, t_full.link_loads)
    assert t_exact.saturation_throughput == t_full.saturation_throughput


@pytest.mark.parametrize("scheme", ["valiant", "ugal", "ksp"])
def test_sampled_schemes_equal_reference(ref, scheme):
    """A sampled routing (40 % of sources): the n/S-scaled loads, and the
    point-estimate bound the non-minimal schemes keep (no UCB), as the
    reference's."""
    g = T.random_regular(64, 4, seed=2)
    gr = ref_topology(ref, g)
    r = R.analyze_routing(g, sample_fraction=0.4, seed=1, device=CPU)
    rr = ref.routing.analyze_routing(gr, sample_fraction=0.4, seed=1)
    for pattern in ("uniform", "neighbor"):
        got = TR.evaluate_traffic(g, pattern, scheme=scheme, routing=r,
                                  device=CPU)
        want = ref.traffic.evaluate_traffic(gr, pattern, scheme=scheme,
                                            routing=rr)
        assert not got.exact
        _assert_loads(got.link_loads, want.link_loads, _tol(scheme))
        assert got.max_link_load_ucb == got.max_link_load
        assert got.saturation_throughput == pytest.approx(
            want.saturation_throughput, rel=_tol(scheme))


def test_sampled_ucb_bounds_point_estimate():
    g = T.random_regular(128, 4, seed=1)
    r = R.analyze_routing(g, sample_fraction=0.25, seed=3, device=CPU)
    t = TR.evaluate_traffic(g, "uniform", routing=r, device=CPU)
    assert not t.exact
    assert t.max_link_load_ucb >= t.max_link_load - 1e-12
    assert t.saturation_throughput == pytest.approx(
        1.0 / t.max_link_load_ucb)


def test_sampled_ucb_covers_true_max():
    g = T.random_regular(128, 4, seed=1)
    exact = TR.evaluate_traffic(g, "uniform", device=CPU)
    covered = 0
    for seed in range(5):
        r = R.analyze_routing(g, sample_fraction=0.3, seed=seed, device=CPU)
        t = TR.evaluate_traffic(g, "uniform", routing=r, device=CPU)
        covered += t.max_link_load_ucb >= exact.max_link_load
    assert covered >= 4


def test_exact_run_has_ucb_equal_max():
    g = T.petersen()
    t = TR.evaluate_traffic(g, "uniform", device=CPU)
    assert t.max_link_load_ucb == t.max_link_load


# --------------------------------------------------------------------------
# reverse_slot_index (UGAL's incoming-link gather)
# --------------------------------------------------------------------------

def test_reverse_slot_index_involutive():
    for g in (T.petersen(), T.hypercube(4), T.cycle(3), T.slimfly(5)):
        table = g.gather_operands()[0]
        rev = R.reverse_slot_index(table)
        u, j = np.where(table >= 0)
        v = table[u, j]
        assert np.array_equal(table[v, rev[u, j]], u)
        assert np.array_equal(rev[v, rev[u, j]], j)


# --------------------------------------------------------------------------
# scheme wiring: dispatcher, simulator, Analysis, survey
# --------------------------------------------------------------------------

def test_scheme_link_loads_rejects_unknown():
    g = T.petersen()
    r = R.analyze_routing(g, device=CPU)
    with pytest.raises(ValueError, match="scheme"):
        TR.scheme_link_loads(g.gather_operands()[0], r,
                             _uniform_served(g, r), "compass", device=CPU)
    with pytest.raises(ValueError, match="scheme"):
        TR.evaluate_traffic(g, "uniform", scheme="compass", device=CPU)


def test_simulator_rides_nonminimal_paths():
    from repro_torch.core.simulate import simulate_traffic

    g = T.hypercube(4)
    r = R.analyze_routing(g, device=CPU)
    for scheme in TR.ROUTING_SCHEMES:
        sim = simulate_traffic(g, "uniform", payloads=1 << 20, routing=r,
                               scheme=scheme, device=CPU)
        static = TR.evaluate_traffic(g, "uniform", scheme=scheme, routing=r,
                                     device=CPU)
        assert sim.saturation_throughput == pytest.approx(
            static.saturation_throughput, rel=1e-12)


def test_analysis_traffic_scheme_cache_keys():
    a = Analysis("petersen", device=CPU)
    t1 = a.traffic("uniform")
    t2 = a.traffic("uniform", scheme="valiant")
    t3 = a.traffic("uniform", scheme="ksp", slack=2)
    assert t1 is a.traffic("uniform")
    assert t2 is not t1 and t3 is not t2
    assert t3 is a.traffic("uniform", scheme="ksp", slack=2)
    assert t2.scheme == "valiant" and t3.scheme == "ksp"
    assert a.mcf_throughput_ub() is a.mcf_throughput_ub()


def test_survey_scheme_columns_equal_reference(ref):
    kw = dict(routing=dict(pattern="adversarial", schemes=True))
    row = survey(["petersen", "hypercube(4)"], device=CPU, **kw).rows
    want = ref.survey.survey(["petersen", "hypercube(4)"], **kw).rows
    for got, exp in zip(row, want):
        for col in ("thpt_valiant", "thpt_ugal", "thpt_ksp", "thpt_mcf_ub",
                    "thpt_gap_to_opt", "saturation_throughput"):
            assert got[col] is not None
            # 4-decimal figures; the reference's are float32-accumulated
            assert got[col] == pytest.approx(exp[col], abs=1e-4), col
        assert 0 < got["thpt_gap_to_opt"] <= 1 + 1e-6


def test_survey_without_schemes_leaves_columns_none():
    row = survey(["petersen"], routing=True, device=CPU).rows[0]
    assert row["thpt_valiant"] is None and row["thpt_mcf_ub"] is None


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_schemes_equal_cpu_and_ksp_k1_form_equals_plain(cuda_device):
    """Every scheme on the card (ECMP and Valiant through K1's f64 batch,
    KSP through its f64 signed batch over one table with the 0/1 pad mask
    as shared signs) against the CPU's plain path; and K1 at KSP's form,
    captured from the run, against spmv_ref at the f64 tolerance."""
    from repro_torch.kernels import spmv as KS

    seen = {}
    orig = KS.spmv_cuda

    def capture(x, table, loops=None, signs=None):
        if signs is not None and x.dtype == torch.float64 and \
                x.dim() == 2 and "ksp" not in seen:
            seen["ksp"] = (x.clone(), table, loops, signs)
        return orig(x, table, loops, signs)

    g = PR.build("dragonfly", device=CPU)
    rc = R.analyze_routing(g, sample_fraction=0.5, seed=1, device=CPU)
    rg = R.analyze_routing(g, sample_fraction=0.5, seed=1,
                           device=cuda_device)
    np.testing.assert_array_equal(rc.dist, rg.dist)
    f = PS.canonical_fiedler(g)
    KS.spmv_cuda = capture
    try:
        for pattern in ("uniform", "adversarial"):
            for scheme in TR.ROUTING_SCHEMES:
                got = TR.evaluate_traffic(g, pattern, scheme=scheme,
                                          routing=rg, fiedler=f,
                                          device=cuda_device)
                want = TR.evaluate_traffic(g, pattern, scheme=scheme,
                                           routing=rc, fiedler=f,
                                           device=CPU)
                _assert_loads(got.link_loads, want.link_loads, F64_RTOL)
    finally:
        KS.spmv_cuda = orig
    x, table, loops, signs = seen["ksp"]
    assert signs.dtype == torch.float64 and signs.dim() == 2
    y = KS.spmv_cuda(x, table, loops, signs)
    want = KS.spmv_ref(x, table, loops, signs)
    assert float((y - want).abs().max()) <= F64_RTOL * max(
        float(want.abs().max()), 1.0)
