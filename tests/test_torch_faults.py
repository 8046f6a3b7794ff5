"""The port's fault models and batched degraded sweeps (``core/faults``) and
placement guarantees (``core/placement``) against the JAX reference on the
CPU.

Follows the reference's ``tests/test_faults.py`` and
``tests/test_placement.py`` case for case, with the port on
``device="cpu"``.  Scenarios are numpy draws in both frameworks
(``np.random.default_rng(seed)``), so failed links and nodes, the stacked
operands and the connectivity counts are held exactly.  Degraded rho_2 is
float32 Lanczos in both, from the reference's own start vectors: held at
1e-4 per sample, as the port's spectral tests hold its Lanczos solves.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import Analysis, build, survey
from repro_torch.core import bounds as B
from repro_torch.core import faults as F
from repro_torch.core import placement as PL
from repro_torch.core import spectral as S
from repro_torch.core import topologies as T
from repro_torch.core.spectral import algebraic_connectivity
from test_torch_harness import load_chip_smoke, load_reference, ref_topology

CPU = "cpu"
#: float32 Lanczos in both frameworks, the same start vectors
RHO2_TOL = 1e-4


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


def _assert_scenarios_equal(got, want):
    assert (got.kind, got.rate, got.seed) == (want.kind, want.rate,
                                              want.seed)
    np.testing.assert_array_equal(got.failed_links, want.failed_links)
    np.testing.assert_array_equal(got.failed_nodes, want.failed_nodes)


# --------------------------------------------------------------------------
# fault models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(F.FAULT_MODELS))
@pytest.mark.parametrize("spec", ["torus(8,2)", "fat_tree(3,2)",
                                  "slimfly(5)"])
def test_scenarios_and_degraded_graphs_equal_reference(ref, spec, model):
    g = build(spec)
    gr = ref_topology(ref, g)
    f = S.fiedler_vector(g)
    for rate, seed in ((0.0, 0), (0.1, 7), (0.25, 8)):
        got = F.make_scenario(g, model, rate, seed=seed, fiedler=f,
                              device=CPU)
        want = ref.faults.make_scenario(gr, model, rate, seed=seed,
                                        fiedler=f)
        _assert_scenarios_equal(got, want)
        d, dr = F.apply_faults(g, got), ref.faults.apply_faults(gr, want)
        assert (d.name, d.n) == (dr.name, dr.n)
        np.testing.assert_array_equal(d.edges, dr.edges)
        assert d.meta["fault"] == dr.meta["fault"]


def test_random_link_faults_seed_deterministic():
    g = T.torus(8, 2)
    a = F.random_link_faults(g, 0.1, seed=7)
    b = F.random_link_faults(g, 0.1, seed=7)
    c = F.random_link_faults(g, 0.1, seed=8)
    assert np.array_equal(a.failed_links, b.failed_links)
    assert not np.array_equal(a.failed_links, c.failed_links)
    assert a.n_failed_links == round(0.1 * g.m)


def test_random_node_faults_include_incident_links():
    g = T.hypercube(5)
    sc = F.random_node_faults(g, 0.2, seed=1)
    assert sc.n_failed_nodes == round(0.2 * g.n)
    dead = set(sc.failed_nodes.tolist())
    expect = {i for i, (u, v) in enumerate(g.edges)
              if u in dead or v in dead}
    assert set(sc.failed_links.tolist()) == expect


def test_adversarial_degree_attack_removes_claimed_nodes():
    g = T.fat_tree(3, 2)
    deg = g.degrees(include_loops=False)
    sc = F.adversarial_degree_attack(g, 0.1)
    f = sc.n_failed_nodes
    assert f == round(0.1 * g.n)
    alive = np.setdiff1d(np.arange(g.n), sc.failed_nodes)
    assert deg[sc.failed_nodes].min() >= deg[alive].max() - 1e-9
    d = F.apply_faults(g, sc)
    assert d.n == g.n - f
    dead = np.zeros(g.n, dtype=bool)
    dead[sc.failed_nodes] = True
    kept = (~dead[g.edges[:, 0]]) & (~dead[g.edges[:, 1]])
    assert d.m == int(kept.sum()) == g.m - sc.n_failed_links


def test_adversarial_spectral_attack_removes_top_fiedler_edges():
    g = T.torus(8, 2)
    f = S.fiedler_vector(g)
    sc = F.adversarial_spectral_attack(g, 0.1, fiedler=f)
    energy = (f[g.edges[:, 0]] - f[g.edges[:, 1]]) ** 2
    t = sc.n_failed_links
    assert t == round(0.1 * g.m)
    assert np.allclose(np.sort(energy[sc.failed_links]), np.sort(energy)[-t:])
    d = F.apply_faults(g, sc)
    assert d.m == g.m - t
    rand = F.apply_faults(g, F.random_link_faults(g, 0.1, seed=0))
    assert S.laplacian_spectrum(d)[1] <= S.laplacian_spectrum(rand)[1] + 1e-9


def test_spectral_attack_solves_its_own_fiedler_on_device(ref):
    """Without a Fiedler vector the attack solves for one (dense up to the
    threshold) and matches the reference's choice."""
    g = T.torus(8, 2)
    got = F.adversarial_spectral_attack(g, 0.1, device=CPU)
    want = ref.faults.adversarial_spectral_attack(ref_topology(ref, g), 0.1)
    _assert_scenarios_equal(got, want)


def test_apply_faults_strips_healthy_only_meta():
    g = build("torus(8,2)")
    assert g.meta.get("vertex_transitive")
    d = F.apply_faults(g, F.random_link_faults(g, 0.1, seed=0))
    assert "vertex_transitive" not in d.meta and "spec" not in d.meta
    assert d.meta["fault"]["kind"] == "link"


def test_rates_out_of_range_rejected():
    g = T.petersen()
    for model in F.FAULT_MODELS:
        with pytest.raises(ValueError, match="fault rate"):
            F.make_scenario(g, model, 1.0, device=CPU)
    with pytest.raises(ValueError, match="unknown fault model"):
        F.make_scenario(g, "meteor", 0.1, device=CPU)


# --------------------------------------------------------------------------
# stacked operands + batched degraded solve
# --------------------------------------------------------------------------

def test_stacked_operands_apply_exact_laplacian(ref):
    g = T.fat_tree(3, 2)
    scen = [F.random_link_faults(g, 0.15, seed=i) for i in range(4)]
    degraded = [F.apply_faults(g, s) for s in scen]
    tabs, ws, degs = F.stacked_operands(degraded)
    rng = np.random.default_rng(0)
    for i, d in enumerate(degraded):
        x = rng.normal(size=d.n)
        lx = degs[i] * x - (x[tabs[i]].sum(axis=1) + ws[i] * x)
        assert np.abs(lx - d.laplacian() @ x).max() < 1e-9
    want = ref.faults.stacked_operands([ref_topology(ref, d) for d in degraded])
    for got, exp in zip((tabs, ws, degs), want):
        np.testing.assert_array_equal(got, exp)


def test_batched_rho2_matches_dense_oracle_and_reference(ref):
    g = T.torus(8, 2)
    degraded = [F.apply_faults(g, F.random_link_faults(g, 0.12, seed=i))
                for i in range(8)]
    tabs, ws, degs = F.stacked_operands(degraded)
    got = S.rho2_laplacian_batched(tabs, ws, degs, iters=120, seed=0,
                                   device=CPU)
    want = np.array([S.laplacian_spectrum(d)[1] for d in degraded])
    assert np.abs(got - want).max() < 1e-3
    theirs = ref.spectral.rho2_laplacian_batched(tabs, ws, degs, iters=120,
                                                 seed=0)
    assert np.abs(got - theirs).max() < RHO2_TOL


def test_batched_rho2_flags_disconnection():
    g = T.cycle(32)
    sc = F.FaultScenario(kind="link", rate=2 / 32, seed=0,
                         failed_links=np.array([0, 16]),
                         failed_nodes=np.empty(0, dtype=np.int64))
    d = F.apply_faults(g, sc)
    assert F.connected_component_count(d.n, d.edges) == 2
    tabs, ws, degs = F.stacked_operands([d])
    got = S.rho2_laplacian_batched(tabs, ws, degs, iters=64, seed=0,
                                   device=CPU)
    assert got[0] < 1e-4


def test_connected_component_count_matches_reference(ref):
    g = T.torus(6, 2)
    for seed in range(4):
        d = F.apply_faults(g, F.random_link_faults(g, 0.4, seed=seed))
        assert F.connected_component_count(d.n, d.edges) == \
            ref.faults.connected_component_count(d.n, d.edges)
    assert F.connected_component_count(5, np.empty((0, 2), np.int64)) == 5


# --------------------------------------------------------------------------
# sweeps: parity, determinism, analytic bounds
# --------------------------------------------------------------------------

def _assert_rows_equal(got, want):
    assert len(got.rows) == len(want.rows)
    assert got.batched_solves == want.batched_solves
    assert got.rho2_healthy == pytest.approx(want.rho2_healthy, abs=1e-9)
    for rg, rw in zip(got.rows, want.rows):
        assert set(rg) == set(rw)
        for key, exp in rw.items():
            val = rg[key]
            if key in ("rho2_mean", "rho2_min", "rho2_max"):
                assert val == pytest.approx(exp, abs=RHO2_TOL), key
            elif key in ("rho2_retention", "bw_fiedler_lb_mean",
                         "diameter_ub") and exp is not None:
                # functions of the float32 rho2 values
                assert val == pytest.approx(exp, rel=1e-3, abs=RHO2_TOL), key
            elif key.startswith("sim_"):
                assert val == pytest.approx(exp, rel=1e-5, abs=1e-12), key
            elif isinstance(exp, float):
                assert val == pytest.approx(exp, rel=1e-12), key
            else:
                assert val == exp, key


@pytest.mark.parametrize("spec,model,kw", [
    ("torus(8,2)", "link", dict(samples=8)),
    ("slimfly(5)", "node", dict(samples=4)),
    ("fat_tree(3,2)", "attack_degree", {}),
    ("hypercube(5)", "attack_spectral", {}),
    ("petersen_torus(3,3)", "link", dict(samples=4, routing=True,
                                         simulate=True,
                                         sim_payload=float(1 << 22))),
])
def test_fault_sweep_equals_reference(ref, spec, model, kw):
    g = build(spec)
    rates = (0.05, 0.15)
    got = F.fault_sweep(g, rates=rates, model=model, seed=3, iters=80,
                        device=CPU, **kw)
    want = ref.faults.fault_sweep(ref_topology(ref, g), rates=rates, model=model,
                                  seed=3, iters=80, **kw)
    _assert_rows_equal(got, want)


def test_fault_sweep_seed_deterministic():
    g = T.hypercube(6)
    a = F.fault_sweep(g, rates=(0.05, 0.15), samples=8, seed=3, iters=80,
                      device=CPU)
    b = F.fault_sweep(g, rates=(0.05, 0.15), samples=8, seed=3, iters=80,
                      device=CPU)
    c = F.fault_sweep(g, rates=(0.05, 0.15), samples=8, seed=4, iters=80,
                      device=CPU)
    for ra, rb in zip(a.rows, b.rows):
        assert ra["rho2_mean"] == rb["rho2_mean"]
        assert ra["connectivity_prob"] == rb["connectivity_prob"]
    assert any(ra["rho2_mean"] != rc["rho2_mean"]
               for ra, rc in zip(a.rows, c.rows))


def test_interlacing_bound_upper_bounds_sampled_gap():
    for g in (T.torus(8, 2), T.slimfly(5)):
        sweep = F.fault_sweep(g, rates=(0.02, 0.1, 0.25), model="link",
                              samples=16, seed=0, iters=100, device=CPU)
        for row in sweep.rows:
            assert row["interlacing_rho2_ub"] == pytest.approx(
                sweep.rho2_healthy)
            assert row["rho2_max"] <= row["interlacing_rho2_ub"] + 1e-3
            assert row["rho2_min"] >= row["weyl_rho2_lb"] - 1e-3


def test_fault_sweep_single_batched_solve_per_rate():
    g = T.torus(8, 2)
    sweep = F.fault_sweep(g, rates=(0.05, 0.1, 0.2), samples=32, seed=0,
                          iters=60, device=CPU)
    assert sweep.batched_solves == 3
    assert all(r["samples"] == 32 for r in sweep.rows)


def test_fault_sweep_rejects_unknown_model_and_workload():
    with pytest.raises(ValueError, match="unknown fault model"):
        F.fault_sweep(T.petersen(), model="meteor", device=CPU)
    with pytest.raises(NotImplementedError, match="core/workloads"):
        F.fault_sweep(T.petersen(), workload="lm100m@dp=2", device=CPU)


# --------------------------------------------------------------------------
# api surface
# --------------------------------------------------------------------------

def test_analysis_fault_sweep_uses_cached_healthy_rho2():
    a = Analysis("torus(8,2)", device=CPU)
    sweep = a.fault_sweep(rates=(0.1,), samples=4)
    assert sweep.rho2_healthy == pytest.approx(a.rho2)
    assert "rate" in sweep.rows[0] and "fault model" in sweep.report()
    assert sweep.to_dict()["batched_solves"] == 1
    assert sweep.curve("rho2_mean")[0][0] == 0.1


def test_survey_faults_appends_resilience_columns(ref):
    kw = dict(faults=dict(rate=0.1, samples=4))
    res = survey(["torus(6,2)", "petersen"], device=CPU, **kw)
    want = ref.survey.survey(["torus(6,2)", "petersen"], **kw)
    for col in ("fault_rate", "rho2_degraded", "rho2_retention",
                "connectivity_prob", "bw_fiedler_lb_degraded"):
        assert col in res.columns
        assert all(col in r for r in res.rows)
    assert all(r["fault_rate"] == 0.1 for r in res.rows)
    assert all(r["rho2_degraded"] <= r["rho2"] + 1e-3 for r in res.rows)
    for row, exp in zip(res, want):
        assert row["connectivity_prob"] == exp["connectivity_prob"]
        assert row["rho2_degraded"] == pytest.approx(exp["rho2_degraded"],
                                                     abs=RHO2_TOL)


# --------------------------------------------------------------------------
# placement (core/placement)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 4, 6, 17])
def test_min_alpha_is_the_zero_crossing(ref, k):
    a_min = PL.min_alpha_for_positive_guarantee(k)
    assert a_min == ref.placement.min_alpha_for_positive_guarantee(k)
    assert 0.0 < a_min < 1.0
    n = 1024
    assert B.active_subset_bw_lb(a_min, n, k) == pytest.approx(0.0, abs=1e-6)
    assert B.active_subset_bw_lb(a_min - 0.05, n, k) < 0.0
    assert B.active_subset_bw_lb(min(a_min + 0.05, 1.0), n, k) > 0.0


@pytest.mark.parametrize("k", [4, 6])
def test_guarantee_clamps_below_threshold(ref, k):
    a_min = PL.min_alpha_for_positive_guarantee(k)
    for alpha in (a_min, a_min / 2, 0.1):
        g = PL.ramanujan_placement_guarantee(n=512, k=k, alpha=alpha)
        assert g.guaranteed_bisection_edges == pytest.approx(0.0, abs=1e-4)
        assert g.nodes_active == int(alpha * 512)
    above = PL.ramanujan_placement_guarantee(n=512, k=k,
                                             alpha=min(a_min + 0.05, 1.0))
    assert above.guaranteed_bisection_edges > 0.0
    assert above.__dict__ == ref.placement.ramanujan_placement_guarantee(
        n=512, k=k, alpha=min(a_min + 0.05, 1.0)).__dict__


@pytest.mark.parametrize("k", [3, 4, 6, 17])
def test_alpha_one_recovers_full_graph_bound(k):
    n = 1024
    full = B.active_subset_bw_lb(1.0, n, k)
    assert full == pytest.approx(B.ramanujan_bw_lb(n, k), rel=1e-12)
    assert full == pytest.approx(B.fiedler_bw_lb(n, B.ramanujan_rho2(k)),
                                 rel=1e-12)


def test_empirical_subset_bw_complete_graph_closed_form():
    g = T.complete(12)
    for alpha in (0.5, 1.0):
        na = max(2, int(alpha * g.n))
        expect = (na // 2) * (na - na // 2)
        for seed in (0, 7):
            assert PL.empirical_subset_bw(g, alpha, trials=4, seed=seed) \
                == expect


def test_empirical_subset_bw_deterministic_and_monotone_in_trials(ref):
    g = T.torus(6, 2)
    a = PL.empirical_subset_bw(g, 0.4, trials=16, seed=3)
    assert a == PL.empirical_subset_bw(g, 0.4, trials=16, seed=3)
    assert a == ref.placement.empirical_subset_bw(ref_topology(ref, g), 0.4,
                                                  trials=16, seed=3)
    assert PL.empirical_subset_bw(g, 0.4, trials=64, seed=3) <= a


def test_empirical_subset_bw_tiny_alpha_floors_at_two_nodes():
    worst = PL.empirical_subset_bw(T.cycle(16), alpha=0.01, trials=32,
                                   seed=0)
    assert worst in (0.0, 1.0)


def test_non_ramanujan_fallback_measures_the_missing_guarantee():
    g = T.torus(8, 2)
    floor_full = B.fiedler_bw_lb(g.n, algebraic_connectivity(g, device=CPU))
    assert PL.empirical_subset_bw(g, alpha=1.0, trials=8, seed=0) >= floor_full
    assert PL.empirical_subset_bw(g, alpha=0.3, trials=32, seed=0) < floor_full


@pytest.mark.parametrize("strategy", ["linear", "round_robin", "random"])
@pytest.mark.parametrize("n,world", [(16, 64), (64, 16), (7, 7)])
def test_place_ranks_equals_reference(ref, strategy, n, world):
    got = PL.place_ranks(n, world, strategy, seed=5)
    np.testing.assert_array_equal(
        got, ref.placement.place_ranks(n, world, strategy, seed=5))
    counts = np.bincount(got, minlength=n)
    assert counts.max() - counts[counts > 0].min() <= 1 or world < n


def test_place_ranks_rejects_bad_arguments():
    with pytest.raises(ValueError):
        PL.place_ranks(0, 4)
    with pytest.raises(ValueError, match="unknown placement"):
        PL.place_ranks(4, 4, "spiral")


def test_chip_smoke_fault_sim_constants_are_the_reference(ref):
    """chip_smoke.py holds its simulate=True sweep (FAULT_SIM) to
    FAULT_SIM_REF: recomputed here with the reference's stacked ring on the
    sweep's own degraded samples.  (The port's stacked ring is held to the
    reference's sample for sample on hypercube(5) in
    tests/test_torch_simulate.py; at lps(13,5) it runs on the card.)"""
    smoke = load_chip_smoke()
    cfg = smoke.FAULT_SIM
    g = build(cfg["spec"])
    degraded = [F.apply_faults(g, F.make_scenario(
        g, "link", cfg["rate"], seed=cfg["seed"] + 7919 * i, device=CPU))
        for i in range(cfg["samples"])]
    width = max(int(np.bincount(g.edges.reshape(-1), minlength=g.n).max()),
                1)
    want = ref.simulate.stacked_ring_allreduce(
        F.stacked_operands(degraded, width=width)[0])
    t, d = want["time_seconds"], want["dropped_frac"]
    for key, val in (("sim_allreduce_mean", t.mean()),
                     ("sim_allreduce_max", t.max()),
                     ("sim_dropped_frac_mean", d.mean())):
        assert val == pytest.approx(smoke.FAULT_SIM_REF[key], rel=1e-12,
                                    abs=1e-15), key


@pytest.mark.parametrize("spec", ["slimfly(5)", "hypercube(5)",
                                  "torus(8,2)"])
def test_chip_smoke_attack_oracle_matches_the_sweep(spec):
    """chip_smoke.py holds the spectral attack's rows to the host's dense
    float64 rho2 of the attacked graph (its energies tie on symmetric
    families, so the host BLAS picks the cut): the oracle agrees with the
    sweep's batched Lanczos on the CPU and counts the ties at the cut."""
    smoke = load_chip_smoke()
    a = Analysis(spec, device=CPU)
    row = a.fault_sweep(rates=(0.1,), model="attack_spectral",
                        iters=160).rows[0]
    want = smoke._attack_oracle(np, a, "attack_spectral", 0.1)
    smoke._fault_row_check(row, want, spec)
    assert want["ties_in_cut"] >= 1
    assert want["failed_links_mean"] == round(0.1 * a.topo.m)


@pytest.mark.cuda
def test_cuda_stacked_ring_matches_reference_figures():
    """chip_smoke.py's simulate=True sweep on the card (lps(13,5), 8
    degraded samples, each lowered in turn through K1's f64 batches)
    against the reference's figures (FAULT_SIM_REF, float32 there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    smoke = load_chip_smoke()
    cfg = smoke.FAULT_SIM
    g = build(cfg["spec"])
    row = F.fault_sweep(g, rates=(cfg["rate"],), samples=cfg["samples"],
                        seed=cfg["seed"], iters=cfg["iters"], simulate=True,
                        device="cuda").rows[0]
    for key, val in smoke.FAULT_SIM_REF.items():
        assert row[key] == pytest.approx(val, rel=smoke.SIM_REL_TOL,
                                         abs=1e-12), key
