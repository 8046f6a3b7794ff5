"""Path-level routing and minimal-ECMP traffic of the port against the JAX
reference on the CPU.

Held exactly: BFS distances and minimal-path counts (float64 integers on
both sides — the reference turns x64 on around its sigma DP), source
sampling, the bootstrap CI, every ``RoutingResult`` field, demand patterns.
ECMP loads: the port accumulates in float64 throughout, while the
reference's ``ecmp_link_loads`` casts sigma and the demands to float32 —
so the reference's accumulation kernels are run here under x64 on float64
operands and held to the port at 1e-9, the port is also held to a brute
force float64 oracle at 1e-9, and the reference's public float32 figures
(``evaluate_traffic``, survey rows) at a relative 1e-5, its float32
rounding.  Tests marked ``cuda`` run on the card and skip elsewhere.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.api import Analysis, survey
from repro_torch.api import registry as PR
from repro_torch.core import routing as R
from repro_torch.core import traffic as TR
from repro_torch.specs import SCALE_BENCH_SPECS, SCALE_COLUMNS
from test_torch_harness import load_reference

CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _table(spec):
    return PR.build(spec).gather_operands()[0]


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["torus(16,2)", "hypercube(8)", "ccc(6)",
                                  "dragonfly", "data_vortex(4,3)",
                                  "random_regular(256,6,0)"])
def test_dist_and_sigma_equal_reference(ref, spec):
    tab = _table(spec)
    srcs = np.arange(0, tab.shape[0], 3)
    dist = R.bfs_distances(tab, srcs, chunk=40, device=CPU)
    want = ref.routing.bfs_distances(tab, srcs, chunk=64)
    assert dist.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(dist, want)
    sigma = R.shortest_path_counts(tab, dist, chunk=40, device=CPU)
    want_sigma = ref.routing.shortest_path_counts(tab, want)
    assert sigma.dtype == want_sigma.dtype == np.float64
    np.testing.assert_array_equal(sigma, want_sigma)


def test_torus32_antipodal_count_is_exact():
    want = 4 * math.comb(32, 16)            # 2,404,321,560 > 2^31
    tab = _table("torus(32,2)")
    dist = R.bfs_distances(tab, sources=[0], device=CPU)
    sigma = R.shortest_path_counts(tab, dist, device=CPU)
    assert dist[0, 16 * 32 + 16] == 32
    assert sigma[0, 16 * 32 + 16] == want


def test_host_helpers_identical(ref):
    tab = _table("butterfly(3,4)")
    np.testing.assert_array_equal(R.reverse_slot_index(tab),
                                  ref.routing.reverse_slot_index(tab))
    for n, s, seed in ((1000, 17, 0), (65536, 64, 0), (50, 80, 3)):
        np.testing.assert_array_equal(R.sample_sources(n, s, seed),
                                      ref.routing.sample_sources(n, s, seed))
    dist = R.bfs_distances(tab, R.sample_sources(tab.shape[0], 20, 4),
                           device=CPU)
    srcs = R.sample_sources(tab.shape[0], 20, 4)
    assert R._bootstrap_avg_hops_ci(dist, srcs, 4, 256, 0.95) == \
        ref.routing._bootstrap_avg_hops_ci(dist, srcs, 4, 256, 0.95)


@pytest.mark.parametrize("spec", SCALE_BENCH_SPECS)
def test_routing_result_equals_reference(ref, spec):
    """Every RoutingResult field on the routing-bench families: exact
    analysis below 400 nodes, a seeded 20 % sample above."""
    topo, rtopo = PR.build(spec), ref.registry.build(spec)
    kw = {} if topo.n < 400 else dict(sample_fraction=0.2, seed=2)
    got = R.analyze_routing(topo, device=CPU, **kw)
    want = ref.routing.analyze_routing(rtopo, **kw)
    for f in ("name", "n", "exact", "diameter", "avg_path_length",
              "unreachable_pairs", "path_diversity_mean",
              "path_diversity_min", "diameter_lb", "avg_hops_ci", "seed"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("sources", "dist", "sigma", "hop_histogram", "eccentricity"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    d, w = got.to_dict(), want.to_dict()
    d.pop("seconds"), w.pop("seconds")
    assert d == w


@pytest.mark.parametrize("spec", ["lps(13,5)", "petersen_torus(5,4)",
                                  "random_regular(256,6,0)"])
def test_sample_fraction_one_equals_exact(spec):
    """The reference's own bitwise case (benchmarks/scale_bench.py)."""
    topo = PR.build(spec)
    exact = R.analyze_routing(topo, device=CPU)
    full = R.analyze_routing(topo, sample_fraction=1.0, seed=1, device=CPU)
    assert full.exact
    for f in ("sources", "dist", "sigma", "hop_histogram"):
        np.testing.assert_array_equal(getattr(full, f), getattr(exact, f))
    assert full.diameter == exact.diameter == full.diameter_lb
    assert full.avg_path_length == exact.avg_path_length
    assert full.path_diversity_mean == exact.path_diversity_mean
    assert full.avg_hops_ci == (exact.avg_path_length, exact.avg_path_length)


def test_routing_stats_stacked_equals_reference(ref):
    g = PR.build("random_regular(48,4,3)")
    tabs = [PR.build(f"random_regular(48,4,{s})").gather_operands()[0]
            for s in range(3)]
    # a degraded sample: edges dropped, rows self-padded, one vertex cut off
    cut = g.edges[(g.edges != 7).all(axis=1)][:-5]
    from repro_torch.core.graphs import Topology
    tabs.append(Topology("cut", 48, cut).gather_operands()[0][:, :4])
    tables = np.stack(tabs)
    for sources in (None, [0, 7, 30]):
        got = R.routing_stats_stacked(tables, sources, device=CPU)
        want = ref.routing.routing_stats_stacked(tables, sources)
        assert got == want


# --------------------------------------------------------------------------
# traffic: demands, ECMP loads, evaluate_traffic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["uniform", "bit_complement", "transpose",
                                     "neighbor", "adversarial"])
def test_demands_identical(ref, pattern):
    n = 64
    fiedler = np.cos(np.arange(n) / 5.0) if pattern == "adversarial" else None
    srcs = [3, 0, 63, 17]
    np.testing.assert_array_equal(
        TR.demand_matrix(pattern, n, fiedler=fiedler),
        ref.traffic.demand_matrix(pattern, n, fiedler=fiedler))
    np.testing.assert_array_equal(
        TR.demand_rows(pattern, n, srcs, fiedler=fiedler),
        ref.traffic.demand_rows(pattern, n, srcs, fiedler=fiedler))
    assert TR.spectral_throughput_estimate(n, 1.7) == \
        ref.traffic.spectral_throughput_estimate(n, 1.7)


def _ecmp_oracle(table, dist_all, sigma_all, D):
    """Brute-force float64 ECMP from the all-pairs matrices: the flow s -> t
    over directed link u -> v is D[s,t] sigma(s,u) sigma(v,t) / sigma(s,t)
    when u -> v lies on a shortest s-t path."""
    n, k = table.shape
    loads = np.zeros((n, k))
    for u in range(n):
        for j in range(k):
            v = table[u, j]
            if v == u:
                continue
            on = (dist_all[:, u][:, None] + 1 + dist_all[v][None, :]
                  == dist_all) & (dist_all > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                f = np.where(on, D * sigma_all[:, u][:, None]
                             * sigma_all[v][None, :] / sigma_all, 0.0)
            loads[u, j] = f.sum()
    return loads


@pytest.mark.parametrize("spec,pattern", [("torus(6,2)", "uniform"),
                                          ("petersen_torus(3,4)",
                                           "bit_complement"),
                                          ("random_regular(30,3,2)",
                                           "neighbor")])
def test_ecmp_loads_float64_match_oracle_and_reference(ref, spec, pattern):
    topo = PR.build(spec)
    tab = topo.gather_operands()[0]
    n = topo.n
    dist = R.bfs_distances(tab, device=CPU)
    sigma = R.shortest_path_counts(tab, dist, device=CPU)
    D = TR.demand_matrix(pattern, n)
    got = TR.ecmp_link_loads(tab, dist, sigma, D, chunk=7, device=CPU)
    np.testing.assert_allclose(got, _ecmp_oracle(tab, dist, sigma, D),
                               rtol=1e-12, atol=1e-9)
    jax, jnp = ref.jax, ref.jnp
    with jax.enable_x64(True):              # the reference's kernel, in f64
        want = np.asarray(ref.traffic._ecmp_loads_chunk(
            jnp.asarray(tab, jnp.int32), jnp.asarray(dist),
            jnp.asarray(sigma), jnp.asarray(np.where(dist >= 0, D, 0.0))))
        cand = np.array([0, 5, 3 * tab.shape[1] + 1, tab.size - 1])
        want_c = np.asarray(ref.traffic._ecmp_loads_cand_chunk(
            jnp.asarray(tab, jnp.int32), jnp.asarray(dist), jnp.asarray(sigma),
            jnp.asarray(D), jnp.asarray(cand, jnp.int32)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    got_c = TR._ecmp_loads_cand_chunk(
        torch.as_tensor(tab), torch.as_tensor(dist), torch.as_tensor(sigma),
        torch.as_tensor(D), torch.as_tensor(cand))
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("spec,pattern,sample", [
    ("torus(16,2)", "uniform", None),
    ("hypercube(8)", "bit_complement", None),
    ("lps(13,5)", "uniform", 0.05),
    ("random_regular(256,6,0)", "transpose", 0.125)])
def test_evaluate_traffic_matches_reference(ref, spec, pattern, sample):
    """Exact and sampled (with the bootstrap UCB).  Figures built from dist
    and the demands only are equal; load figures agree to the reference's
    float32 rounding (relative 1e-5); the port's own conservation error is
    float64-small."""
    topo, rtopo = PR.build(spec), ref.registry.build(spec)
    kw = {} if sample is None else dict(sample_fraction=sample, seed=5)
    got = TR.evaluate_traffic(topo, pattern, device=CPU,
                              routing=R.analyze_routing(topo, device=CPU,
                                                        **kw))
    want = ref.traffic.evaluate_traffic(
        rtopo, pattern, routing=ref.routing.analyze_routing(rtopo, **kw))
    for f in ("name", "pattern", "n", "total_demand", "dropped_demand",
              "avg_hops", "exact", "sample_correction", "scheme"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("max_link_load", "mean_link_load", "saturation_throughput",
              "max_link_load_ucb"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
    np.testing.assert_allclose(got.link_loads, want.link_loads, rtol=1e-5,
                               atol=1e-6)
    assert got.conservation_error <= 1e-12
    if sample is not None:
        assert got.max_link_load_ucb >= got.max_link_load


@pytest.mark.parametrize("spec,cfg", [
    ("lps(13,5)", dict(pattern="uniform")),
    ("xpander(256,6,0,0)", dict(pattern="uniform", sample_fraction=32 / 256,
                                seed=0)),
    ("torus(16,2)", dict(pattern="adversarial"))])
def test_survey_routing_row_matches_reference(ref, spec, cfg):
    got = survey([spec], SCALE_COLUMNS, routing=cfg, device=CPU).rows[0]
    want = ref.survey.survey([spec], SCALE_COLUMNS, routing=cfg).rows[0]
    assert got.keys() == want.keys()
    for c in got:
        if c == "seconds":
            continue
        if c in ("max_link_load", "saturation_throughput"):
            # rounded to 4 decimals from the reference's float32 loads
            assert got[c] == pytest.approx(want[c], abs=1e-4), c
        else:
            assert got[c] == want[c], c


def test_analysis_caches_routing_and_traffic(ref):
    a = Analysis("torus(8,2)", device=CPU)
    r = a.routing(sample_fraction=0.5)
    assert a.routing(sample_fraction=0.5, seed=0) is r
    assert a.routing(sample_fraction=0.5, seed=1) is not r
    assert a.traffic(sample_fraction=0.5) is a.traffic(sample_fraction=0.5)
    ra = ref.analysis.Analysis("torus(8,2)")
    for frac, seed in ((None, None), (0.5, None), (0.5, 3)):
        assert a._routing_key(frac, seed) == ra._routing_key(frac, seed)
    assert a.routing(sources=[1, 2]).sources.tolist() == [1, 2]


def test_schemes_not_ported_raise():
    """The routing schemes, the MCF ceiling and the training-workload
    columns are ported now (their parity is held in
    tests/test_torch_traffic_schemes.py and tests/test_torch_workloads.py):
    each runs here; what still raises is an unknown scheme, column or
    workload spec."""
    topo = PR.build("torus(6,2)")
    for scheme in ("valiant", "ugal", "ksp"):
        res = TR.evaluate_traffic(topo, scheme=scheme, device=CPU)
        assert res.scheme == scheme and res.saturation_throughput > 0
    with pytest.raises(ValueError, match="unknown routing scheme"):
        TR.evaluate_traffic(topo, scheme="adaptive", device=CPU)
    assert np.isfinite(TR.mcf_throughput_ub(topo))
    row = survey(["torus(6,2)"], routing=dict(schemes=True),
                 device=CPU).rows[0]
    assert row["thpt_mcf_ub"] is not None
    row = survey(["torus(6,2)"], workload="lm100m@dp=2", device=CPU).rows[0]
    assert row["workload"] == "lm100m@dp=2,tp=1,ep=1"
    assert row["step_time_ms"] >= row["compute_ms"] > 0
    assert row["comm_dp_ms"] > 0
    with pytest.raises(ValueError, match="unknown model"):
        survey(["torus(6,2)"], workload="lm9000@dp=2", device=CPU)
    with pytest.raises(KeyError, match="unknown survey column"):
        survey(["torus(6,2)"], ["avg_hops"], device=CPU)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_routing_and_ecmp_on_card_equal_cpu(cuda_device):
    from repro_torch.kernels import spmv as KS

    topo = PR.build("torus(16,2)")
    KS.reset_launches()
    card = R.analyze_routing(topo, device=cuda_device)
    assert KS.launches() > 0                # the f64 sigma DP went through K1
    host = R.analyze_routing(topo, device=CPU)
    np.testing.assert_array_equal(card.dist, host.dist)
    np.testing.assert_array_equal(card.sigma, host.sigma)
    got = TR.evaluate_traffic(topo, routing=card, device=cuda_device)
    want = TR.evaluate_traffic(topo, routing=host, device=CPU)
    np.testing.assert_allclose(got.link_loads, want.link_loads, rtol=1e-12,
                               atol=1e-12)
