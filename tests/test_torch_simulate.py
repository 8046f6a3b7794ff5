"""The port's link-level simulator (``core/simulate``) and collective cost
model (``core/collectives``) against the JAX reference on the CPU.

Follows the reference's ``tests/test_simulate.py`` and
``tests/test_collectives.py`` case for case, with the port on
``device="cpu"``, and holds each executed schedule to the reference's.

Tolerances.  The reference stores round bytes in float32 (and lowers them
through its float32 ECMP) and runs its round engine in float32; the port
keeps both in float64.  Simulated times, round bytes and throughputs are
held at 1e-5 relative, the reference's float32 rounding; the closed-form
cross-checks are held at 1e-12 in the port.  The collective model is host
float64 code in both: held to 1e-12.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.api import SIM_COLUMNS, Analysis, build, survey
from repro_torch.core import faults as F
from repro_torch.core import routing as R
from repro_torch.core import simulate as SM
from repro_torch.core import topologies as T
from repro_torch.core.collectives import (LINK_BW, PER_HOP_LATENCY,
                                          NetworkModel,
                                          network_from_topology, tpu_v5e_ici)
from repro_torch.core.placement import (empirical_subset_bw,
                                        ramanujan_placement_guarantee)
from repro_torch.core.ramanujan import lps
from test_torch_harness import load_reference, ref_topology

CPU = "cpu"
BW, LAT = LINK_BW, PER_HOP_LATENCY
#: the reference's float32 round bytes and engine
F32_RTOL = 1e-5
EXACT = 1e-12


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


def _stack(topo, degraded):
    width = max(int(np.bincount(topo.edges.reshape(-1),
                                minlength=topo.n).max()), 1)
    return F.stacked_operands(degraded, width=width)[0]


def _assert_sim_equal(got, want):
    """One executed schedule against the reference's."""
    assert (got.rounds, got.unique_rounds) == (want.rounds,
                                               want.unique_rounds)
    np.testing.assert_allclose(got.time_seconds, want.time_seconds,
                               rtol=F32_RTOL)
    np.testing.assert_allclose(got.payload_bytes, want.payload_bytes,
                               rtol=EXACT)
    scale = float(np.abs(want.link_busy_seconds).max())
    np.testing.assert_allclose(got.link_busy_seconds, want.link_busy_seconds,
                               rtol=F32_RTOL, atol=F32_RTOL * scale)
    for f in ("max_link_bytes", "total_bytes", "utilization_max",
              "utilization_mean"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=F32_RTOL), f
    assert got.dropped_demand == pytest.approx(want.dropped_demand,
                                               rel=F32_RTOL, abs=1e-9)


# --------------------------------------------------------------------------
# schedule compiler
# --------------------------------------------------------------------------

def test_ring_allreduce_schedule_shape():
    g = T.cycle(8)
    s = SM.compile_schedule(g, "all_reduce", "ring", device=CPU)
    assert s.unique_rounds == 1
    assert s.rounds == 2 * (g.n - 1)
    assert s.hops.tolist() == [1]
    assert s.dropped_demand == 0.0


@pytest.mark.parametrize("collective,algorithm,phases", [
    ("all_reduce", "ring", 2), ("reduce_scatter", "ring", 1),
    ("all_gather", "ring", 1)])
def test_ring_round_counts_per_collective(collective, algorithm, phases):
    g = T.torus(4, 2)
    s = SM.compile_schedule(g, collective, algorithm, device=CPU)
    assert s.rounds == phases * (g.n - 1)


@pytest.mark.parametrize("collective,algorithm", [
    ("all_reduce", "ring"), ("all_reduce", "halving_doubling"),
    ("reduce_scatter", "halving_doubling"), ("all_gather", "bruck"),
    ("all_gather", "halving_doubling"), ("broadcast", "bfs_tree"),
    ("broadcast", "binomial")])
@pytest.mark.parametrize("spec", ["hypercube(4)", "torus(4,2)"])
def test_schedules_equal_reference(ref, spec, collective, algorithm):
    g = build(spec)
    gr = ref_topology(ref, g)
    got = SM.compile_schedule(g, collective, algorithm, root=3, device=CPU)
    want = ref.simulate.compile_schedule(gr, collective, algorithm, root=3)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.hops, want.hops)
    scale = float(want.round_bytes.max())
    np.testing.assert_allclose(got.round_bytes, want.round_bytes,
                               rtol=F32_RTOL, atol=F32_RTOL * scale)
    assert got.round_bytes.dtype == np.float64


@pytest.mark.parametrize("scheme", ["valiant", "ugal", "ksp"])
def test_nonminimal_lowering_equals_reference(ref, scheme):
    g = T.petersen()
    gr = ref_topology(ref, g)
    got = SM.simulate_collective(g, "all_reduce", "ring", scheme=scheme,
                                 payloads=float(1 << 24), device=CPU)
    want = ref.simulate.simulate_collective(gr, "all_reduce", "ring",
                                            scheme=scheme,
                                            payloads=float(1 << 24))
    _assert_sim_equal(got, want)


def test_schedule_conservation_matches_ecmp():
    g = T.petersen()
    a = Analysis(g, device=CPU)
    r = a.routing()
    s = SM.compile_schedule(g, "all_reduce", "ring", routing=r, device=CPU)
    D = SM._logical_rounds_ring(g.n, phases=1)[0][0]
    hops_weighted = float((D * np.maximum(r.dist, 0)).sum())
    assert float(s.round_bytes[0].sum()) == pytest.approx(hops_weighted,
                                                          rel=EXACT)


def test_halving_doubling_requires_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        SM.compile_schedule(T.cycle(6), "all_reduce", "halving_doubling",
                            device=CPU)


def test_unknown_collective_and_algorithm_raise():
    g = T.cycle(4)
    with pytest.raises(ValueError, match="unknown collective"):
        SM.compile_schedule(g, "all_to_all", device=CPU)
    with pytest.raises(ValueError, match="unknown algorithm"):
        SM.compile_schedule(g, "all_reduce", "bruck", device=CPU)
    with pytest.raises(ValueError, match="routing scheme"):
        SM.compile_schedule(g, "all_reduce", scheme="compass", device=CPU)


def test_single_node_rejected_with_clear_error():
    with pytest.raises(ValueError, match="at least 2 nodes"):
        SM.simulate_collective(T.path(1), "all_gather", "bruck", device=CPU)
    with pytest.raises(ValueError, match="at least 2 nodes"):
        SM.simulate_traffic(T.path(1), "neighbor", device=CPU)


def test_sampled_routing_rejected_by_compiler():
    g = T.hypercube(4)
    r = R.analyze_routing(g, sample_fraction=0.5, seed=0, device=CPU)
    with pytest.raises(ValueError, match="all-sources"):
        SM.compile_schedule(g, routing=r, device=CPU)


def test_total_sent_bytes_match_model_traffic_factors():
    hc = T.hypercube(4)
    s = SM.compile_schedule(hc, "all_reduce", "halving_doubling", device=CPU)
    assert s.total_link_bytes().sum() / hc.n == pytest.approx(
        2.0 * (hc.n - 1) / hc.n, rel=EXACT)
    kn = T.complete(8)
    s = SM.compile_schedule(kn, "all_gather", "bruck", device=CPU)
    assert s.total_link_bytes().sum() / kn.n == pytest.approx(
        (kn.n - 1) / kn.n, rel=EXACT)


def test_bfs_tree_broadcast_loads_only_physical_links():
    g = T.cycle(9)
    s = SM.compile_schedule(g, "broadcast", "bfs_tree", device=CPU)
    assert s.hops.max() == 1
    assert s.unique_rounds == 4
    assert float(s.round_bytes.max()) == pytest.approx(1.0)
    assert float(s.total_link_bytes().sum()) == pytest.approx(8.0)


def test_broadcast_root_parameter():
    g = T.path(5)
    s0 = SM.compile_schedule(g, "broadcast", "bfs_tree", root=0, device=CPU)
    s2 = SM.compile_schedule(g, "broadcast", "bfs_tree", root=2, device=CPU)
    assert s0.unique_rounds == 4 and s2.unique_rounds == 2


# --------------------------------------------------------------------------
# round engine: closed-form cross-checks
# --------------------------------------------------------------------------

def test_ring_allreduce_on_cycle_closed_form():
    g = T.cycle(8)
    B_ = float(1 << 24)
    r = SM.simulate_collective(g, "all_reduce", "ring", payloads=B_,
                               device=CPU)
    expect = 2 * 7 * (B_ / (8 * BW) + LAT)
    assert float(r.time_seconds[0]) == pytest.approx(expect, rel=EXACT)
    assert r.utilization_max == pytest.approx(r.utilization_mean, rel=EXACT)


def test_halving_doubling_on_hypercube_closed_form():
    d = 4
    g = T.hypercube(d)
    B_ = float(1 << 24)
    r = SM.simulate_collective(g, "all_reduce", "halving_doubling",
                               payloads=B_, device=CPU)
    expect = 2 * sum(B_ / (2 ** (i + 1) * BW) + LAT for i in range(d))
    assert float(r.time_seconds[0]) == pytest.approx(expect, rel=EXACT)
    assert r.rounds == 2 * d


def test_binomial_broadcast_on_complete_closed_form():
    g = T.complete(8)
    B_ = float(1 << 22)
    r = SM.simulate_collective(g, "broadcast", "binomial", payloads=B_,
                               device=CPU)
    assert float(r.time_seconds[0]) == pytest.approx(3 * (B_ / BW + LAT),
                                                     rel=EXACT)


def test_engine_time_affine_in_payload(ref):
    g = T.torus(4, 2)
    pays = [float(1 << 20), float(1 << 21), float(1 << 22)]
    r = SM.simulate_collective(g, "all_reduce", "ring", payloads=pays,
                               device=CPU)
    t = r.time_seconds
    assert t[0] < t[1] < t[2]
    d1, d2 = t[1] - t[0], (t[2] - t[1]) / 2.0
    assert d1 == pytest.approx(d2, rel=1e-9)
    _assert_sim_equal(r, ref.simulate.simulate_collective(
        ref_topology(ref, g), "all_reduce", "ring", payloads=pays))


def test_utilization_accounting():
    g = T.cycle(6)
    r = SM.simulate_collective(g, "all_reduce", "ring",
                               payloads=float(1 << 24), device=CPU)
    util = r.utilization()
    assert 0.0 < r.utilization_max <= 1.0 + 1e-9
    assert util.shape == g.gather_operands()[0].shape
    hist = r.utilization_histogram(bins=5)
    assert sum(hist["counts"]) == g.n
    hot = r.hot_links(g.gather_operands()[0], top=3)
    assert len(hot) == 3 and all(0 <= u < g.n and 0 <= v < g.n
                                 for u, v, _ in hot)


def test_telemetry_equals_reference(ref):
    g = T.petersen()
    got = SM.simulate_collective(g, "all_reduce", "ring",
                                 payloads=[float(1 << 20), float(1 << 26)],
                                 telemetry=True, device=CPU)
    want = ref.simulate.simulate_collective(
        ref_topology(ref, g), "all_reduce", "ring",
        payloads=[float(1 << 20), float(1 << 26)], telemetry=True)
    _assert_sim_equal(got, want)
    tg, tw = got.telemetry, want.telemetry
    for f in ("round_seconds", "round_bw_seconds", "round_max_link_load",
              "round_mean_link_load", "round_util_max", "round_util_mean"):
        np.testing.assert_allclose(getattr(tg, f), getattr(tw, f),
                                   rtol=F32_RTOL)
    assert tg.total_seconds() == pytest.approx(float(got.time_seconds[-1]),
                                               rel=EXACT)
    d = json.loads(json.dumps(got.to_dict()))
    assert d["collective"] == "all_reduce" and d["rounds"] == got.rounds
    assert len(d["time_seconds"]) == 2
    assert len(d["telemetry"]["round_seconds"]) == 1
    text = got.report()
    assert "all_reduce/ring" in text and "utilization" in text


# --------------------------------------------------------------------------
# traffic workloads
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["uniform", "adversarial"])
def test_workload_throughput_matches_static_ecmp(ref, pattern):
    a = Analysis("petersen_torus(3,3)", device=CPU)
    sim = a.simulate("traffic", pattern=pattern)
    static = a.traffic(pattern)
    assert sim.saturation_throughput == pytest.approx(
        static.saturation_throughput, rel=EXACT)
    want = ref.analysis.Analysis("petersen_torus(3,3)").simulate(
        "traffic", pattern=pattern)
    _assert_sim_equal(sim, want)
    assert sim.saturation_throughput == pytest.approx(
        want.saturation_throughput, rel=F32_RTOL)


def test_traffic_sim_rejects_pattern_on_collectives():
    a = Analysis("cycle(6)", device=CPU)
    with pytest.raises(ValueError, match="traffic"):
        a.simulate("all_reduce", pattern="uniform")
    with pytest.raises(ValueError, match="ECMP"):
        a.simulate("traffic", "ring")


def test_simulate_workload_not_ported():
    a = Analysis("cycle(6)", device=CPU)
    with pytest.raises(NotImplementedError, match="item 2"):
        a.simulate(workload="lm100m@dp=2")
    with pytest.raises(NotImplementedError, match="core/workloads"):
        survey(["petersen"], workload="lm100m@dp=2", device=CPU)


# --------------------------------------------------------------------------
# simulated vs predicted (the validation loop)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["slimfly(5)", "torus(6,2)", "hypercube(5)",
                                  "ccc(4)"])
def test_measured_at_or_above_model_lower_bound(ref, spec):
    a = Analysis(spec, device=CPU)
    pays = [float(1 << 20), float(1 << 26)]
    sim = a.simulate("all_reduce", "ring", payload=pays)
    val = a.network_model().validate(sim)
    assert val["all_measured_geq_predicted"]
    assert all(r["ratio"] >= 1.0 - 1e-6 for r in val["rows"])
    ra = ref.analysis.Analysis(spec)
    want = ra.network_model().validate(ra.simulate("all_reduce", "ring",
                                                   payload=pays))
    for got, exp in zip(val["rows"], want["rows"]):
        assert got["predicted_s"] == pytest.approx(exp["predicted_s"],
                                                   rel=EXACT)
        assert got["measured_s"] == pytest.approx(exp["measured_s"],
                                                  rel=F32_RTOL)


def test_broadcast_bound_holds_for_central_roots():
    a = Analysis(T.random_regular(20, 3, seed=0), device=CPU)
    sim = a.simulate("broadcast", "bfs_tree", payload=1.0, root=2)
    val = a.network_model().validate(sim)
    assert val["all_measured_geq_predicted"]


def test_validate_rejects_unknown_collective():
    a = Analysis("cycle(6)", device=CPU)
    sim = a.simulate("traffic", pattern="uniform")
    with pytest.raises(ValueError, match="cannot validate"):
        a.network_model().validate(sim)


def test_validate_flags_an_impossible_measurement():
    a = Analysis("cycle(8)", device=CPU)
    sim = a.simulate("all_reduce", "ring")
    fake = SM.SimulationResult(**{**sim.__dict__,
                                  "time_seconds": sim.time_seconds * 1e-6})
    assert not a.network_model().validate(fake)["all_measured_geq_predicted"]


# --------------------------------------------------------------------------
# fault stacks: per-sample lowering == single-topology path
# --------------------------------------------------------------------------

def test_stacked_ring_matches_single_topology_path(ref):
    g = T.hypercube(5)
    degraded = [F.apply_faults(g, F.make_scenario(g, "link", 0.1, seed=i))
                for i in range(4)]
    tabs = _stack(g, degraded)
    out = SM.stacked_ring_allreduce(tabs, payload=float(1 << 22), chunk=12,
                                    device=CPU)
    assert out["rounds"] == 2 * (g.n - 1)
    want = ref.simulate.stacked_ring_allreduce(tabs, payload=float(1 << 22))
    np.testing.assert_allclose(out["time_seconds"], want["time_seconds"],
                               rtol=F32_RTOL)
    np.testing.assert_allclose(out["dropped_frac"], want["dropped_frac"],
                               rtol=F32_RTOL, atol=1e-12)
    for i in range(len(degraded)):
        single = SM.simulate_collective((tabs[i], g.n), "all_reduce", "ring",
                                        payloads=float(1 << 22), device=CPU)
        assert float(single.time_seconds[0]) == pytest.approx(
            float(out["time_seconds"][i]), rel=EXACT)


def test_stacked_ring_drops_disconnected_demand(ref):
    g = T.cycle(8)
    failed = np.nonzero((g.edges == 3).any(axis=1))[0].astype(np.int64)
    assert failed.size == 2
    sc = F.FaultScenario(kind="link", rate=0.25, seed=0, failed_links=failed,
                         failed_nodes=np.empty(0, dtype=np.int64))
    tabs = _stack(g, [F.apply_faults(g, sc)])
    out = SM.stacked_ring_allreduce(tabs, payload=float(1 << 20), device=CPU)
    assert out["dropped_frac"][0] > 0.0
    assert np.isfinite(out["time_seconds"]).all()
    want = ref.simulate.stacked_ring_allreduce(tabs, payload=float(1 << 20))
    np.testing.assert_allclose(out["dropped_frac"], want["dropped_frac"],
                               rtol=F32_RTOL)
    np.testing.assert_allclose(out["time_seconds"], want["time_seconds"],
                               rtol=F32_RTOL)


def test_fault_sweep_simulate_appends_measured_times():
    a = Analysis("hypercube(5)", device=CPU)
    sweep = a.fault_sweep(rates=[0.0, 0.1], samples=4, simulate=True,
                          sim_payload=float(1 << 22))
    r0, r1 = sweep.rows
    healthy = a.simulate("all_reduce", "ring", payload=float(1 << 22))
    assert r0["sim_allreduce_mean"] == pytest.approx(
        float(healthy.time_seconds[0]), rel=EXACT)
    assert r1["sim_allreduce_max"] >= r1["sim_allreduce_mean"] > 0
    assert "sim_dropped_frac_mean" in r1


# --------------------------------------------------------------------------
# API wiring: Analysis caching, survey columns, synthesized topologies
# --------------------------------------------------------------------------

def test_analysis_simulate_caches_per_configuration():
    a = Analysis("cycle(8)", device=CPU)
    s1 = a.simulate("all_reduce", payload=float(1 << 20))
    assert a.simulate("all_reduce", payload=float(1 << 20)) is s1
    assert a.simulate("all_reduce", "ring", payload=float(1 << 20)) is s1
    t1 = a.simulate("traffic", payload=float(1 << 20))
    assert a.simulate("traffic", pattern="uniform",
                      payload=float(1 << 20)) is t1
    assert a.simulate("all_reduce", payload=float(1 << 21)) is not s1
    assert a.network_model() is a.network_model()
    with pytest.raises(ValueError, match="unknown collective"):
        a.simulate("all_to_all")


def test_survey_simulate_rejects_traffic_collective():
    with pytest.raises(ValueError, match="pattern="):
        survey(["petersen"], simulate=dict(collective="traffic"),
               device=CPU)


def test_survey_simulate_appends_sim_columns(ref):
    res = survey(["petersen", "torus(4,2)"], simulate=True, device=CPU)
    want = ref.survey.survey(["petersen", "torus(4,2)"], simulate=True)
    assert all(c in res.columns for c in SIM_COLUMNS)
    for row, exp in zip(res, want):
        assert row["sim_geq_model"] is True
        assert row["sim_time_ms"] >= row["model_time_ms"]
        assert row["sim_thpt_uniform"] > 0
        for c in ("sim_collective", "sim_algorithm", "sim_rounds"):
            assert row[c] == exp[c]
        for c in ("sim_time_ms", "model_time_ms"):
            assert row[c] == pytest.approx(exp[c], rel=F32_RTOL, abs=1e-6)
        for c in ("sim_model_ratio", "sim_util_max", "sim_thpt_uniform"):
            assert row[c] == pytest.approx(exp[c], abs=1e-4)


def test_survey_simulate_config_dict():
    res = survey(["hypercube(4)"],
                 simulate=dict(algorithm="halving_doubling",
                               payload=float(1 << 20), pattern=None),
                 device=CPU)
    row = res.rows[0]
    assert row["sim_algorithm"] == "halving_doubling"
    assert row["sim_thpt_uniform"] is None


def test_survey_simulate_payload_sweep_reports_largest():
    pays = [float(1 << 26), float(1 << 20)]
    row = survey(["petersen"], simulate=dict(payload=pays),
                 device=CPU).rows[0]
    a = Analysis("petersen", device=CPU)
    big = a.network_model().validate(
        a.simulate("all_reduce", payload=float(1 << 26)))["rows"][0]
    assert row["sim_time_ms"] == pytest.approx(big["measured_s"] * 1e3)


def test_subsystem_composes_with_synthesis_and_faults():
    """simulate + fault_sweep(simulate=True) on a synthesized xpander
    registry instance (small search budget: still (256, 6))."""
    a = Analysis(build("xpander(256,6,0,40)", device=CPU), device=CPU)
    assert a.n == 256
    row = survey([a], simulate=dict(payload=float(1 << 22)),
                 device=CPU).rows[0]
    assert row["sim_geq_model"] is True
    sweep = a.fault_sweep(rates=[0.05], samples=2, simulate=True,
                          sim_payload=float(1 << 22))
    assert sweep.rows[0]["sim_allreduce_mean"] > 0
    assert sweep.rows[0]["sim_dropped_frac_mean"] >= 0.0


# --------------------------------------------------------------------------
# the collective cost model (core/collectives)
# --------------------------------------------------------------------------

def test_v5e_pod_model(ref):
    net = tpu_v5e_ici(16, 16)
    assert net.n == 256 and net.radix == 4
    assert net.bisection_links == 32
    assert net.diameter == 16
    want = ref.collectives.tpu_v5e_ici(16, 16)
    for f in net.__dataclass_fields__:
        assert getattr(net, f) == getattr(want, f), f


def test_model_constants_equal_reference(ref):
    assert (LINK_BW, PER_HOP_LATENCY) == (ref.collectives.LINK_BW,
                                          ref.collectives.PER_HOP_LATENCY)
    from repro_torch.core.collectives import COLLECTIVE_FACTORS
    assert COLLECTIVE_FACTORS == ref.collectives.COLLECTIVE_FACTORS


def test_allreduce_monotone_in_bytes():
    net = tpu_v5e_ici()
    assert net.all_reduce(1 << 30) > net.all_reduce(1 << 20) > 0


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "broadcast", "collective-permute"])
def test_collective_times_equal_reference(ref, kind):
    g = T.torus(16, 2)
    net = network_from_topology(g, vertex_transitive=True, device=CPU)
    want = ref.collectives.network_from_topology(ref_topology(ref, g),
                                                 vertex_transitive=True)
    for rate, model in ((0.0, "link"), (0.1, "link"), (0.2, "node")):
        for b in (1.0, float(1 << 24)):
            assert net.degrade(rate, model).collective_time(kind, b) == \
                pytest.approx(want.degrade(rate, model).collective_time(
                    kind, b), rel=EXACT)


def test_ramanujan_beats_torus_at_equal_radix_and_nodes():
    torus = network_from_topology(T.torus(16, 2), vertex_transitive=True,
                                  device=CPU)
    ram = network_from_topology(lps(13, 5), vertex_transitive=True,
                                device=CPU)
    assert ram.bisection_links / ram.n > 5 * torus.bisection_links / torus.n
    b = 1 << 20
    t_torus = torus.all_to_all(b) * torus.n
    t_ram = ram.all_to_all(b) * ram.n
    assert t_ram / ram.n < t_torus / torus.n


def test_allreduce_injection_floor():
    net = NetworkModel("ideal", n=256, radix=4, bisection_links=1e9,
                       diameter=1)
    b = 1 << 30
    expect = 2 * b * 255 / 256 / (4 * net.link_bw)
    assert abs(net.all_reduce(b) - expect) / expect < 0.01


def test_degrade_zero_is_exact_noop():
    net = tpu_v5e_ici(16, 16)
    assert net.degrade(0.0) is net


@pytest.mark.parametrize("model", ["link", "node"])
def test_degrade_collective_times_monotone_in_fault_rate(model):
    net = network_from_topology(T.torus(16, 2), vertex_transitive=True,
                                device=CPU)
    rates = [0.0, 0.02, 0.05, 0.1, 0.2, 0.4]
    b = 1 << 24
    for kind in ("all-reduce", "all-gather", "all-to-all"):
        times = [net.degrade(r, model=model).collective_time(kind, b)
                 for r in rates]
        assert all(t1 <= t2 + 1e-15 for t1, t2 in zip(times, times[1:])), \
            (kind, model, times)


def test_degrade_reflects_guaranteed_bisection_and_injection():
    net = tpu_v5e_ici(16, 16)
    d = net.degrade(0.25, model="link")
    assert d.bisection_links == pytest.approx(0.75 * net.bisection_links)
    assert d.effective_radix == pytest.approx(0.75 * net.radix)
    assert d.rho2 == pytest.approx(0.75 * net.rho2)
    assert d.n == net.n and d.diameter >= net.diameter
    dn = net.degrade(0.25, model="node")
    assert dn.bisection_links == pytest.approx(0.75 ** 2 * net.bisection_links)
    assert dn.n == round(0.75 * net.n)


def test_degrade_composes_and_validates():
    net = tpu_v5e_ici()
    twice = net.degrade(0.1).degrade(0.1)
    assert twice.fault_rate == pytest.approx(1 - 0.9 * 0.9)
    assert twice.effective_radix == pytest.approx(net.radix * 0.81)
    with pytest.raises(ValueError):
        net.degrade(1.5)
    with pytest.raises(ValueError):
        net.degrade(0.1, model="gremlins")


def test_placement_guarantee_vs_torus_empirical(ref):
    g = lps(13, 17)
    alpha = 0.9
    guar = ramanujan_placement_guarantee(g.n, g.radix, alpha)
    assert guar.guaranteed_bisection_edges > 0
    emp = empirical_subset_bw(g, alpha, trials=8, seed=0)
    assert emp >= guar.guaranteed_bisection_edges * 0.9
    assert emp == ref.placement.empirical_subset_bw(ref_topology(ref, g), alpha,
                                                    trials=8, seed=0)
    t = T.torus(33, 2)
    emp_t = empirical_subset_bw(t, alpha, trials=8, seed=0)
    assert emp / g.n > 2 * emp_t / t.n

