"""The design path of the port — networkx-free ``random_regular``, lifts,
reduction and synthesis (``xpander`` / ``rewired``) — against the JAX
reference on the CPU.

Randomness: numpy draws are shared, so ``random_regular``, lifts,
reduction, ``signed_slot_operands``, the budget-0 candidates and the
rewiring proposals are bit-identical.  The reference's annealing draws come
from ``jax.random``; :func:`jax_draws` recomputes them (the same
``jax.random.split`` sequence as the reference's loop) and hands them to the
port, whose refined signings must then equal the reference's.  Winners are
argmins over float32 Lanczos scores, which start from the reference's own
``jax.random`` vectors on both sides (``repro_torch.core.threefry``): where
two candidates score the same within float32 rounding (a near-tie) the
winners may differ, and the winner's lambda_max is held to 1e-4 instead.
Tests marked ``cuda`` run the search on the card and skip elsewhere.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.api import Analysis
from repro_torch.api import registry as PR
from repro_torch.core import bounds as PB
from repro_torch.core import lifts as PL
from repro_torch.core import reduction as PRED
from repro_torch.core import spectral as PS
from repro_torch.core import synthesis as SY
from repro_torch.core import topologies as PT
from repro_torch.kernels import spmv as KS
from test_torch_harness import load_chip_smoke, load_reference


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def jax_draws(ref):
    """A drop-in for ``synthesis._anneal_draws`` that returns the reference
    annealer's own jax.random draws for the same seed."""
    jax, jnp = ref.jax, ref.jnp

    def draws(seed, batch, n, m, steps, dev):
        key, k0 = jax.random.split(jax.random.PRNGKey(seed))
        v0s = jax.random.normal(k0, (batch, n), dtype=jnp.float32)
        flips, unis = [], []
        for _ in range(steps):
            key, k1, k2 = jax.random.split(key, 3)
            flips.append(np.asarray(jax.random.randint(k1, (batch,), 0, m)))
            unis.append(np.asarray(jax.random.uniform(k2, (batch,))))
        return (torch.tensor(np.asarray(v0s), device=dev),
                torch.tensor(np.stack(flips), dtype=torch.int64, device=dev),
                torch.tensor(np.stack(unis), device=dev))

    return draws


def _signed_lmax(topo, signings):
    """Exact (float64, dense) lambda_max of each signing's A_s."""
    return np.array([np.linalg.eigvalsh(PL._signed_adjacency(topo, s))[-1]
                     for s in signings])


# --------------------------------------------------------------------------
# random_regular without networkx
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [(64, 32, 0), (256, 6, 0), (64, 4, 1),
                                      (128, 6, 0), (200, 5, 0), (514, 6, 513),
                                      (8, 4, 0), (10, 0, 3)])
def test_random_regular_matches_networkx_edge_for_edge(ref, n, k, seed):
    import networkx as nx

    got = PT.random_regular(n, k, seed=seed)
    want = np.array(list(nx.random_regular_graph(k, n, seed=seed).edges()),
                    dtype=np.int64).reshape(-1, 2)
    np.testing.assert_array_equal(got.edges, want)
    np.testing.assert_array_equal(
        got.edges, ref.topologies.random_regular(n, k, seed=seed).edges)
    assert got.meta == dict(k=k, seed=seed)


def test_random_regular_rejects_impossible_parameters():
    with pytest.raises(ValueError, match="even"):
        PT.random_regular(5, 3)
    with pytest.raises(ValueError, match="0 <= k < n"):
        PT.random_regular(4, 4)


# --------------------------------------------------------------------------
# lifts and reduction (numpy copies: identical results)
# --------------------------------------------------------------------------

def test_lifts_match_reference(ref):
    g = PR.build("petersen")
    rg = ref.registry.build("petersen")
    s = np.random.default_rng(1).choice([-1.0, 1.0], size=g.m)
    np.testing.assert_array_equal(PL.two_lift(g, s).edges,
                                  ref.lifts.two_lift(rg, s).edges)
    assert PL.signed_spectral_radius(g, s) == \
        ref.lifts.signed_spectral_radius(rg, s)
    for obj in ("radius", "gap"):
        got = PL.best_random_signing(g, trials=6, seed=2, objective=obj,
                                     refine=True)
        want = ref.lifts.best_random_signing(rg, trials=6, seed=2,
                                             objective=obj, refine=True)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    np.testing.assert_array_equal(PL.k_lift(g, 3, seed=4).edges,
                                  ref.lifts.k_lift(rg, 3, seed=4).edges)
    got = PL.xpander_like(g, 3, trials=4, seed=5)
    want = ref.lifts.xpander_like(rg, 3, trials=4, seed=5)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.meta["lift_lams"] == want.meta["lift_lams"]
    assert PL.DENSE_LIFT_CUTOFF == ref.lifts.DENSE_LIFT_CUTOFF


def test_reduction_matches_reference(ref):
    b, rb = PR.build("butterfly(3,4)"), ref.registry.build("butterfly(3,4)")
    orbits = np.arange(b.n) // 3 ** 4
    H = PRED.quotient(b, orbits)
    np.testing.assert_array_equal(H, ref.reduction.quotient(rb, orbits))
    np.testing.assert_array_equal(PRED.orbit_quotient_spectrum(b, orbits),
                                  ref.reduction.orbit_quotient_spectrum(
                                      rb, orbits))
    spec_h = np.linalg.eigvals(H)
    assert PRED.spectrum_subset(spec_h, PS.adjacency_spectrum(b)) is True
    assert PRED.spectrum_subset(spec_h + 0.37, PS.adjacency_spectrum(b)) is \
        ref.reduction.spectrum_subset(spec_h + 0.37,
                                      ref.spectral.adjacency_spectrum(rb))
    with pytest.raises(ValueError, match="not an automorphism-orbit"):
        PRED.quotient(PR.build("path(5)"), [0, 1, 0, 1, 1])


# --------------------------------------------------------------------------
# synthesis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["petersen", "lps(13,5)",
                                  "random_regular(64,4,1)"])
def test_signed_slot_operands_identical(ref, spec):
    got = SY.signed_slot_operands(PR.build(spec))
    want = ref.synthesis.signed_slot_operands(ref.registry.build(spec))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec,objective", [("random_regular(8,4,0)", "gap"),
                                            ("random_regular(64,4,1)", "gap"),
                                            ("petersen", "radius")])
def test_anneal_signings_with_jax_draws_matches_reference(ref, spec,
                                                          objective):
    """Fed the reference's exact draws, the port's annealer makes every
    acceptance decision the reference makes: identical refined signings."""
    g = PR.build(spec)
    table, edge_slot = SY.signed_slot_operands(g)
    batch, steps, seed = 12, 40, 3
    init = np.random.default_rng(seed).choice(
        [-1.0, 1.0], size=(batch, g.m)).astype(np.float32)
    jnp = ref.jnp
    want, _ = ref.synthesis._anneal_signings(
        jnp.asarray(table), jnp.asarray(edge_slot), jnp.asarray(init),
        ref.jax.random.PRNGKey(seed), jnp.float32(g.radix),
        jnp.float32(0.05), steps=steps, est_iters=10, objective=objective)
    v0s, flips, unis = jax_draws(ref)(seed, batch, g.n, g.m, steps, "cpu")
    got, _ = SY._anneal_signings(
        torch.as_tensor(table), torch.as_tensor(edge_slot, dtype=torch.int64),
        torch.as_tensor(init), v0s, flips, unis, float(g.radix), 0.05,
        est_iters=10, objective=objective)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), init)      # the annealer moved


@pytest.mark.parametrize("spec,objective", [("random_regular(64,4,1)", "gap"),
                                            ("lps(13,5)", "gap"),
                                            ("random_regular(64,4,1)",
                                             "radius")])
def test_best_signing_batched_budget0_matches_reference(ref, spec, objective):
    """budget 0 (the scale row's setting): the candidates are the same numpy
    draws; the winner is the same candidate unless its exact score ties
    another's within 1e-5, and its lambda_max agrees to 1e-4 either way."""
    g = PR.build(spec)
    got = SY.best_signing_batched(g, batch=8, steps=0, seed=4,
                                  objective=objective, device="cpu")
    want = ref.synthesis.best_signing_batched(
        ref.registry.build(spec), batch=8, steps=0, seed=4,
        objective=objective)
    assert abs(got[1] - want[1]) <= 1e-4 and abs(got[2] - want[2]) <= 1e-4
    if not np.array_equal(got[0], want[0]):
        cands = np.random.default_rng(4).choice([-1.0, 1.0], size=(8, g.m))
        exact = _signed_lmax(g, cands)
        assert np.sort(exact)[1] - np.sort(exact)[0] <= 1e-5, exact


def _winner_probe(monkeypatch, spectral, store):
    """Record each signed solve's winner, candidates' slot signs and table."""
    orig = spectral.signed_extremes_batched

    def probe(table, slot_signs, *args, **kwargs):
        lmax, lmin = orig(table, slot_signs, *args, **kwargs)
        store.append((int(np.argmin(np.asarray(lmax))),
                      np.array(slot_signs), np.array(table)))
        return lmax, lmin

    monkeypatch.setattr(spectral, "signed_extremes_batched", probe)


def _dense_signed_lmax(table, signs):
    """Exact (float64, dense) lambda_max of the signed adjacency given as
    an (n, k) table and its (n, k) slot signs."""
    n, k = table.shape
    A = np.zeros((n, n))
    np.add.at(A, (np.repeat(np.arange(n), k), table.ravel()), signs.ravel())
    return float(np.linalg.eigvalsh(A)[-1])


@pytest.mark.parametrize("spec,draws", [("xpander(256,6,0,0)", "numpy"),
                                        ("rewired(40,4,0,80)", "numpy"),
                                        ("xpander(64,4,1,160)", "jax"),
                                        ("xpander(128,6,0,240)", "jax"),
                                        ("xpander(64,4,1,160)", "threefry"),
                                        ("xpander(128,6,0,240)", "threefry")])
def test_synthesized_family_matches_reference(ref, monkeypatch, spec, draws):
    """The whole design path: budget 0 and rewiring share every draw; the
    annealed towers get the reference's jax draws, handed over by
    :func:`jax_draws` ("jax") or made by the port itself ("threefry", no
    monkeypatch: :func:`synthesis._anneal_draws`).  Each lift level picks
    the reference's candidate unless two candidates tie exactly (equal
    lambda_max in dense float64), where float32 rounding decides.  Without
    such a tie the towers are equal edge for edge, and rho2 (the dense
    float64 oracle on both sides, n <= 4096) and gap_fraction agree to
    1e-9.  A tower that parts at a tie is held to the same candidates up to
    that level, the tie itself, and the Bilu–Linial identity."""
    if draws == "jax":
        monkeypatch.setattr(SY, "_anneal_draws", jax_draws(ref))
    got_levels, want_levels = [], []
    _winner_probe(monkeypatch, PS, got_levels)
    _winner_probe(monkeypatch, ref.spectral, want_levels)
    got = PR.build(spec, device="cpu")
    want = ref.registry.build(spec)
    gs, ws = got.meta["synthesis"], want.meta["synthesis"]
    assert gs.keys() == ws.keys()
    assert gs["evaluations"] == ws["evaluations"]
    assert abs(gs["ramanujan_rho2"] - ws["ramanujan_rho2"]) <= 1e-9
    assert len(got_levels) == len(want_levels)
    parted = next((i for i, (a, b) in enumerate(zip(got_levels, want_levels))
                   if a[0] != b[0]), None)
    if parted is None:
        np.testing.assert_array_equal(got.edges, want.edges)
        for key in ("rho2", "gap_fraction"):
            assert abs(gs[key] - ws[key]) <= 1e-9, key
        np.testing.assert_allclose(gs["trajectory"], ws["trajectory"],
                                   atol=1e-4)
        return
    (mine, signs, table), (theirs, signs_ref, table_ref) = \
        got_levels[parted], want_levels[parted]
    np.testing.assert_array_equal(table, table_ref)
    np.testing.assert_array_equal(signs, signs_ref)
    assert abs(_dense_signed_lmax(table, signs[mine])
               - _dense_signed_lmax(table, signs[theirs])) <= 1e-9
    k = got.meta["k"]
    lam2_seed = np.sort(PS.adjacency_spectrum(
        SY._lift_seed(got.n, k, got.meta["seed"])[0]))[-2]
    assert abs(gs["rho2"] - (k - max(lam2_seed, *got.meta["lift_lams"]))) \
        <= 1e-4
    # both are rounded to 6 decimals: half a unit each, the first scaled
    ram = PB.ramanujan_rho2(k)
    assert abs(gs["gap_fraction"] - gs["rho2"] / ram) <= 5e-7 * (1 + 1 / ram)


def test_xpander_default_instance_ties_at_level_0(ref, monkeypatch):
    """xpander(32,4,0,160), the family's default instance, with the
    reference's draws: its first level (n = 8, m = 16) has several
    candidates whose exact lambda_max is the same minimum, so the winner is
    decided by float32 rounding and the towers differ from level 1 on.
    Held instead: the level-0 winners' lambda_max (1e-4), the tie itself
    (dense float64), and the Bilu–Linial identity on the port's tower."""
    monkeypatch.setattr(SY, "_anneal_draws", jax_draws(ref))
    got = PR.build("xpander(32,4,0,160)", device="cpu")
    want = ref.registry.build("xpander(32,4,0,160)")
    assert abs(got.meta["lift_lams"][0] - want.meta["lift_lams"][0]) <= 1e-4
    # the level-0 candidates: 24 refined (identical on both sides) + 24 drawn
    base = PT.random_regular(8, 4, seed=0)
    table, edge_slot = SY.signed_slot_operands(base)
    init = np.random.default_rng(0).choice(
        [-1.0, 1.0], size=(SY.DEFAULT_BATCH, base.m)).astype(np.float32)
    v0s, flips, unis = jax_draws(ref)(0, SY.DEFAULT_BATCH, base.n, base.m, 80,
                                      "cpu")
    refined, _ = SY._anneal_signings(
        torch.as_tensor(table), torch.as_tensor(edge_slot, dtype=torch.int64),
        torch.as_tensor(init), v0s, flips, unis, 4.0, 0.05, est_iters=10,
        objective="gap")
    exact = np.sort(_signed_lmax(base, np.concatenate([refined.numpy(),
                                                       init])))
    assert exact[1] - exact[0] <= 1e-9              # a true tie at the min
    lam2_seed = np.sort(PS.adjacency_spectrum(base))[-2]
    syn = got.meta["synthesis"]
    assert abs(syn["rho2"] - (4 - max(lam2_seed, *got.meta["lift_lams"]))) \
        <= 1e-4
    assert abs(syn["gap_fraction"] - syn["rho2"] / PB.ramanujan_rho2(4)) \
        <= 1e-6


def test_scale_tower_reference_winners_match_chip_smoke(ref, monkeypatch):
    """chip_smoke.py holds the scale row, xpander(65536,32,0,0), to the
    reference's: each lift level's winner, score and exact lambda_max, the
    seed's lambda_2, the row's rho2, routing and traffic figures, and its
    Valiant, UGAL and KSP figures on the same sampled routing.  This
    recomputes all of them with the JAX reference on the CPU, the way the
    scale bench does (benchmarks/scale_bench.py)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    from repro_torch.specs import (SCALE_COLUMNS, SCALE_NODES, SCALE_SOURCES,
                                   SCALE_SPEC)

    smoke = load_chip_smoke()
    levels = []
    orig = ref.spectral.signed_extremes_batched

    def probe(table, slot_signs, *args, **kwargs):
        lmax, lmin = orig(table, slot_signs, *args, **kwargs)
        win = int(np.argmin(np.asarray(lmax)))
        levels.append((win, float(lmax[win]), np.array(table),
                       np.array(slot_signs[win])))
        return lmax, lmin

    monkeypatch.setattr(ref.spectral, "signed_extremes_batched", probe)
    frac = SCALE_SOURCES / SCALE_NODES
    analysis = ref.analysis.Analysis(SCALE_SPEC)
    row = ref.survey.survey(
        [analysis], SCALE_COLUMNS,
        routing=dict(pattern="uniform", sample_fraction=frac,
                     seed=0)).rows[0]
    assert [lv[0] for lv in levels] == smoke.SCALE_REF_WINNERS
    np.testing.assert_allclose([lv[1] for lv in levels],
                               smoke.SCALE_REF_SCORES, rtol=0, atol=1e-6)
    exact = []
    for _, _, table, signs in levels:
        n, k = table.shape
        A = sp.csr_matrix((signs.ravel().astype(np.float64),
                           (np.repeat(np.arange(n), k), table.ravel())),
                          shape=(n, n))
        exact.append(float(sla.eigsh(A, k=1, which="LA", tol=1e-10)[0][0]))
    np.testing.assert_allclose(exact, smoke.SCALE_REF_EXACT_LMAX, rtol=0,
                               atol=smoke.SCALE_EXACT_TOL)
    lam2 = np.sort(PS.adjacency_spectrum(PT.random_regular(64, 32, seed=0)))
    assert abs(lam2[-2] - smoke.SCALE_REF_SEED_LAM2) <= 1e-9
    want = smoke.SCALE_REF
    for key in ("diameter_bfs", "diameter_lb"):
        assert row[key] == want[key], key
    for key in ("rho2", "avg_hops", "path_diversity", "max_link_load",
                "saturation_throughput", "throughput_spectral"):
        assert row[key] == pytest.approx(want[key], abs=1e-9), key
    assert row["avg_hops_ci"] == pytest.approx(want["avg_hops_ci"], abs=1e-9)
    # the Bilu-Linial identity the smoke holds the card's row to
    assert abs(row["rho2"] - (32 - max(lam2[-2], *exact))) \
        <= smoke.SCALE_BILU_LINIAL_TOL
    # the row's other routing schemes (the smoke's scale_schemes phase)
    for scheme, want in smoke.SCALE_SCHEMES_REF.items():
        t = analysis.traffic("uniform", scheme=scheme, slack=1,
                             sample_fraction=frac, seed=0)
        for key in ("max_link_load", "saturation_throughput", "avg_hops"):
            assert getattr(t, key) == pytest.approx(want[key], rel=1e-12), \
                (scheme, key)


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (1, (24, 4096)),
                                        (91, (3, 1001)), (2**31 - 1, (64,))])
def test_start_vectors_are_the_reference_draws(ref, seed, shape):
    """Every Lanczos entry point starts from jax.random.normal(PRNGKey(seed))
    on both sides: the Threefry bits are identical, the normals agree to 4
    float32 ulps (XLA's log1p and fused multiply-adds round differently)."""
    from repro_torch.core import threefry

    jax, jnp = ref.jax, ref.jnp
    key = jax.random.PRNGKey(seed)
    want_bits = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(seed, shape),
                                  want_bits)
    want = np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))
    got = PS._start_vectors(shape, seed, torch.device("cpu"))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    gap = np.abs(got.numpy() - want)
    assert np.all(gap <= 4 * np.spacing(np.abs(want))), gap.max()


def test_signed_extremes_batched_matches_reference_scores(ref):
    """The lift search's score: 24 signings of a 32-regular graph on 2048
    nodes, 90 Lanczos steps (unconverged: the scores sit up to ~1e-4 below
    the exact lambda_max).  With the same start vectors both sides agree to
    float32 rounding (1e-5) and pick the same winner."""
    g = PT.random_regular(2048, 32, seed=3)
    table, edge_slot = SY.signed_slot_operands(g)
    cands = np.random.default_rng(5).choice([-1.0, 1.0], size=(24, g.m))
    slot_signs = cands[:, edge_slot].astype(np.float32)
    got = PS.signed_extremes_batched(table, slot_signs, iters=90, seed=8,
                                     device="cpu")
    want = ref.spectral.signed_extremes_batched(table, slot_signs, iters=90,
                                                seed=8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert int(np.argmin(got[0])) == int(np.argmin(want[0]))


def test_synthesize_api_matches_reference(ref):
    got = SY.synthesize(40, 4, method="rewire", budget=50, seed=2,
                        device="cpu")
    want = ref.synthesis.synthesize(40, 4, method="rewire", budget=50,
                                    seed=2)
    assert got.to_dict().keys() == want.to_dict().keys()
    assert got.report().splitlines()[0] == want.report().splitlines()[0]
    assert abs(got.rho2 - want.rho2) <= 1e-9
    assert got.trajectory == pytest.approx(want.trajectory, abs=1e-4)
    for bad, match in ((dict(n=40, k=2), "k >= 3"),
                       (dict(n=40, k=4, method="grow"), "unknown synthesis"),
                       (dict(n=31, k=4), "cannot reach")):
        with pytest.raises(ValueError, match=match):
            SY.synthesize(device="cpu", **bad)
        with pytest.raises(ValueError, match=match):
            ref.synthesis.synthesize(**bad)


def test_designed_families_build_on_the_requested_device():
    """Spec strings build through the registry and Analysis; without a card
    the default device raises instead of searching on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PR.build("xpander(32,4,0,0)")
    a = Analysis("rewired(40,4,0,50)", device="cpu")
    assert a.topo.meta["family"] == "rewired" and a.radix == 4
    assert a.rho2 == pytest.approx(a.topo.meta["synthesis"]["rho2"], abs=1e-6)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_xpander_search_on_card(cuda_device):
    """The annealed lift search on the card: signed K1 batches, and a tower
    whose rho2 obeys the Bilu–Linial identity."""
    KS.reset_launches()
    g = PR.build("xpander(512,6,0,160)", device=cuda_device)
    assert KS.launches() > 0
    assert g.n == 512 and g.radix == 6
    syn = g.meta["synthesis"]
    rho2 = float(PS.laplacian_spectrum(g)[1])
    assert abs(syn["rho2"] - rho2) <= 1e-6
    assert abs(rho2 - syn["trajectory"][-1]) <= 1e-3
    # a finite lift may beat the Ramanujan value k - 2 sqrt(k-1)
    assert abs(syn["gap_fraction"] - rho2 / PB.ramanujan_rho2(6)) <= 1e-6
    assert math.isfinite(syn["seconds"])
