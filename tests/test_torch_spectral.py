"""Lanczos solvers of the PyTorch port against the JAX reference.

The private solvers take start vectors, so both sides get the same numpy
draws and their extreme Ritz values must agree to 1e-5 relative
(|a - b| <= 1e-5 max(1, |b|)): both run the same f32 recurrence, and f32
roundoff in a different summation order is the only difference.  The public
entry points draw the reference's own ``jax.random`` start vectors
(``repro_torch.core.threefry``, held to jax's draws in
tests/test_torch_synthesis.py); they are held to the reference's 1e-3 bar
against the dense oracle and the reference (tests/test_api_analysis.py).
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import registry as PR
from repro_torch.core import spectral as PS
from repro_torch.interop import to_device
from repro_torch.kernels import spmv as KS
from test_torch_harness import load_reference

CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= rel * np.maximum(1.0, np.abs(b))), (a, b)


def _ritz_extremes(alphas, betas):
    ev = PS._tridiag_eigvals(np.asarray(alphas, np.float64),
                             np.asarray(betas, np.float64))
    return ev[0], ev[-1]


def _deflation(vectors):
    D = np.stack([d / np.linalg.norm(d) for d in vectors])
    Q, _ = np.linalg.qr(D.T)
    return Q.T.astype(np.float32)


@pytest.mark.parametrize("spec", ["lps(13,5)", "torus(10,2)",
                                  "data_vortex(5,4)"])
def test_lanczos_tridiag_matches_reference_on_shared_v0(ref, spec):
    g = PR.build(spec)
    tab, w = g.gather_operands()
    v0 = np.random.default_rng(11).standard_normal(g.n).astype(np.float32)
    D = _deflation(PS.trivial_deflation(g))
    m = 60
    jnp = ref.jnp
    a_r, b_r = ref.spectral.lanczos_tridiag(
        ref.spmv.spmv_matvec(tab, w, backend="ref"), jnp.asarray(v0), m,
        jnp.asarray(D))
    a_p, b_p = PS.lanczos_tridiag(KS.spmv_matvec(tab, w, device=CPU),
                                  to_device(v0, CPU), m, to_device(D, CPU))
    assert a_p.shape == (m,) and b_p.shape == (m - 1,)
    _close(_ritz_extremes(a_p, b_p), _ritz_extremes(a_r, b_r))


def test_lanczos_tridiag_batched_matches_reference(ref):
    g = PR.build("lps(13,17)")
    tab, w = g.gather_operands()
    rng = np.random.default_rng(12)
    tabs = np.stack([tab, tab, tab])
    ws = np.stack([w, w, w]).astype(np.float32)
    v0s = rng.standard_normal((3, g.n)).astype(np.float32)
    m = 50
    jnp = ref.jnp
    a_r, b_r = ref.spectral._lanczos_tridiag_batched(
        jnp.asarray(tabs, jnp.int32), jnp.asarray(ws), jnp.asarray(v0s), m,
        backend="ref")
    a_p, b_p = PS._lanczos_tridiag_batched(
        to_device(tabs, CPU, torch.int32), to_device(ws, CPU),
        to_device(v0s, CPU), m)
    assert a_p.shape == (3, m) and b_p.shape == (3, m)
    for i in range(3):
        _close(_ritz_extremes(a_p[i], b_p[i][:-1]),
               _ritz_extremes(np.asarray(a_r[i]), np.asarray(b_r[i])[:-1]))


def test_lap_lanczos_batched_matches_reference_on_faulted_graphs(ref):
    """Irregular Laplacian operands stacked by the reference's own fault
    injection (random link faults on petersen_torus(5,4))."""
    F = ref.faults
    base = ref.registry.build("petersen_torus(5,4)")
    degraded = [F.apply_faults(base, F.random_link_faults(base, 0.15, seed=s))
                for s in range(3)]
    tabs, ws, degs = F.stacked_operands(degraded)
    v0s = np.random.default_rng(13).standard_normal(
        (3, base.n)).astype(np.float32)
    m = 80
    jnp = ref.jnp
    a_r, b_r = ref.spectral._lap_lanczos_batched(
        jnp.asarray(tabs, jnp.int32), jnp.asarray(ws, jnp.float32),
        jnp.asarray(degs, jnp.float32), jnp.asarray(v0s), m, backend="ref")
    a_p, b_p = PS._lap_lanczos_batched(
        to_device(tabs, CPU, torch.int32), to_device(ws, CPU),
        to_device(degs, CPU), to_device(v0s, CPU), m)
    lmin_r, lmax_r = ref.spectral._batched_ritz_extremes(a_r, b_r)
    lmin_p, lmax_p = PS._batched_ritz_extremes(a_p.numpy(), b_p.numpy())
    _close(lmin_p, lmin_r)
    _close(lmax_p, lmax_r)
    dense = [np.linalg.eigvalsh(d.laplacian())[1] for d in degraded]
    np.testing.assert_allclose(np.maximum(lmin_p, 0.0), dense, atol=1e-3)


def test_signed_lanczos_batched_matches_reference(ref):
    """Per-slot signs from the reference's signed_slot_operands."""
    g = ref.registry.build("lps(13,5)")
    table, edge_slot = ref.synthesis.signed_slot_operands(g)
    rng = np.random.default_rng(14)
    signings = rng.choice([-1.0, 1.0], size=(3, g.m))
    sg = signings[:, edge_slot].astype(np.float32)
    v0s = rng.standard_normal((3, g.n)).astype(np.float32)
    m = 60
    jnp = ref.jnp
    a_r, b_r = ref.spectral._signed_lanczos_batched(
        jnp.asarray(table, jnp.int32), jnp.asarray(sg), jnp.asarray(v0s), m,
        backend="ref")
    a_p, b_p = PS._signed_lanczos_batched(
        to_device(table, CPU, torch.int32), to_device(sg, CPU),
        to_device(v0s, CPU), m)
    lmin_r, lmax_r = ref.spectral._batched_ritz_extremes(a_r, b_r)
    lmin_p, lmax_p = PS._batched_ritz_extremes(a_p.numpy(), b_p.numpy())
    _close(lmin_p, lmin_r)
    _close(lmax_p, lmax_r)


@pytest.mark.parametrize("spec", ["lps(13,5)", "torus(12,2)",
                                  "data_vortex(5,4)", "slimfly(13)",
                                  "lps(13,17)"])
def test_rho2_lanczos_within_1e3_of_dense_and_reference(ref, spec):
    g = PR.build(spec)
    got = PS.rho2_lanczos(g, iters=150, seed=0, device=CPU)
    dense = float(PS.laplacian_spectrum(g)[1])
    want = ref.spectral.rho2_lanczos(ref.registry.build(spec), iters=150,
                                     seed=0)
    assert got == pytest.approx(dense, abs=1e-3)
    assert got == pytest.approx(want, abs=1e-3)


def test_public_batched_solvers_against_dense(ref):
    """rho2_laplacian_batched / signed_extremes_batched / rho2_lanczos_batched
    on the port's own start vectors, with tiling forced (batch_chunk=2)."""
    F = ref.faults
    base = ref.registry.build("torus(6,3)")
    degraded = [F.apply_faults(base, F.random_link_faults(base, 0.1, seed=s))
                for s in range(3)]
    tabs, ws, degs = F.stacked_operands(degraded)
    got = PS.rho2_laplacian_batched(tabs, ws, degs, iters=120, seed=1,
                                    batch_chunk=2, device=CPU)
    dense = [max(np.linalg.eigvalsh(d.laplacian())[1], 0.0) for d in degraded]
    np.testing.assert_allclose(got, dense, atol=1e-3)

    g = ref.registry.build("random_regular(64,4,1)")
    table, edge_slot = ref.synthesis.signed_slot_operands(g)
    signings = np.random.default_rng(15).choice([-1.0, 1.0], size=(3, g.m))
    lmax, lmin = PS.signed_extremes_batched(
        table, signings[:, edge_slot], iters=64, seed=2, batch_chunk=2,
        device=CPU)
    for i, s in enumerate(signings):
        A = np.zeros((g.n, g.n))
        np.add.at(A, (g.edges[:, 0], g.edges[:, 1]), s)
        np.add.at(A, (g.edges[:, 1], g.edges[:, 0]), s)
        ev = np.linalg.eigvalsh(A)
        assert lmax[i] == pytest.approx(ev[-1], abs=1e-3)
        assert lmin[i] == pytest.approx(ev[0], abs=1e-3)

    topos = [PR.build("random_regular(128,6,0)"),
             PR.build("random_regular(128,6,1)")]
    vals = PS.rho2_lanczos_batched(topos, iters=100, seed=0, device=CPU)
    for t, v in zip(topos, vals):
        assert v == pytest.approx(PS.laplacian_spectrum(t)[1], abs=1e-3)
    with pytest.raises(ValueError, match="bipartite"):
        PS.rho2_lanczos_batched([PR.build("lps(13,5)")] * 2, device=CPU)


@pytest.mark.parametrize("spec,unit_start,truncations", [
    ("hypercube(6)", False, 0), ("cycle(8)", True, 1)])
def test_breakdown_truncation_matches_reference(ref, spec, unit_start,
                                                truncations):
    """Q_6 has 7 distinct Laplacian eigenvalues, so its Krylov space closes
    after 6 steps; in f32 the residual there stays ~1e-6, above the 1e-7
    breakdown test, in both frameworks, and rho2 must still come out as 2.
    From the unit vector e_0, cycle(8)'s Krylov space closes exactly (beta is
    0): both frameworks must cut the zero-beta tail (one truncation) before
    reading the smallest Ritz value, rho2 = 2 - 2 cos(pi / 4)."""
    g = PR.build(spec)
    tab, w = g.gather_operands()
    tabs = np.stack([tab, tab])
    ws = np.stack([w, w]).astype(np.float32)
    degs = np.full((2, g.n), float(g.radix), np.float32)
    v0s = np.random.default_rng(17).standard_normal((2, g.n)).astype(
        np.float32)
    if unit_start:
        v0s[:] = 0.0
        v0s[:, 0] = 1.0
    m = 40
    jnp = ref.jnp
    a_r, b_r = ref.spectral._lap_lanczos_batched(
        jnp.asarray(tabs, jnp.int32), jnp.asarray(ws), jnp.asarray(degs),
        jnp.asarray(v0s), m, backend="ref")
    a_p, b_p = PS._lap_lanczos_batched(
        to_device(tabs, CPU, torch.int32), to_device(ws, CPU),
        to_device(degs, CPU), to_device(v0s, CPU), m)
    before_r = ref.obs.counters("lanczos/")
    lmin_r, _ = ref.spectral._batched_ritz_extremes(a_r, b_r)
    before = obs.counters("lanczos/")
    lmin_p, _ = PS._batched_ritz_extremes(a_p.numpy(), b_p.numpy())
    got = obs.counter_delta(before, "lanczos/").get(
        "lanczos/breakdown_truncations", 0)
    want = ref.obs.counter_delta(before_r, "lanczos/").get(
        "lanczos/breakdown_truncations", 0)
    assert got == want == 2 * truncations
    _close(lmin_p, lmin_r)
    np.testing.assert_allclose(lmin_p, PS.laplacian_spectrum(g)[1],
                               atol=1e-3)
    public = PS.rho2_laplacian_batched(tabs, ws, degs, iters=m, seed=0,
                                       device=CPU)
    np.testing.assert_allclose(public, PS.laplacian_spectrum(g)[1],
                               atol=1e-3)


def test_breakdown_helpers_match_reference(ref):
    rng = np.random.default_rng(16)
    alphas = rng.standard_normal((3, 10))
    betas = np.abs(rng.standard_normal((3, 10)))
    betas[1, 4:] = 0.0
    for i in range(3):
        for x, y in zip(PS._truncate_at_breakdown(alphas[i], betas[i]),
                        ref.spectral._truncate_at_breakdown(alphas[i],
                                                            betas[i])):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(PS._batched_ritz_extremes(alphas, betas),
                    ref.spectral._batched_ritz_extremes(alphas, betas)):
        np.testing.assert_allclose(x, y, atol=1e-12)
    for args in [(5, 113460, 6, 200, None), (48, 2184, 6, 160, None),
                 (10, 100, 4, 20, 3), (24, 65536, 32, 90, None)]:
        assert PS._batch_tile(*args) == ref.spectral._batch_tile(*args)
    for lo, hi, tile in [(0, 3, 3), (4, 5, 3), (6, 8, 4)]:
        for x, y in zip(PS._tile_indices(lo, hi, tile),
                        ref.spectral._tile_indices(lo, hi, tile)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("spec", ["butterfly(3,3)", "torus(6,2)", "ccc(4)",
                                  "random_regular(64,4,1)"])
def test_dense_oracles_match_reference(ref, spec):
    g, h = PR.build(spec), ref.registry.build(spec)
    np.testing.assert_allclose(PS.canonical_fiedler(g),
                               ref.spectral.canonical_fiedler(h), atol=1e-10)
    np.testing.assert_allclose(PS.adjacency_spectrum(g),
                               ref.spectral.adjacency_spectrum(h), atol=1e-10)
    assert PS.lambda_nontrivial(g) == pytest.approx(
        ref.spectral.lambda_nontrivial(h), abs=1e-10)


def test_fiedler_lanczos_spans_the_dense_fiedler_space():
    g = PR.build("random_regular(200,5,0)")
    ritz = PS.fiedler_lanczos(g, iters=150, seed=0, device=CPU)
    w, v = np.linalg.eigh(g.laplacian())
    space = v[:, np.abs(w - w[1]) < 1e-6]
    assert np.linalg.norm(space.T @ ritz) == pytest.approx(1.0, abs=1e-3)
    lam, _ = PS.lanczos_top_ritz(
        PS.table_matvec(*g.gather_operands(), device=CPU), g.n, m=150,
        deflate_vectors=[np.ones(g.n)], device=CPU)
    assert lam == pytest.approx(g.radix - w[1], abs=1e-3)
