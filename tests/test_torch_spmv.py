"""Kernel K1's plain version and dispatcher against the JAX reference.

On the CPU the port's ``spmv_ref`` is held against the reference's
``spmv_ref`` and its Pallas ``spmv_padded`` in interpret mode, on the same
numpy inputs: f32 (1e-5), f64 (1e-12), bf16 (0.15, the reference's own
tests/test_spmv.py levels), the signed form, both batched forms, ragged n
against the reference's ``block_rows``, the irregular ``data_vortex(4,3)``
and ``lps(13,5)``.  Tests marked ``cuda`` hold the CUDA kernel against
``spmv_ref`` on the card; they skip elsewhere (run them there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_spmv.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import registry as PR
from repro_torch.kernels import spmv as KS
from test_torch_harness import load_reference

RNG_SEED = 7


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _t(a, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _np(y):
    return y.detach().to("cpu", torch.float64).numpy()


# --------------------------------------------------------------------------
# parity with the reference (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,block", [(30, 4, 8), (64, 6, 64), (50, 3, 16),
                                       (128, 8, 33)])
def test_f32_matches_reference_ref_kernel_and_dense(ref, n, k, block):
    g = ref.topologies.random_regular(n, k, seed=0)
    tab, w = g.gather_operands()
    x = np.random.default_rng(RNG_SEED).standard_normal(n).astype(np.float32)
    jnp = ref.jnp
    want_ref = np.asarray(ref.spmv.spmv_ref(
        jnp.asarray(x), jnp.asarray(tab, jnp.int32), jnp.asarray(w, jnp.float32)))
    want_ker = np.asarray(ref.spmv.spmv_padded(
        jnp.asarray(x), jnp.asarray(tab, jnp.int32), jnp.asarray(w, jnp.float32),
        block_rows=block, interpret=True))
    got = KS.spmv_ref(_t(x), _t(tab, torch.int32), _t(w))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(_np(got), want_ref, atol=1e-5)
    np.testing.assert_allclose(_np(got), want_ker, atol=1e-5)
    np.testing.assert_allclose(_np(got), g.adjacency() @ x, atol=1e-4)


def test_f64_matches_reference(ref):
    g = PR.build("petersen_torus(5,4)")
    tab, w = g.gather_operands()
    x = np.random.default_rng(RNG_SEED).standard_normal(g.n)
    jax, jnp = ref.jax, ref.jnp
    with jax.enable_x64(True):
        want_ref = np.asarray(ref.spmv.spmv_ref(
            jnp.asarray(x, jnp.float64), jnp.asarray(tab, jnp.int32),
            jnp.asarray(w, jnp.float64)))
        want_ker = np.asarray(ref.spmv.spmv_padded(
            jnp.asarray(x, jnp.float64), jnp.asarray(tab, jnp.int32),
            jnp.asarray(w, jnp.float64), block_rows=64, interpret=True))
    assert want_ker.dtype == np.float64
    got = KS.spmv_ref(_t(x, torch.float64), _t(tab, torch.int32),
                      _t(w, torch.float64))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want_ref, atol=1e-12)
    np.testing.assert_allclose(_np(got), want_ker, atol=1e-12)


def test_bf16_matches_reference(ref):
    g = ref.topologies.random_regular(32, 4, seed=1)
    tab, _ = g.gather_operands()
    x = np.random.default_rng(RNG_SEED).standard_normal(32)
    jnp = ref.jnp
    xb = jnp.asarray(x, jnp.bfloat16)
    want_f32 = np.asarray(ref.spmv.spmv_ref(xb.astype(jnp.float32),
                                            jnp.asarray(tab, jnp.int32)))
    want_ker = np.asarray(ref.spmv.spmv_padded(
        xb, jnp.asarray(tab, jnp.int32), block_rows=16, interpret=True),
        dtype=np.float32)
    x_port = _t(np.asarray(xb, dtype=np.float32), torch.bfloat16)
    got = KS.spmv_ref(x_port, _t(tab, torch.int32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want_f32, atol=0.15)
    np.testing.assert_allclose(_np(got), want_ker, atol=0.15)


def test_signed_matches_reference(ref):
    g = ref.topologies.random_regular(24, 4, seed=5)
    table, edge_slot = ref.synthesis.signed_slot_operands(g)
    rng = np.random.default_rng(RNG_SEED)
    sg = rng.choice([-1.0, 1.0], size=g.m)[edge_slot].astype(np.float32)
    x = rng.standard_normal(g.n).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.spmv.spmv_padded(
        jnp.asarray(x), jnp.asarray(table, jnp.int32), None, jnp.asarray(sg),
        block_rows=8, interpret=True))
    got = KS.spmv_ref(_t(x), _t(table, torch.int32), signs=_t(sg))
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


def test_batched_shared_table_matches_reference(ref):
    """(B, n) vectors over one (n, k) table — the reference's vmap over x."""
    g = PR.build("lps(13,5)")
    tab, w = g.gather_operands()
    xs = np.random.default_rng(RNG_SEED).standard_normal((3, g.n)).astype(
        np.float32)
    jax, jnp = ref.jax, ref.jnp
    want = np.asarray(jax.vmap(lambda x: ref.spmv.spmv_padded(
        x, jnp.asarray(tab, jnp.int32), jnp.asarray(w, jnp.float32),
        interpret=True))(jnp.asarray(xs)))
    got = KS.spmv_ref(_t(xs), _t(tab, torch.int32), _t(w))
    assert got.shape == (3, g.n)
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


def test_batched_table_stack_matches_reference(ref):
    """(B, n) vectors over a (B, n, k) table stack with (B, n) weights and
    (B, n, k) signs — the reference's vmap over operands."""
    g = PR.build("torus(6,2)")
    tab, w = g.gather_operands()
    rng = np.random.default_rng(RNG_SEED)
    B = 4
    tabs = np.stack([tab[rng.permutation(g.n)] for _ in range(B)])
    ws = rng.standard_normal((B, g.n)).astype(np.float32)
    sgs = rng.choice([-1.0, 1.0], size=tabs.shape).astype(np.float32)
    xs = rng.standard_normal((B, g.n)).astype(np.float32)
    jax, jnp = ref.jax, ref.jnp
    want = np.asarray(jax.vmap(lambda x, t, l, s: ref.spmv.spmv_padded(
        x, t, l, s, block_rows=16, interpret=True))(
        jnp.asarray(xs), jnp.asarray(tabs, jnp.int32), jnp.asarray(ws),
        jnp.asarray(sgs)))
    got = KS.spmv_ref(_t(xs), _t(tabs, torch.int32), _t(ws), _t(sgs))
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


@pytest.mark.parametrize("block", [7, 16, 40])
def test_ragged_n_matches_reference_block_rows(ref, block):
    g = ref.topologies.random_regular(40, 4, seed=3)
    tab, w = g.gather_operands()
    x = np.random.default_rng(RNG_SEED).standard_normal(40).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.spmv.spmv_padded(
        jnp.asarray(x), jnp.asarray(tab, jnp.int32), jnp.asarray(w, jnp.float32),
        block_rows=block, interpret=True))
    got = KS.spmv_ref(_t(x), _t(tab, torch.int32), _t(w))
    assert got.shape == (40,)
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


@pytest.mark.parametrize("spec", ["data_vortex(4,3)", "lps(13,5)"])
def test_named_graphs_match_reference_and_dense(ref, spec):
    """data_vortex(4,3): irregular, self-padded rows whose -1 compensation
    cancels the regularizing loop; lps(13,5): the LPS main-path family."""
    g = PR.build(spec)
    tab, w = g.gather_operands()
    x = np.random.default_rng(RNG_SEED).standard_normal(g.n).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.spmv.spmv_padded(
        jnp.asarray(x), jnp.asarray(tab, jnp.int32), jnp.asarray(w, jnp.float32),
        block_rows=16, interpret=True))
    got = _np(KS.spmv_ref(_t(x), _t(tab, torch.int32), _t(w)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, g.adjacency() @ x, atol=1e-4)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def test_backend_resolution_order(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_SPMV_BACKEND", raising=False)
    assert KS.resolve_backend(device="cpu") == "ref"
    assert KS.resolve_backend(device="cuda") == "cuda"
    monkeypatch.setenv("REPRO_TORCH_SPMV_BACKEND", "cuda")
    assert KS.resolve_backend(device="cpu") == "cuda"
    with KS.use_backend("ref"):
        assert KS.resolve_backend(device="cuda") == "ref"
        assert KS.resolve_backend("cuda", device="cpu") == "cuda"
    assert KS.resolve_backend(device="cpu") == "cuda"


def test_backend_validation():
    with pytest.raises(ValueError):
        KS.resolve_backend("pallas")
    with pytest.raises(ValueError):
        with KS.use_backend("nope"):
            pass


def test_dispatch_counters_and_matvec(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_SPMV_BACKEND", raising=False)
    g = PR.build("hypercube(5)")
    tab, w = g.gather_operands()
    x = _t(np.random.default_rng(RNG_SEED).standard_normal((2, g.n)))
    before = obs.counters()
    mv = KS.spmv_matvec(tab, w, device="cpu")
    y = mv(x)
    delta = obs.counter_delta(before, "spmv/")
    assert delta == {"spmv/matvec/ref": 1, "spmv/dispatch/ref": 1}
    np.testing.assert_allclose(_np(y), (g.adjacency() @ _np(x).T).T,
                               atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel: the wrapper raises, and the
    dispatcher asked for "cuda" on a CPU tensor raises too (no fallback)."""
    x = torch.zeros(4)
    tab = torch.zeros((4, 2), dtype=torch.int32)
    launches = KS.launches()
    with pytest.raises(ValueError, match="CUDA"):
        KS.spmv_cuda(x, tab)
    with pytest.raises(ValueError, match="CUDA"):
        KS.spmv(x, tab, backend="cuda")
    assert KS.launches() == launches


def test_matvec_rejects_out_of_range_tables():
    with pytest.raises(ValueError, match=r"\[0, n\)"):
        KS.spmv_matvec(np.array([[0, 5], [1, 0]]), device="cpu")
    with pytest.raises(ValueError, match=r"\[0, n\)"):
        KS.spmv_matvec(np.array([[0, -1], [1, 0]]), device="cpu")


# --------------------------------------------------------------------------
# on the card: kernel K1 against its plain version
# --------------------------------------------------------------------------

def _card_cases(dev):
    rng = np.random.default_rng(RNG_SEED)
    out = []
    for spec in ("lps(13,5)", "data_vortex(4,3)", "hypercube(10)"):
        g = PR.build(spec)
        tab, w = g.gather_operands()
        n, k = tab.shape
        x = rng.standard_normal(n)
        out += [
            (f"{spec} f32", _t(x, device=dev), _t(tab, torch.int32, dev),
             _t(w, device=dev), None, 1e-5),
            (f"{spec} f64", _t(x, torch.float64, dev),
             _t(tab, torch.int32, dev), _t(w, torch.float64, dev), None,
             1e-12),
            (f"{spec} bf16", _t(x, torch.bfloat16, dev),
             _t(tab, torch.int32, dev), _t(w, device=dev), None, 0.15),
            (f"{spec} signed", _t(x, device=dev), _t(tab, torch.int32, dev),
             None, _t(rng.choice([-1.0, 1.0], size=(n, k)), device=dev),
             1e-5),
            (f"{spec} batched shared", _t(rng.standard_normal((3, n)),
                                          device=dev),
             _t(tab, torch.int32, dev), _t(w, device=dev), None, 1e-5),
            (f"{spec} batched stack", _t(rng.standard_normal((3, n)),
                                         device=dev),
             _t(np.stack([tab[rng.permutation(n)] for _ in range(3)]),
                torch.int32, dev),
             _t(rng.standard_normal((3, n)), device=dev),
             _t(rng.choice([-1.0, 1.0], size=(3, n, k)), device=dev), 1e-5),
        ]
    n = 1000 * 256 + 77                                  # ragged
    out.append(("ragged", _t(rng.standard_normal(n), device=dev),
                _t(rng.integers(0, n, size=(n, 5)), torch.int32, dev),
                _t(rng.standard_normal(n), device=dev), None, 1e-5))
    return out


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    for name, x, tab, loops, signs, tol in _card_cases(cuda_device):
        before = KS.launches()
        got = KS.spmv_cuda(x, tab, loops, signs)
        want = KS.spmv_ref(x, tab, loops, signs)
        torch.cuda.synchronize()
        assert KS.launches() == before + 1
        assert got.dtype == x.dtype and got.shape == x.shape, name
        err = float((got.double() - want.double()).abs().max())
        assert err <= tol, (name, err)


@pytest.mark.cuda
def test_cuda_kernel_validates_its_operands(cuda_device):
    x = torch.zeros(8, device=cuda_device)
    tab = torch.zeros((8, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        KS.spmv_cuda(x.half(), tab)
    with pytest.raises(ValueError, match="int32"):
        KS.spmv_cuda(x, tab.long())
    with pytest.raises(ValueError, match="shape"):
        KS.spmv_cuda(x, tab[:4])
    with pytest.raises(ValueError, match="contiguous"):
        KS.spmv_cuda(torch.zeros((8, 2), device=cuda_device).T, tab)
    with pytest.raises(ValueError, match="cpu"):
        KS.spmv_cuda(x, tab.cpu())


@pytest.mark.cuda
def test_cuda_main_path_goes_through_the_kernel(cuda_device):
    from repro_torch.api import Analysis

    before_launches = KS.launches()
    before = obs.counters()
    a = Analysis("lps(13,5)", dense_threshold=0, lanczos_iters=120)
    assert abs(a.rho2 - 1.7502792) <= 1e-3
    assert KS.launches() - before_launches >= 120
    assert obs.counter_delta(before, "spmv/dispatch/") == {
        "spmv/dispatch/cuda": KS.launches() - before_launches}
