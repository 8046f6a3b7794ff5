"""Kernel K1's plain version and dispatcher against the JAX reference.

On the CPU the port's ``spmv_ref`` is held against the reference's
``spmv_ref`` and its Pallas ``spmv_padded`` in interpret mode, on the same
numpy inputs: f32 (1e-5), f64 (1e-12), bf16 (0.15, the reference's own
tests/test_spmv.py levels), the signed form, both batched forms, ragged n
against the reference's ``block_rows``, the irregular ``data_vortex(4,3)``
and ``lps(13,5)``.  Tests marked ``cuda`` hold the CUDA kernel against
``spmv_ref`` on the card, over every form its design splits on (batch path
and row path, B, k, loops and signs shared or per batch, dtypes, ragged n,
the scale row's shapes), and check its bits: f32 equals K2, signed f32 the
sequential sum, f64 integers exact.  They skip elsewhere (run them there
with ``PYTHONPATH=src python -m pytest -q -p no:cacheprovider -m cuda
tests/test_torch_spmv.py``).  The CPU tests at the end hold
``chip_smoke.py``'s L2-sector bound to hand-computed figures.
"""
import fractions
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import registry as PR
from repro_torch.kernels import spmv as KS
from test_torch_harness import load_reference

RNG_SEED = 7
ROOT = pathlib.Path(__file__).resolve().parents[1]
#: kernel-vs-plain tolerances (the reference's tests/test_spmv.py levels)
CARD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 0.15}


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


def _split_cases(dev):
    """The forms K1's design splits on: (name, x, table, loops, signs)."""
    rng = np.random.default_rng(RNG_SEED + 1)
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    out = []

    def t(a, dtype=f32):
        return _t(a, dtype, dev)

    def table(n, k):
        return t(rng.integers(0, n, size=(n, k)), torch.int32)

    # B over one table (the row path at B = 1, the batch path from B = 2),
    # f32 with shared loops, n ragged against every block size
    n = 4099
    tab = table(n, 6)
    loops = t(rng.integers(0, 3, size=n))
    for B in (1, 2, 3, 5, 24, 33, 64, 65):
        out.append((f"B={B} shared table f32 loops", t(rng.standard_normal(
            (B, n))), tab, loops, None))
    # every compiled radix and runtime ones, each form: (n,), (5, n) shared
    # with per-b signs and loops, (3, n, k) stack with per-b signs and loops
    n = 2053
    for k in (1, 3, 6, 7, 16, 32, 33):
        tab = table(n, k)
        out.append((f"k={k} (n,) loops", t(rng.standard_normal(n)), tab,
                    t(rng.standard_normal(n)), None))
        out.append((f"k={k} (n,) signed", t(rng.standard_normal(n)), tab,
                    None, t(rng.choice([-1.0, 1.0], size=(n, k)))))
        out.append((f"k={k} (5,n) shared, (5,n) loops, (5,n,k) signs",
                    t(rng.standard_normal((5, n))), tab,
                    t(rng.standard_normal((5, n))),
                    t(rng.choice([-1.0, 1.0], size=(5, n, k)))))
        out.append((f"k={k} (5,n) shared, (n,) loops, (n,k) signs",
                    t(rng.standard_normal((5, n))), tab,
                    t(rng.standard_normal(n)),
                    t(rng.choice([-1.0, 1.0], size=(n, k)))))
        out.append((f"k={k} (3,n,k) stack, (3,n) loops, (3,n,k) signs",
                    t(rng.standard_normal((3, n))),
                    t(rng.integers(0, n, size=(3, n, k)), torch.int32),
                    t(rng.standard_normal((3, n))),
                    t(rng.choice([-1.0, 1.0], size=(3, n, k)))))
        out.append((f"k={k} (3,n,k) stack, (n,) loops, (n,k) signs",
                    t(rng.standard_normal((3, n))),
                    t(rng.integers(0, n, size=(3, n, k)), torch.int32),
                    t(rng.standard_normal(n)),
                    t(rng.choice([-1.0, 1.0], size=(n, k)))))
    # a radix whose staged tile does not fit: read from device memory.  Its
    # 200-term sums run in another order than the plain version's, which
    # reads ~2e-5 apart on normal data; small integers keep both exact (the
    # sequential-sum test holds its signed form on normal data bit for bit)
    tab = table(n, 200)
    out.append(("k=200 (n,) signed loops, integer x",
                t(rng.integers(-8, 9, size=n)), tab,
                t(rng.integers(-3, 4, size=n)),
                t(rng.choice([-1.0, 1.0], size=(n, 200)))))
    # dtypes: f64 (B, n) and (n,), bf16 (B, n) and (n,), ragged n
    n = 3001
    tab = table(n, 7)
    for B in (1, 4, 24):
        shape = (B, n) if B > 1 else (n,)
        out.append((f"f64 {shape} loops", t(rng.standard_normal(shape), f64),
                    tab, t(rng.standard_normal(n), f64), None))
        out.append((f"bf16 {shape} loops", t(rng.standard_normal(shape),
                                             bf16),
                    tab, t(rng.standard_normal(n)), None))
    # the scale row's shapes: the lift search's signed batches and the
    # sigma DP's / ECMP's f64 batches, over random k = 32 tables
    for B, n in ((24, 16384), (12, 32768)):
        out.append((f"scale signed ({B}, {n})", t(rng.standard_normal(
            (B, n))), table(n, 32), None,
            t(rng.choice([-1.0, 1.0], size=(B, n, 32)))))
    tab = table(65536, 32)
    for B in (64, 16):
        out.append((f"scale f64 ({B}, 65536)", t(rng.standard_normal(
            (B, 65536)), f64), tab, None, None))
    return out


def _k1_equals_plain(name, x, tab, loops, signs):
    before = KS.launches()
    got = KS.spmv_cuda(x, tab, loops, signs)
    want = KS.spmv_ref(x, tab, loops, signs)
    torch.cuda.synchronize()
    assert KS.launches() == before + 1, name
    assert got.dtype == x.dtype and got.shape == x.shape, name
    err = float((got.double() - want.double()).abs().max())
    assert err <= CARD_TOL[x.dtype], (name, err)
    return got


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    for name, x, tab, loops, signs, tol in _card_cases(cuda_device):
        assert CARD_TOL[x.dtype] == tol
        _k1_equals_plain(name, x, tab, loops, signs)


@pytest.mark.cuda
def test_cuda_kernel_forms_of_its_design(cuda_device):
    """Every split of the design against the plain version, and a
    shared-table batch's two paths (row, batch) bit for bit."""
    for name, x, tab, loops, signs in _split_cases(cuda_device):
        got = _k1_equals_plain(name, x, tab, loops, signs)
        if x.dim() == 2 and tab.dim() == 2:
            for interleave in (False, True):
                other = KS._spmv_cuda(x, tab, loops, signs,
                                      interleave=interleave)
                assert torch.equal(got, other), (name, interleave)


@pytest.mark.cuda
def test_cuda_kernel_f32_equals_k2_bit_for_bit(cuda_device):
    """f32 over one table with (n,) loops sums each row as K2 does."""
    from repro_torch.kernels import cayley_spmv as CS

    rng = np.random.default_rng(RNG_SEED + 2)
    for n, k in ((4099, 6), (2053, 16), (2053, 32), (1000, 13)):
        tab = _t(rng.integers(0, n, size=(n, k)), torch.int32, cuda_device)
        loops = _t(rng.integers(0, 3, size=n), device=cuda_device)
        for B in (1, 2, 3, 5, 24, 33, 64, 65):
            shape = (B, n) if B > 1 else (n,)
            x = _t(rng.standard_normal(shape), device=cuda_device)
            for lw in (loops, None):
                assert torch.equal(KS.spmv_cuda(x, tab, lw),
                                   CS.cayley_spmv_cuda(x, tab, lw)), (n, k, B)


def _fma_f32(a, b, c):
    """round_f32(a * b + c) with one rounding, as a fused multiply-add: the
    product of two f32 values is exact in f64, TwoSum gives the f64 sum's
    rounding error, and where that sum is an f32 tie the error decides it."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)
    r = s.float()
    rd = r.double()
    up = torch.nextafter(r, torch.full_like(r, math.inf)).double()
    dn = torch.nextafter(r, torch.full_like(r, -math.inf)).double()
    tie = ((s == (rd + up) / 2) | (s == (rd + dn) / 2)) & (err != 0)
    away = torch.nextafter(s, torch.where(err > 0, math.inf, -math.inf)
                           .to(s.dtype))
    return torch.where(tie, away.float(), r)


def _sequential(x, tab, signs=None, loops=None):
    """``acc = acc + s_j x[t_j]`` for j = 0..k-1 in x's dtype, then
    ``loops x + acc`` fused: the order of every path of the kernel."""
    acc = torch.zeros_like(x)
    for j in range(tab.shape[-1]):
        idx = tab[..., j].long()
        g = (x[idx] if x.dim() == 1 else x[:, idx] if idx.dim() == 1
             else torch.gather(x, 1, idx))
        acc = acc + (g if signs is None else signs[..., j] * g)
    return acc if loops is None else _fma_f32(loops, x, acc)


@pytest.mark.cuda
def test_cuda_kernel_signed_f32_equals_sequential_sum(cuda_device):
    """Signed f32 (exact +-1 products) equals acc = acc + s_j x[t_j] in
    table order, bit for bit: (n,), shared-table batches with (n, k) and
    (B, n, k) signs (both paths), and a (B, n, k) table stack."""
    rng = np.random.default_rng(RNG_SEED + 3)
    dev = cuda_device
    for n, k, B in ((4099, 6, 1), (2053, 32, 24), (2053, 32, 12),
                    (3001, 7, 5), (16384, 32, 24), (2053, 200, 1),
                    (2053, 200, 3)):
        tab = _t(rng.integers(0, n, size=(n, k)), torch.int32, dev)
        shape = (B, n) if B > 1 else (n,)
        x = _t(rng.standard_normal(shape), device=dev)
        for sshape in ((n, k), (B, n, k)) if B > 1 else ((n, k),):
            s = _t(rng.choice([-1.0, 1.0], size=sshape), device=dev)
            want = _sequential(x, tab, s)
            assert torch.equal(KS.spmv_cuda(x, tab, None, s), want), \
                (n, k, B, sshape)
            if B > 1:
                for interleave in (False, True):
                    assert torch.equal(KS._spmv_cuda(
                        x, tab, None, s, interleave=interleave), want)
    tabs = _t(rng.integers(0, 2053, size=(3, 2053, 32)), torch.int32, dev)
    x = _t(rng.standard_normal((3, 2053)), device=dev)
    s = _t(rng.choice([-1.0, 1.0], size=(3, 2053, 32)), device=dev)
    assert torch.equal(KS.spmv_cuda(x, tabs, None, s), _sequential(x, tabs, s))


@pytest.mark.cuda
def test_cuda_kernel_unsigned_loops_k200_equals_sequential_sum(cuda_device):
    """The unstaged runtime-radix row path (k = 200, a table tile beyond
    the shared-memory budget) with loops, on normal data: (n,) and a
    shared-table (3, n) batch with (n,) and (3, n) loops, both paths, equal
    the sequential f32 sum and its fused loop term bit for bit."""
    rng = np.random.default_rng(RNG_SEED + 5)
    dev = cuda_device
    n, k = 2053, 200
    tab = _t(rng.integers(0, n, size=(n, k)), torch.int32, dev)
    for B in (1, 3):
        shape = (B, n) if B > 1 else (n,)
        x = _t(rng.standard_normal(shape), device=dev)
        for lshape in ((n,), (B, n)) if B > 1 else ((n,),):
            loops = _t(rng.standard_normal(lshape), device=dev)
            want = _sequential(x, tab, loops=loops)
            assert torch.equal(KS.spmv_cuda(x, tab, loops), want), \
                (B, lshape)
            if B > 1:
                for interleave in (False, True):
                    assert torch.equal(KS._spmv_cuda(
                        x, tab, loops, interleave=interleave), want), \
                        (B, lshape, interleave)


@pytest.mark.cuda
def test_cuda_kernel_f64_integers_exact(cuda_device):
    """f64 path counts (the sigma DP's) are exact: (n,), the scale row's
    (16, n) and (64, n), and 300 vectors (two batch chunks)."""
    rng = np.random.default_rng(RNG_SEED + 4)
    dev = cuda_device
    for n, B in ((65536, 1), (65536, 16), (65536, 64), (4099, 300)):
        tab = _t(rng.integers(0, n, size=(n, 32)), torch.int32, dev)
        shape = (B, n) if B > 1 else (n,)
        x = _t(rng.integers(0, 2 ** 20, size=shape), torch.float64, dev)
        assert torch.equal(KS.spmv_cuda(x, tab), KS.spmv_ref(x, tab)), B


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


# --------------------------------------------------------------------------
# the batch path's layout and chip_smoke.py's bound (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,elem,P", [
    (1, 4, 1), (2, 4, 2), (3, 4, 4), (5, 4, 8), (8, 4, 8), (12, 4, 16),
    (24, 4, 24), (33, 4, 40), (64, 8, 64), (16, 8, 16), (65, 8, 68),
    (3, 2, 4), (24, 2, 32)])
def test_interleave_stride_keeps_rows_inside_their_sectors(B, elem, P):
    """A row of the interleaved x never straddles more 32-byte sectors than
    its B values need: a power of two below 32 bytes, whole sectors above."""
    got = KS.interleave_stride(B, elem)
    assert got == P and got >= B
    row = got * elem
    assert (32 % row == 0) if row < 32 else (row % 32 == 0)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("x_shape,elem,table_shape,l2_bytes", [
    ((113460,), 4, (113460, 6), 680_760 * 32),           # lps(61,5) (n,)
    ((1, 113460), 4, (113460, 6), 680_760 * 32),         # the Lanczos (1, n)
    ((65536,), 4, (65536, 16), 33_554_432),               # hypercube(16)
    ((24, 16384), 4, (16384, 32), 524_288 * 96),          # signed (24, n)
    ((12, 32768), 4, (32768, 32), 1_048_576 * 64),        # signed (12, n)
    ((64, 65536), 8, (65536, 32), 2_097_152 * 512),       # f64 (64, n)
    ((16, 65536), 8, (65536, 32), 268_435_456),           # f64 (16, n)
    ((4, 113460), 4, (4, 113460, 6), 4 * 680_760 * 32),  # per-batch tables
    ((4, 113460), 4, (113460, 6), 680_760 * 32),         # (4, n) shared
    ((4, 113460), 2, (113460, 6), 680_760 * 32),         # bf16 (4, n)
    ((33, 100), 4, (100, 3), 300 * 5 * 32),              # 132 B: 5 sectors
])
def test_smoke_gather_l2_bytes(smoke, x_shape, elem, table_shape, l2_bytes):
    assert smoke.gather_l2_bytes(x_shape, elem, table_shape) == l2_bytes


def test_smoke_l2_bytes_of_k2_lps_row(smoke):
    """K2's lps(61,5) f32 (n,) row: 680,760 sectors, 21.8 MB."""
    got = smoke.gather_l2_bytes((113460,), 4, (113460, 6))
    assert got == 21_784_320


@pytest.mark.parametrize("l2_tb_s", [1.0, 3.5, 10.0, 30.0, 46.9])
def test_smoke_l2_sector_time_stays_out_of_the_bound(smoke, l2_tb_s):
    """f64 (64, n) over (65536, 32): 75.5 MB of device memory (22.5 us at
    3.35 TB/s) bound it; its 1.07 GB of L2 sectors give a diagnostic time
    at the measured L2 bandwidth that never enters the bound."""
    x, tab = _meta((64, 65536), torch.float64), _meta((65536, 32),
                                                      torch.int32)
    nbytes, flops = smoke._case_bytes_ops(x, tab, None, None)
    assert nbytes == 75_497_472 and flops == 64 * 65536 * 32
    b = smoke.kernel_bound(nbytes, flops, smoke.PEAK_FLOPS["float64"])
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.022536, rel=1e-4)
    l2 = smoke.gather_l2_bytes(tuple(x.shape), 8, tuple(tab.shape))
    d = smoke.l2_sector_time(l2, l2_tb_s * 1e12)
    assert d == dict(l2_bytes=l2, l2_sector_ms=pytest.approx(
        l2 / (l2_tb_s * 1e12) * 1e3))


def test_smoke_bound_picks_the_largest_time(smoke):
    """Signed (24, n): 55.6 MB of device memory (signs 50.3 MB) against
    1.6 GFLOP: bound by bytes; operations where they dominate."""
    x, tab = _meta((24, 16384)), _meta((16384, 32), torch.int32)
    signs = _meta((24, 16384, 32))
    nbytes, flops = smoke._case_bytes_ops(x, tab, None, signs)
    assert nbytes == 55_574_528
    pk = smoke.PEAK_FLOPS["float32"]
    b = smoke.kernel_bound(nbytes, flops, pk)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    b = smoke.kernel_bound(10, 10 ** 9, pk)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1e9 / pk * 1e3)


def _nearest_f32(v: fractions.Fraction) -> float:
    """The f32 nearest the exact ``v``, ties to even, by exact arithmetic."""
    r = np.float32(float(v))                    # within an ulp of v
    best = None
    for c in (np.nextafter(r, np.float32(-np.inf)), r,
              np.nextafter(r, np.float32(np.inf))):
        d = abs(fractions.Fraction(float(c)) - v)
        even = int(np.float32(c).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return float(best[1])


def test_fma_f32_reference_rounds_once():
    """The card tests' fused loop term: seeded normal data and products of
    very different scales against exact rational arithmetic, and two sums
    whose f64 value is an f32 tie that the exact value is not (a * b =
    2^6 +- 2^-26 from 641 * 6700417 = 2^32 + 1 and 65535 * 65537 =
    2^32 - 1), where f64 then f32 would round the wrong way."""
    rng = np.random.default_rng(RNG_SEED + 6)
    a = rng.standard_normal(400).astype(np.float32)
    b = (rng.standard_normal(400)
         * 2.0 ** rng.integers(-30, 30, 400)).astype(np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    a = np.append(a, np.float32([641 * 2.0 ** -13, 65535 * 2.0 ** -13]))
    b = np.append(b, np.float32([6700417 * 2.0 ** -13, 65537 * 2.0 ** -13]))
    c = np.append(c, np.float32([2.0 ** 30, 2.0 ** 30 + 2.0 ** 7]))
    got = _fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    assert got.dtype == np.float32
    for i in range(len(a)):
        v = fractions.Fraction(float(a[i])) * fractions.Fraction(float(b[i])) \
            + fractions.Fraction(float(c[i]))
        assert float(got[i]) == _nearest_f32(v), i
    assert float(got[-2]) == 2.0 ** 30 + 2.0 ** 7
    assert float(got[-1]) == 2.0 ** 30 + 2.0 ** 7
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert float(naive[-2]) == 2.0 ** 30 and float(naive[-1]) == 2.0 ** 30 + 2.0 ** 8
