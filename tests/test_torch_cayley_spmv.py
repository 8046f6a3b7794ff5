"""Kernel K2 (Cayley matvec): its plain version and ``ops`` entry points
against the JAX reference.

On the CPU the port's ``cayley_spmv_ref`` / ``adjacency_matvec`` are held
against the reference's Pallas ``cayley_spmv`` in interpret mode and its
``spmv_ref`` oracle, on the same numpy inputs, at the reference's own
per-dtype ``TOL`` (tests/test_kernels.py:17: 2e-5 f32, 2e-2 bf16, allclose
with atol = rtol), and against the dense adjacency (1e-3 f32, 1e-1 bf16,
scaled by k as there).  Tests marked ``cuda`` hold the CUDA kernel against
the plain version on the card; they skip elsewhere (run them there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cayley_spmv.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import registry as PR
from repro_torch.core import spectral as PS
from repro_torch.core.graphs import Topology
from repro_torch.kernels import cayley_spmv as CS
from test_torch_harness import load_reference

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _np(y):
    return y.detach().to("cpu", torch.float32).numpy().astype(np.float64)


def _ref_kernel(ref, x, tab, loops, block, jdtype):
    """The reference's Pallas kernel (interpret mode) on numpy operands."""
    jnp = ref.jnp
    lw = None if loops is None else jnp.asarray(loops, jdtype)
    y = ref.cayley_spmv_kernel.cayley_spmv(
        jnp.asarray(x, jdtype), jnp.asarray(tab, jnp.int32), lw,
        block_rows=block, interpret=True)
    return np.asarray(y, dtype=np.float64)


def _ref_oracle(ref, x, tab, loops=None):
    jnp = ref.jnp
    lw = None if loops is None else jnp.asarray(loops, jnp.float32)
    y = ref.cayley_spmv_ref.spmv_ref(jnp.asarray(x, jnp.float32),
                                     jnp.asarray(tab, jnp.int32), lw)
    return np.asarray(y, dtype=np.float64)


# --------------------------------------------------------------------------
# parity with the reference (CPU)
# --------------------------------------------------------------------------

def test_lps_matches_reference_kernel_oracle_and_dense(ref):
    g = PR.build("lps(13,5)")
    tab = g.neighbor_table()
    x = np.random.default_rng(2).standard_normal(g.n).astype(np.float32)
    want = _ref_kernel(ref, x, tab, None, 256, ref.jnp.float32)
    for got in (CS.cayley_spmv_ref(torch.as_tensor(x), torch.as_tensor(tab)),
                CS.adjacency_matvec(torch.as_tensor(x), torch.as_tensor(tab))):
        assert got.dtype == torch.float32 and got.shape == (g.n,)
        np.testing.assert_allclose(_np(got), want, atol=1e-5)
        np.testing.assert_allclose(_np(got), _ref_oracle(ref, x, tab),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got), g.adjacency() @ x, atol=1e-3)


def _even_regular(n, k, seed):
    """Random k-regular simple graph, bumping n once if n*k is odd (the
    reference test's helper, on the port's networkx-free family)."""
    return PR.build(f"random_regular({n if (n * k) % 2 == 0 else n + 1},"
                    f"{k},{seed})")


# (n, k, block_rows, dtype, loops): the reference's property sweep over
# tests/test_kernels.py:130-150, drawn once; blocks that do not divide n
# exercise the reference's ragged (padded) last grid block
PROPERTY_CASES = [
    (100, 3, 32, torch.float32, False), (513, 6, 128, torch.float32, False),
    (64, 4, 64, torch.float32, False), (20, 3, 8, torch.float32, True),
    (37, 4, 16, torch.bfloat16, False), (58, 6, 33, torch.float32, True),
    (71, 3, 128, torch.bfloat16, True), (90, 4, 33, torch.float32, False),
    (45, 6, 8, torch.bfloat16, True), (83, 3, 16, torch.float32, True),
]


@pytest.mark.parametrize("n,k,block,dtype,with_loops", PROPERTY_CASES)
def test_random_regular_matches_reference(ref, n, k, block, dtype,
                                          with_loops):
    g = _even_regular(n, k, seed=n * 7 + k)
    tab = g.neighbor_table()
    rng = np.random.default_rng(n * 13 + block)
    jdt = ref.jnp.float32 if dtype == torch.float32 else ref.jnp.bfloat16
    # the same values on both sides: draw in f32, round once to the dtype
    x = np.array(ref.jnp.asarray(rng.standard_normal(g.n), jdt),
                 dtype=np.float32)
    loops = rng.integers(0, 3, size=g.n).astype(np.float32) if with_loops \
        else None
    want = _ref_kernel(ref, x, tab, loops, block, jdt)
    got = CS.cayley_spmv_ref(
        torch.as_tensor(x).to(dtype), torch.as_tensor(tab),
        None if loops is None else torch.as_tensor(loops).to(dtype))
    assert got.shape == (g.n,) and got.dtype == dtype
    np.testing.assert_allclose(_np(got), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    A = g.adjacency()
    if with_loops:
        A[np.arange(g.n), np.arange(g.n)] += loops
    tol = 1e-3 if dtype == torch.float32 else 1e-1
    np.testing.assert_allclose(_np(got), A @ x.astype(np.float64),
                               atol=tol * k, rtol=tol)


@pytest.mark.parametrize("n,k,drop", [(30, 3, 2), (48, 5, 5), (60, 5, 1)])
def test_padded_gather_operands_match_reference(ref, n, k, drop):
    """Edge-irregular graphs through gather_operands: the self-index padding
    and its negative loop compensation cancel, as in the reference."""
    g = _even_regular(n, k, seed=n + k)
    h = Topology("ragged", g.n, g.edges[: g.m - drop])
    tab, w = h.gather_operands()
    x = np.random.default_rng(n * 3 + drop).standard_normal(h.n).astype(
        np.float32)
    want = _ref_kernel(ref, x, tab, w, 8, ref.jnp.float32)
    got = CS.cayley_spmv_ref(torch.as_tensor(x), torch.as_tensor(tab),
                             torch.as_tensor(w))
    np.testing.assert_allclose(_np(got), want, atol=1e-5)
    np.testing.assert_allclose(_np(got), h.adjacency() @ x, atol=1e-3)


@pytest.mark.parametrize("B", [1, 4])
def test_batched_rows_equal_single_vector_calls(B):
    """(1, n) — the Lanczos operand — and (B, n) over one table give each
    row exactly what the (n,) call gives (the Pallas kernel takes (n,))."""
    g = PR.build("lps(13,5)")
    tab, w = (torch.as_tensor(a) for a in g.gather_operands())
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((B, g.n)),
                        dtype=torch.float32)
    Y = CS.cayley_spmv(X, tab, w)
    assert Y.shape == (B, g.n)
    for b in range(B):
        assert torch.equal(Y[b], CS.cayley_spmv(X[b], tab, w))


def test_kernel_matvec_lanczos_on_slimfly():
    """End-to-end, as the reference's test_lanczos_with_kernel_matvec:
    Lanczos on kernel_matvec reproduces rho2(slimfly(5)) = 5."""
    g = PR.build("slimfly(5)")
    mv = CS.kernel_matvec(g.neighbor_table(), device="cpu")
    lmax, _ = PS.lanczos_extremes(mv, g.n, m=60,
                                  deflate_vectors=[np.ones(g.n)],
                                  device="cpu")
    assert abs(g.radix - lmax - 5.0) < 1e-3
    rho2 = PS.rho2_lanczos(g, iters=60, matvec=mv, device="cpu")
    assert abs(rho2 - 5.0) < 1e-3


def test_plain_route_and_operand_checks():
    """A CPU tensor goes to the plain version and launches nothing; the
    wrappers refuse what the kernel does not take."""
    g = PR.build("petersen")
    tab = torch.as_tensor(g.neighbor_table())
    x = torch.randn(g.n, generator=torch.Generator().manual_seed(0))
    CS.reset_launches()
    assert torch.equal(CS.cayley_spmv(x, tab), CS.cayley_spmv_ref(x, tab))
    assert torch.equal(CS.adjacency_matvec(x, tab, use_kernel=False),
                       CS.cayley_spmv_ref(x, tab))
    assert CS.launches() == 0
    with pytest.raises(ValueError, match="not supported"):
        CS.cayley_spmv_ref(x.double(), tab)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        CS.cayley_spmv_cuda(x, tab)
    with pytest.raises(ValueError, match=r"\[0, n\)"):
        CS.kernel_matvec(np.full((g.n, 3), g.n), device="cpu")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card_cases(dev):
    rng = np.random.default_rng(11)
    lps_tab, lps_w = PR.build("lps(13,5)").gather_operands()
    n = lps_tab.shape[0]
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    yield "lps f32 loops", t(rng.standard_normal(n)), t(lps_tab, torch.int32), \
        t(lps_w)
    yield "lps bf16 loops", t(rng.standard_normal(n), torch.bfloat16), \
        t(lps_tab, torch.int32), t(lps_w)
    yield "lps f32 (3, n)", t(rng.standard_normal((3, n))), \
        t(lps_tab, torch.int32), t(lps_w)
    for k in (5, 11, 32):                      # compiled and runtime radices
        m = 1001
        yield f"ragged k={k}", t(rng.standard_normal(m)), \
            t(rng.integers(0, m, size=(m, k)), torch.int32), \
            t(rng.integers(0, 3, size=m))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    for name, x, tab, loops in _card_cases(cuda_device):
        before = CS.launches()
        got = CS.cayley_spmv_cuda(x, tab, loops)
        want = CS.cayley_spmv_ref(x, tab, loops)
        torch.cuda.synchronize()
        assert CS.launches() == before + 1, name
        assert got.dtype == x.dtype and got.shape == x.shape, name
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[x.dtype],
                                   rtol=TOL[x.dtype], err_msg=name)


@pytest.mark.cuda
def test_cuda_kernel_matvec_lanczos(cuda_device):
    g = PR.build("slimfly(5)")
    mv = CS.kernel_matvec(*g.gather_operands(), device=cuda_device)
    CS.reset_launches()
    rho2 = PS.rho2_lanczos(g, iters=60, matvec=mv, device=cuda_device)
    assert abs(rho2 - 5.0) < 1e-3
    assert CS.launches() == 60
