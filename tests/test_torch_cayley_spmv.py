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

K2 gathers x from L2.  ``tools/k2_cluster.py`` times it beside a design
that holds x in a thread-block cluster's distributed shared memory; the CPU
tests hold that design's layout rule to its contract and emulate its staged
layout in numpy (slices, owner and offset of every index, interleaved batch
groups, table-order f32 sums) against the plain version and the reference's
Pallas kernel, and the card tests run its kernel against K2.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
# the cluster design of tools/k2_cluster.py: its layout (CPU)
# --------------------------------------------------------------------------

def _load_tool():
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "k2_cluster.py"
    spec = importlib.util.spec_from_file_location("k2_cluster", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K2C = _load_tool()
LPS_N = 113_460              # lps(61,5)
# (label, B, n, elem, cluster, slice_shift, group): the forms the tool runs
# and the budget's edges; cluster 0 where not even 16 blocks hold x
LAYOUT_RULE_CASES = [
    ("lps f32 (n,)", 1, LPS_N, 4, 4, 15, 1),
    ("lps f32 (4, n)", 4, LPS_N, 4, 16, 13, 4),
    ("lps bf16 (n,): one block", 1, LPS_N, 2, 1, 17, 1),
    ("lps bf16 (4, n)", 4, LPS_N, 2, 8, 14, 4),
    ("hypercube(16) f32", 1, 65_536, 4, 2, 15, 1),
    ("ragged n=100003 f32 (k 7 and 12)", 1, 100_003, 4, 4, 15, 1),
    ("ragged n=100003 f32 (3, n)", 3, 100_003, 4, 16, 13, 4),
    ("lps f32 (5, n): two groups", 5, LPS_N, 4, 16, 13, 4),
    ("bf16 (9, n): two groups", 9, 1001, 2, 1, 10, 8),
    ("f32 one block at the budget", 1, 58_108, 4, 1, 16, 1),
    ("f32 one above one block", 1, 58_109, 4, 2, 15, 1),
    ("f32 at the budget, C 16", 1, 16 << 15, 4, 16, 15, 1),
    ("f32 one above the budget", 1, (16 << 15) + 1, 4, 0, 0, 0),
    ("n=1000003 f32", 1, 1_000_003, 4, 0, 0, 0),
    ("n=1000003 bf16", 1, 1_000_003, 2, 16, 16, 1),
    ("f32 (4, n) n=300000", 4, 300_000, 4, 0, 0, 0),
    ("n=1", 1, 1, 4, 1, 0, 1),
    ("n=1001 f32 (2, n)", 2, 1001, 4, 1, 10, 2),
]


def _block_bytes(B, n, elem, cluster):
    """A block's shared memory when ``cluster`` blocks hold one group: the
    mbarrier, then the slice."""
    row = min(1 << (B - 1).bit_length(), 16 // elem) * elem
    return 16 + row * min(1 << max(0, (-(-n // cluster) - 1).bit_length()), n)


def _layout_holds_its_contract(lay, B, n, elem):
    """What the cluster kernel needs of a layout: every index has an owner
    block in the cluster and an offset inside its slice, the slice fits a
    block and no smaller cluster could hold it, a staged row is one aligned
    load of a power of two of values."""
    assert lay.cluster in (1, 2, 4, 8, 16)
    assert lay.cluster << lay.slice_shift >= n
    assert lay.slice_shift == 0 or lay.cluster << (lay.slice_shift - 1) < n
    idx = np.arange(n, dtype=np.int64)
    owner, off = idx >> lay.slice_shift, idx & ((1 << lay.slice_shift) - 1)
    assert owner.max() < lay.cluster
    assert off.max() < min(1 << lay.slice_shift, n)
    row_bytes = lay.group * elem
    assert lay.group & (lay.group - 1) == 0 and row_bytes <= 16
    assert lay.group >= min(B, 16 // elem)
    assert lay.smem_bytes == 16 + row_bytes * min(1 << lay.slice_shift, n)
    assert lay.smem_bytes == _block_bytes(B, n, elem, lay.cluster)
    assert lay.smem_bytes <= K2C.SMEM_PER_BLOCK == 232_448
    assert lay.cluster == 1 or \
        _block_bytes(B, n, elem, lay.cluster // 2) > 232_448
    assert lay.threads == (512 if lay.group == 8 else 256)


@pytest.mark.parametrize("label,B,n,elem,cluster,shift,group",
                         LAYOUT_RULE_CASES,
                         ids=[c[0] for c in LAYOUT_RULE_CASES])
def test_cluster_layout_rule(label, B, n, elem, cluster, shift, group):
    lay = K2C.layout(B, n, elem)
    if cluster:
        assert (lay.cluster, lay.slice_shift, lay.group) == \
            (cluster, shift, group), (label, lay)
        _layout_holds_its_contract(lay, B, n, elem)
    else:
        # above the budget: not even 16 blocks can hold one group's slices
        assert lay is None, (label, lay)
        assert _block_bytes(B, n, elem, 16) > 232_448


@given(B=st.integers(1, 70), n=st.integers(1, 2_000_000),
       elem=st.sampled_from([2, 4]))
@settings(max_examples=200, deadline=None)
def test_cluster_layout_rule_over_shapes(B, n, elem):
    """Any shape has a layout that holds the contract, or is above what 16
    blocks can hold."""
    lay = K2C.layout(B, n, elem)
    if lay is not None:
        _layout_holds_its_contract(lay, B, n, elem)
    else:
        assert _block_bytes(B, n, elem, 16) > 232_448
    with pytest.raises(ValueError):
        K2C.layout(B, n, 8)


def _emulate_cluster(x, table, loops, lay):
    """The cluster kernel's arithmetic on its staged layout, in numpy float32:
    per group of ``lay.group`` vectors, block r's slice holds rows
    [r 2^s, (r + 1) 2^s) interleaved (zero beyond n and B; one block's
    slice is all n rows); a gathered index reads slice ``idx >> s`` at
    ``idx & (2^s - 1)``; the sum runs in table order from 0, the loop term
    last.  ``x``: (B, n) float32 values."""
    B, n = x.shape
    C, s, P = lay.cluster, lay.slice_shift, lay.group
    owner, off = table >> s, table & ((1 << s) - 1)
    assert owner.max() < C and off.max() < min(1 << s, n)
    y = np.zeros((B, n), np.float32)
    for g in range(-(-B // P)):
        staged = np.zeros((C, min(1 << s, n), P), np.float32)
        for r in range(C):
            lo, hi = r << s, min(n, (r + 1) << s)
            for p in range(P):
                if g * P + p < B and lo < hi:
                    staged[r, :hi - lo, p] = x[g * P + p, lo:hi]
        vals = staged[owner, off]                      # (n, k, P)
        acc = np.zeros((n, P), np.float32)
        for j in range(table.shape[1]):
            acc += vals[:, j]
        for p in range(P):
            b = g * P + p
            if b < B:
                if loops is not None:
                    acc[:, p] += loops * x[b]
                y[b] = acc[:, p]
    return y


# (label, B, n, k, dtype, loops, layout or None for the tool's own)
LAYOUT_CASES = [
    ("lps(13,5) f32 loops", 1, None, None, torch.float32, True, None),
    ("lps(13,5) bf16 loops", 1, None, None, torch.bfloat16, True, None),
    ("lps(13,5) f32 (3, n)", 3, None, None, torch.float32, True, None),
    ("ragged k=7", 1, 1001, 7, torch.float32, True, None),
    ("ragged k=12 (2, n)", 2, 1001, 12, torch.float32, True, None),
    ("f32 (5, n): two groups", 5, 777, 6, torch.float32, False, None),
    ("bf16 (9, n): two groups", 9, 300, 5, torch.bfloat16, True, None),
    ("n=70000 f32: 4 blocks", 1, 70_000, 6, torch.float32, True, None),
    ("n=40000 bf16 (4, n): 4 blocks", 4, 40_000, 6, torch.bfloat16, True,
     None),
    ("8 blocks", 2, 500, 6, torch.float32, True,
     K2C.Layout(8, 6, 2, 16 + 512, 256)),
    ("16 blocks of 64", 1, 1000, 6, torch.float32, True,
     K2C.Layout(16, 6, 1, 16 + 256, 256)),
]


@pytest.mark.parametrize("label,B,n,k,dtype,with_loops,lay", LAYOUT_CASES,
                         ids=[c[0] for c in LAYOUT_CASES])
def test_cluster_layout_emulation_matches_reference(ref, label, B, n, k,
                                                    dtype, with_loops, lay):
    rng = np.random.default_rng(sum(map(ord, label)))
    if n is None:
        tab, w = PR.build("lps(13,5)").gather_operands()
        n = tab.shape[0]
    else:
        tab = rng.integers(0, n, size=(n, k)).astype(np.int32)
        w = rng.integers(0, 3, size=n).astype(np.float32)
    loops = w.astype(np.float32) if with_loops else None
    xt = torch.as_tensor(rng.standard_normal((B, n)), dtype=dtype)
    x = xt.float().numpy()                       # the values the card stages
    elem = xt.element_size()
    if lay is None:
        lay = K2C.layout(B, n, elem)
        _layout_holds_its_contract(lay, B, n, elem)
    got = torch.as_tensor(_emulate_cluster(x, tab, loops, lay)).to(dtype)
    want = CS.cayley_spmv_ref(xt, torch.as_tensor(tab),
                              None if loops is None else torch.as_tensor(loops))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype], err_msg=label)
    # the same table-order sum without the staging, to the bit
    seq = np.zeros((B, n), np.float32)
    for j in range(tab.shape[1]):
        seq += x[:, tab[:, j]]
    if loops is not None:
        seq += loops * x
    assert torch.equal(got, torch.as_tensor(seq).to(dtype)), label
    # the reference's Pallas kernel (interpret mode), one vector at a time
    jdt = ref.jnp.float32 if dtype == torch.float32 else ref.jnp.bfloat16
    for b in range(min(B, 2)):
        pallas = _ref_kernel(ref, x[b], tab, loops, 256 if n < 5000 else 8192,
                             jdt)
        np.testing.assert_allclose(_np(got[b]), pallas, atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=label)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card_cases(dev):
    """K2's forms on the card: lps(13,5) and lps(61,5) single vectors and
    batches (f32 and bf16), hypercubes, compiled and runtime radices, and n
    = 1,000,003, whose 4 MB x no cluster's shared memory holds."""
    rng = np.random.default_rng(11)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    for spec in ("lps(13,5)", "lps(61,5)"):
        tab_np, w_np = PR.build(spec).gather_operands()
        n = tab_np.shape[0]
        tab, w = t(tab_np, torch.int32), t(w_np)
        for B, dt in ((1, torch.float32), (1, torch.bfloat16),
                      (3, torch.float32), (4, torch.bfloat16),
                      (5, torch.float32), (9, torch.bfloat16)):
            x = rng.standard_normal((B, n) if B > 1 else n)
            yield f"{spec} {dt} B={B} loops", t(x, dt), tab, w
    for spec in ("hypercube(16)", "hypercube(10)"):
        hc = PR.build(spec).neighbor_table()
        yield spec, t(rng.standard_normal(hc.shape[0])), \
            t(hc, torch.int32), None
    for m, k in ((1001, 5), (1001, 11), (1001, 32), (1, 3), (7, 5),
                 (100_003, 7), (1_000_003, 6)):
        yield f"ragged n={m} k={k}", t(rng.standard_normal(m)), \
            t(rng.integers(0, m, size=(m, k)), torch.int32), \
            t(rng.integers(0, 3, size=m))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """One launch a call, within the tolerance of the plain version and, in
    f32, equal to K1 (spmv_cuda) bit for bit."""
    from repro_torch.kernels import spmv as KS

    for name, x, tab, loops in _card_cases(cuda_device):
        before = CS.launches()
        got = CS.cayley_spmv_cuda(x, tab, loops)
        want = CS.cayley_spmv_ref(x, tab, loops)
        torch.cuda.synchronize()
        assert CS.launches() == before + 1, name
        assert got.dtype == x.dtype and got.shape == x.shape, name
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[x.dtype],
                                   rtol=TOL[x.dtype], err_msg=name)
        if x.dtype == torch.float32:
            assert torch.equal(got, KS.spmv_cuda(x, tab, loops)), name


@pytest.mark.cuda
def test_cuda_kernel_matvec_lanczos(cuda_device):
    g = PR.build("slimfly(5)")
    mv = CS.kernel_matvec(*g.gather_operands(), device=cuda_device)
    CS.reset_launches()
    rho2 = PS.rho2_lanczos(g, iters=60, matvec=mv, device=cuda_device)
    assert abs(rho2 - 5.0) < 1e-3
    assert CS.launches() == 60


@pytest.mark.cuda
def test_cuda_cluster_design_matches_plain_and_k2_bits(cuda_device):
    """tools/k2_cluster.py's kernel on every form a cluster holds: within
    the tolerance of the plain version, and in f32 equal to K2 bit for bit;
    n = 1,000,003 f32 has no layout and raises before any launch."""
    for name, x, tab, loops in _card_cases(cuda_device):
        B = x.shape[0] if x.dim() == 2 else 1
        if K2C.layout(B, x.shape[-1], x.element_size()) is None:
            with pytest.raises(ValueError, match="no cluster holds x"):
                K2C.cluster_matvec(x, tab, loops)
            continue
        got, info = K2C.cluster_matvec(x, tab, loops)
        want = CS.cayley_spmv_ref(x, tab, loops)
        torch.cuda.synchronize()
        assert info["active_clusters"] > 0 and info["clusters"] > 0, name
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[x.dtype],
                                   rtol=TOL[x.dtype], err_msg=name)
        if x.dtype == torch.float32:
            assert torch.equal(got, CS.cayley_spmv_cuda(x, tab, loops)), name


@pytest.mark.cuda
def test_cuda_cluster_launch_replays_in_a_graph(cuda_device):
    """A cluster launch (cudaLaunchKernelEx with a cluster dimension)
    captured into a CUDA graph and replayed gives the eager call's bits."""
    tab_np, w_np = PR.build("lps(13,5)").gather_operands()
    n = tab_np.shape[0]
    rng = np.random.default_rng(5)
    tab = torch.as_tensor(tab_np, dtype=torch.int32, device=cuda_device)
    w = torch.as_tensor(w_np, dtype=torch.float32, device=cuda_device)
    for shape in ((n,), (4, n)):
        x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device)
        eager = K2C.cluster_matvec(x, tab, w)[0]
        out = torch.empty_like(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            K2C.cluster_matvec(x, tab, w, out)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            K2C.cluster_matvec(x, tab, w, out)
        for _ in range(3):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), shape
