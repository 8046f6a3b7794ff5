"""Kernels K3 (flash attention), K4 (Mamba scan) and K5 (RMSNorm): their
plain versions against the JAX reference, and the kernels against their
plain versions on the card.

On the CPU each plain version is held against the reference's Pallas kernel
in interpret mode and against its pure-jnp oracle, on the same numpy inputs,
at the reference's own tolerances (tests/test_kernels.py: 2e-5 in f32, 2e-2
in bf16, 3e-5 for f32 attention), ragged shapes included: a row count that
is no block multiple, a sequence that is no tile multiple, a length that is
no chunk multiple.  K4's final state is held against the reference's
``selective_scan_chunked``.  The kernels' gradient (``kernels/grad.py``:
the kernel forward, the plain version's backward; K3's own backward) is
checked here with each plain version standing in for its launch:
``gradcheck`` in f64, equality with autograd of the plain version, and
nothing saved under ``no_grad``.  K3's backward kernel and its plain
version are tested in ``tests/test_torch_attention_grad.py``.
Tests marked ``cuda`` launch the kernels on the card; they skip elsewhere
(run them there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels import grad as G
from repro_torch.kernels import mamba_scan as K4
from repro_torch.kernels import rmsnorm as K5
from test_torch_harness import load_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
#: bf16 flash attention on the card, beside the allclose: each output row's
#: relative L2 gap to the plain version, at most 4 bf16 ulps (chip_smoke.py's
#: ATTN_ROW_REL_TOL)
ATTN_ROW_REL_TOL = 4 * 2.0 ** -8
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


def _jnp(ref, a, dtype):
    return ref.jnp.asarray(a, ref.jnp.float32).astype(getattr(ref.jnp, dtype))


def _t(a, dtype, device="cpu"):
    """numpy f32 -> torch ``dtype`` (bf16 rounds exactly as jnp's astype)."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(TORCH_DT[dtype]).to(
        device)


def _np(x):
    return (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# K5: RMSNorm
# --------------------------------------------------------------------------

RMS_CASES = [((64, 256), 256), ((3, 17, 96), 256), ((37, 64), 8),
             ((300, 128), 256)]


@pytest.mark.parametrize("shape,block_rows", RMS_CASES,
                         ids=["64x256", "3x17x96", "ragged37x64",
                              "ragged300x128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(ref, shape, block_rows, dtype):
    rng = _rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    want_k = ref.rmsnorm_kernel.rmsnorm(_jnp(ref, x, dtype), _jnp(ref, w, dtype),
                                        block_rows=block_rows, interpret=True)
    want_r = ref.rmsnorm_ref.rmsnorm_ref(_jnp(ref, x, dtype),
                                         _jnp(ref, w, dtype))
    got = K5.rmsnorm_ref(_t(x, dtype), _t(w, dtype))
    assert got.dtype == TORCH_DT[dtype] and got.shape == shape
    _close(got, want_k, TOL[dtype])
    _close(got, want_r, TOL[dtype])


# --------------------------------------------------------------------------
# K3: flash attention
# --------------------------------------------------------------------------

FA_CASES = [  # (B, S, H, Kv, hd, causal, dtype)
    (2, 128, 2, 2, 32, True, "float32"),
    (1, 100, 2, 2, 32, True, "float32"),          # ragged: S not a tile multiple
    (1, 100, 2, 2, 32, False, "float32"),
    (1, 64, 4, 4, 64, False, "bfloat16"),
    (1, 96, 2, 2, 32, True, "bfloat16"),
]


@pytest.mark.parametrize("case", FA_CASES,
                         ids=[f"{c[1]}-{'causal' if c[5] else 'full'}-{c[6]}"
                              for c in FA_CASES])
def test_attention_plain_matches_pallas(ref, case):
    B, S, H, Kv, hd, causal, dtype = case
    rng = _rng(S + hd)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, Kv, Kv))
    tr = (0, 2, 1, 3)            # the Pallas kernel takes (B, H, S, hd)
    want = ref.flash_attention_kernel.flash_attention(
        _jnp(ref, q.transpose(tr), dtype), _jnp(ref, k.transpose(tr), dtype),
        _jnp(ref, v.transpose(tr), dtype), causal=causal, block_q=64,
        block_k=64, interpret=True)
    got = K3.attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                           causal=causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, S, H, hd)
    _close(got, np.asarray(want, np.float32).transpose(tr), ATTN_TOL[dtype])


def test_attention_plain_gqa_matches_reference_ops(ref):
    """GQA in the model's layout: the port reads kv head h // G where the
    reference's ``gqa_flash_attention`` repeats K and V."""
    B, S, H, Kv, hd = 2, 72, 4, 2, 16
    rng = _rng(3)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, Kv, Kv))
    jnp = ref.jnp
    want = ref.flash_attention_ops.gqa_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        use_kernel=True, interpret=True)
    got = K3.attention_ref(_t(q, "float32"), _t(k, "float32"),
                           _t(v, "float32"), causal=True)
    _close(got, want, ATTN_TOL["float32"])


def _tf32(x):
    """float32 -> TF32 (10-bit mantissa), rounding to nearest with ties away
    from zero, as the card's ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm_3xtf32(a, b):
    """a @ b as K3's f32 path computes it: small * big + big * small +
    big * big, each a product of TF32 values summed in f32."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _attention_3xtf32(q, k, v, causal, mm=_mm_3xtf32, bk=32):
    """K3's f32 path in torch: 32-key tiles, online softmax in exp2 with
    scale * log2(e) folded in, both products in 3xTF32 (P split too)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh, vh = (t.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    sl2 = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32) * \
        torch.tensor(1.4426950408889634, dtype=torch.float32)
    m = torch.full((B, H, S, 1), -np.inf)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, hd))
    q_pos = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = mm(qh, kh[:, :, k0:k0 + bk].transpose(-1, -2))
        k_pos = k0 + torch.arange(s.shape[-1])[None, :]
        if causal:
            s = s.masked_fill(k_pos > q_pos, -np.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        mu = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
        corr = torch.exp2(m - mu)
        m = mn
        p = torch.exp2(s * sl2 - mu)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vh[:, :, k0:k0 + bk])
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


@pytest.mark.parametrize("S,causal", [(1024, True), (256, False)],
                         ids=["1024-causal", "256-full"])
def test_flash_attention_3xtf32_meets_f32_tolerance(ref, S, causal):
    """The f32 path's split-precision TF32 products, emulated here, hold
    the reference's Pallas kernel (interpret mode) to the f32 attention
    tolerance at the serving head width; plain TF32 products would not."""
    B, H, Kv, hd = 1, 4, 2, 128
    rng = _rng(S + 7)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, Kv, Kv))
    jnp = ref.jnp
    tr = (0, 2, 1, 3)
    G = H // Kv
    want = ref.flash_attention_kernel.flash_attention(
        jnp.asarray(q.transpose(tr)),
        jnp.asarray(np.repeat(k.transpose(tr), G, axis=1)),
        jnp.asarray(np.repeat(v.transpose(tr), G, axis=1)), causal=causal,
        block_q=256, block_k=256, interpret=True)
    want = np.asarray(want, np.float32).transpose(tr)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = _attention_3xtf32(tq, tk, tv, causal)
    _close(got, want, ATTN_TOL["float32"])
    _close(got, K3.attention_ref(tq, tk, tv, causal=causal),
           ATTN_TOL["float32"])
    plain_tf32 = _attention_3xtf32(
        tq, tk, tv, causal, mm=lambda a, b: _tf32(a) @ _tf32(b))
    err = np.abs(_np(plain_tf32) - want) - ATTN_TOL["float32"] * (
        1 + np.abs(want))
    assert err.max() > 0


# --------------------------------------------------------------------------
# K4: Mamba selective scan
# --------------------------------------------------------------------------

MS_CASES = [  # (B, L, Di, N, chunk, block_d)
    (2, 64, 32, 8, 16, 16),
    (1, 37, 16, 4, 16, 16),                       # ragged: L not a chunk multiple
    (2, 32, 48, 16, 32, 16),
]


def _ssm_inputs(B, L, Di, N, seed):
    rng = _rng(seed)
    x = rng.standard_normal((B, L, Di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, L, Di)) * 0.5)).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal((Di, N)) * 0.3)).astype(np.float32)
    B_t = rng.standard_normal((B, L, N)).astype(np.float32)
    C_t = rng.standard_normal((B, L, N)).astype(np.float32)
    D = (rng.standard_normal(Di) * 0.5 + 1.0).astype(np.float32)
    return x, delta, A, B_t, C_t, D


@pytest.mark.parametrize("case", MS_CASES,
                         ids=[f"L{c[1]}-Di{c[2]}-N{c[3]}" for c in MS_CASES])
def test_mamba_scan_plain_matches_pallas(ref, case):
    B, L, Di, N, chunk, block_d = case
    arrs = _ssm_inputs(B, L, Di, N, L + Di)
    jnp = ref.jnp
    want = ref.mamba_scan_kernel.mamba_scan(
        *(jnp.asarray(a) for a in arrs), chunk=chunk, block_d=block_d,
        interpret=True)
    want_r = ref.mamba_scan_ref.mamba_scan_ref(*(jnp.asarray(a) for a in arrs))
    y, h = K4.mamba_scan_ref(*(_t(a, "float32") for a in arrs))
    assert y.shape == (B, L, Di) and h.shape == (B, Di, N)
    assert h.dtype == torch.float32
    _close(y, want, TOL["float32"])
    _close(y, want_r, TOL["float32"])
    # the final state the kernel adds for the decode cache
    _, h_chunked = ref.mamba.selective_scan_chunked(
        *(jnp.asarray(a) for a in arrs), chunk=chunk)
    _close(h, h_chunked, TOL["float32"])


def test_mamba_scan_plain_bf16_matches_pallas(ref):
    B, L, Di, N = 1, 40, 16, 8
    x, delta, A, B_t, C_t, D = _ssm_inputs(B, L, Di, N, 11)
    jnp = ref.jnp
    bf = [_jnp(ref, a, "bfloat16") for a in (x, delta)]
    bt, ct = _jnp(ref, B_t, "bfloat16"), _jnp(ref, C_t, "bfloat16")
    want = ref.mamba_scan_kernel.mamba_scan(
        bf[0], bf[1], jnp.asarray(A), bt, ct, jnp.asarray(D), chunk=16,
        block_d=16, interpret=True)
    y, _ = K4.mamba_scan_ref(_t(x, "bfloat16"), _t(delta, "bfloat16"),
                             _t(A, "float32"), _t(B_t, "bfloat16"),
                             _t(C_t, "bfloat16"), _t(D, "float32"))
    assert y.dtype == torch.bfloat16
    _close(y, want, TOL["bfloat16"])


@pytest.mark.parametrize("B,L,Di,N", [(2, 48, 24, 16), (1, 37, 20, 5)],
                         ids=["general-A-N16", "general-A-N5"])
def test_mamba_scan_plain_matches_pallas_for_a_general_A(ref, B, L, Di, N):
    """A = -exp(U(-1, 2)) per (d, n), as K4's general-A smoke form draws it
    (no structure across n, unlike the model's -(n+1)), and N 5, which no
    lane split of K4 divides; y and the final state against the Pallas
    kernel in interpret mode and the reference's chunked scan."""
    rng = _rng(N + L)
    x, delta, _, B_t, C_t, D = _ssm_inputs(B, L, Di, N, N + L)
    A = (-np.exp(rng.uniform(-1.0, 2.0, (Di, N)))).astype(np.float32)
    arrs = (x, delta, A, B_t, C_t, D)
    jnp = ref.jnp
    want = ref.mamba_scan_kernel.mamba_scan(
        *(jnp.asarray(a) for a in arrs), chunk=16, block_d=8, interpret=True)
    _, h_want = ref.mamba.selective_scan_chunked(
        *(jnp.asarray(a) for a in arrs), chunk=16)
    y, h = K4.mamba_scan_ref(*(_t(a, "float32") for a in arrs))
    _close(y, want, TOL["float32"])
    _close(h, h_want, TOL["float32"])


# --------------------------------------------------------------------------
# the kernels' gradient: kernel forward, plain backward
# --------------------------------------------------------------------------

def _grad_case(name, dtype=torch.float64, seed=0):
    """(module, plain version, inputs, kwargs) of one kernel at a tiny size,
    every input requiring grad."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    if name == "rmsnorm":
        args, kw = (r(3, 5, 8), r(8) + 1), dict(eps=1e-6)
        mod, plain = K5, K5.rmsnorm_ref
    elif name.startswith("attention"):
        args, kw = (r(1, 6, 4, 3), r(1, 6, 2, 3), r(1, 6, 2, 3)), dict(
            causal=name.endswith("causal"))
        mod, plain = K3, K3.attention_ref
    else:
        delta = torch.nn.functional.softplus(r(2, 5, 3))
        A = -torch.exp(torch.rand(3, 5, generator=g, dtype=dtype) * 3 - 1)
        args, kw = (r(2, 5, 3), delta, A, r(2, 5, 5), r(2, 5, 5), r(3)), {}
        mod, plain = K4, K4.mamba_scan_ref
    return mod, plain, tuple(a.requires_grad_() for a in args), kw


def _through(mod, launch, args, kw):
    """The module's kernel call with ``launch`` standing in for the launch.
    K3 takes a forward that also returns the row log-sum-exp, and its
    backward (``FlashAttentionFunction``): the plain versions stand in for
    both launches."""
    if mod is K3:
        def forward(q, k, v, causal):
            lse = K3.attention_lse_ref(q, k, v, causal=causal)[1]
            return launch(q, k, v, causal=causal), lse

        def backward(q, k, v, o, lse, do, causal):
            return K3.attention_backward_ref(q, k, v, o, lse, do,
                                             causal=causal)

        return K3._differentiable(forward, backward, *args, *kw.values())
    return mod._differentiable(launch, *args, *kw.values())


GRAD_KERNELS = ["rmsnorm", "attention-causal", "attention-full", "mamba_scan"]


@pytest.mark.parametrize("name", GRAD_KERNELS)
def test_kernel_gradient_passes_gradcheck(name):
    """Each kernel's autograd.Function, its plain version standing in for
    the launch, in f64: analytic gradients against finite differences."""
    mod, plain, args, kw = _grad_case(name)
    assert torch.autograd.gradcheck(
        lambda *a: _through(mod, plain, a, kw), args, eps=1e-6, atol=1e-6,
        rtol=1e-5)


@pytest.mark.parametrize("name", GRAD_KERNELS)
def test_kernel_gradient_equals_autograd_of_the_plain_version(name):
    """Through the Function (forward: the launch; backward: the plain
    version recomputed) the gradients are autograd's of the plain version,
    in f32, bit for bit; outputs of a tuple (K4's y, h_final) each carry
    theirs, and an output left out of the loss contributes nothing.  K3's
    backward is its own (``attention_backward_ref``, tile by tile from the
    saved log-sum-exp, the backward kernel's plain version): its gradients
    differ from autograd's of the whole softmax only in the order of f32
    sums, within 1e-5 relative (a few f32 ulps of the largest term)."""
    mod, plain, args, kw = _grad_case(name, torch.float32, seed=1)
    out = _through(mod, plain, args, kw)
    want = plain(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    g = torch.Generator().manual_seed(2)
    ws = [torch.randn(o.shape, generator=g) for o in wants]
    for used in range(1, len(outs) + 1):       # K4: y alone, then y and h
        got_g = torch.autograd.grad(
            sum((o * w).sum() for o, w in zip(outs[:used], ws)), args,
            retain_graph=True)
        want_g = torch.autograd.grad(
            sum((o * w).sum() for o, w in zip(wants[:used], ws)), args,
            retain_graph=True)
        for a, b in zip(got_g, want_g):
            if mod is K3:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(a, b)
    for o in outs:
        assert type(o.grad_fn).__name__ == (
            "FlashAttentionFunctionBackward" if mod is K3
            else "PlainBackwardBackward")


@pytest.mark.parametrize("name", GRAD_KERNELS)
def test_kernel_gradient_saves_nothing_under_no_grad(name):
    """Under ``torch.no_grad()`` (all of serving) a kernel call is one
    launch and saves no tensor; with grad enabled the Function saves its
    inputs and nothing else (K3 also its output and row log-sum-exp, what
    its backward kernel reads), and still launches once."""
    mod, plain, args, kw = _grad_case(name, torch.float32)
    calls, packed = [], []

    def launch(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        with torch.no_grad():
            out = _through(mod, launch, args, kw)
        assert len(calls) == 1 and packed == []
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.grad_fn is None and not o.requires_grad for o in outs)
        _through(mod, launch, args, kw)
    assert len(calls) == 2
    assert len(packed) == len(args) + (2 if mod is K3 else 0)


def test_kernel_wrappers_refuse_cpu_tensors_that_require_grad():
    """The gradient path starts after the wrapper's checks: a CPU tensor
    that requires grad still raises, and no launch is counted."""
    x = torch.zeros(4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        K5.rmsnorm_cuda(x, torch.ones(8))
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        K3.flash_attention_cuda(q, q, q)
    s = torch.zeros(1, 4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        K4.mamba_scan_cuda(s, s, torch.zeros(8, 4), torch.zeros(1, 4, 4),
                           torch.zeros(1, 4, 4), torch.zeros(8))
    assert K5.launches() == K3.launches() == K4.launches() == 0


# --------------------------------------------------------------------------
# the kernels' wrappers and build (CPU side)
# --------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: never the plain version."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        K5.rmsnorm_cuda(x, torch.ones(8))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        K3.flash_attention_cuda(q, q, q)
    s = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        K4.mamba_scan_cuda(s, s, torch.zeros(8, 4), torch.zeros(1, 4, 4),
                           torch.zeros(1, 4, 4), torch.zeros(8))
    assert K5.launches() == K3.launches() == K4.launches() == 0


def test_route_sends_cpu_tensors_to_the_plain_versions():
    """The model's norm takes the plain version for a CPU tensor, and no
    kernel counts a launch."""
    from repro_torch.models.layers import rms_norm

    for mod in (K3, K4, K5):
        mod.reset_launches()
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(rms_norm(x, w, 1e-6), K5.rmsnorm_ref(x, w, 1e-6))
    assert K5.launches() == K3.launches() == K4.launches() == 0


def test_build_knows_every_kernel_source():
    assert build.KERNELS == ("spmv", "cayley_spmv", "rmsnorm",
                             "flash_attention", "flash_attention_bwd",
                             "mamba_scan")
    for name in build.KERNELS:
        src = build.CSRC / f"{name}.cu"
        assert src.is_file(), src
        assert "extern \"C\"" in src.read_text()


# --------------------------------------------------------------------------
# the kernels' dispatcher operators (traceable under fake tensors)
# --------------------------------------------------------------------------

def _op_case(name, device):
    """(wrapper, plain version, inputs) of one kernel at a small bf16 shape
    on ``device``."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    if name == "rmsnorm":
        return K5.rmsnorm_cuda, K5.rmsnorm_ref, (r(3, 5, 64), r(64))
    if name == "flash_attention":
        return (K3.flash_attention_cuda, K3.attention_ref,
                (r(2, 300, 4, 64), r(2, 300, 2, 64), r(2, 300, 2, 64)))
    A = -torch.exp(torch.rand(48, 5, generator=g)).to(device)
    return (K4.mamba_scan_cuda, K4.mamba_scan_ref,
            (r(2, 7, 48), r(2, 7, 48).abs(), A, r(2, 7, 5), r(2, 7, 5),
             torch.ones(48, device=device)))


OP_KERNELS = ["rmsnorm", "flash_attention", "mamba_scan"]


def _fake_cuda(args):
    """Fake CUDA tensors of ``args``' shapes and dtypes (inside a
    FakeTensorMode: no card needed)."""
    return [torch.empty(a.shape, dtype=a.dtype, device="cuda") for a in args]


@pytest.mark.parametrize("name", OP_KERNELS)
def test_kernel_ops_give_the_plain_versions_shapes_under_fake_tensors(name):
    """Under FakeTensorMode, on fake CUDA tensors, each wrapper reaches its
    operator's fake implementation: the plain version's output shapes and
    dtypes, no launch counted, no device touched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    wrapper, plain, args = _op_case(name, "cpu")
    want = plain(*args)
    for mod in (K3, K4, K5):
        mod.reset_launches()
    with FakeTensorMode():
        got = wrapper(*_fake_cuda(args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "cuda" for t in got)
    assert K5.launches() == K3.launches() == K4.launches() == 0


def test_flash_attention_flop_formula_counts_the_blocks_the_kernel_computes():
    """K3's FLOP formula (q k^T and p v, 2 hd FLOPs each per pair) over the
    128 x 128 blocks the kernel computes.  B 2, Sq = Sk = 300, H 4, hd 64,
    causal: query blocks of 128, 128 and 44 rows reach 128, 256 and all 300
    keys, 16384 + 32768 + 13200 = 62352 pairs, 4 * 2 * 4 * 64 * 62352 =
    127,696,896 FLOPs; without the mask every block, 90000 pairs.  K4 and K5
    count none, as the reference's HLO count has none for them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    assert K3.flops(2, 300, 300, 4, 64, True) == 127_696_896
    assert K3.flops(2, 300, 300, 4, 64, False) == 4 * 2 * 4 * 64 * 90000
    for name, want in (("flash_attention", 127_696_896), ("rmsnorm", 0),
                       ("mamba_scan", 0)):
        wrapper, _, args = _op_case(name, "cpu")
        with FakeTensorMode():
            fake = _fake_cuda(args)
            with FlopCounterMode(display=False) as counter:
                wrapper(*fake)
        assert counter.get_total_flops() == want, name


def test_kernel_ops_have_no_cpu_implementation():
    """An operator runs its kernel or raises: there is no CPU kernel for it
    to fall back to."""
    _, _, args = _op_case("rmsnorm", "cpu")
    with pytest.raises(NotImplementedError):
        K5.rmsnorm_op(*args, 1e-6)
    assert K5.launches() == 0


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", OP_KERNELS)
def test_kernel_ops_match_plain_on_card(cuda_device, name):
    """Each operator, called directly, launches once and agrees with its
    plain version (bf16 tolerances of LM_TOL / ATTN_TOL's kind)."""
    wrapper, plain, args = _op_case(name, cuda_device)
    op = dict(rmsnorm=lambda x, w: K5.rmsnorm_op(x, w, 1e-6),
              flash_attention=lambda q, k, v: K3.flash_attention_op(
                  q, k, v, True),
              mamba_scan=K4.mamba_scan_op)[name]
    mod = dict(rmsnorm=K5, flash_attention=K3, mamba_scan=K4)[name]
    mod.reset_launches()
    got = op(*args)
    torch.cuda.synchronize()
    assert mod.launches() == 1
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=2e-2)

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 4096), (37, 64), (5, 3, 1000),
                                   (7, 2050), (2, 30)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(TORCH_DT[dtype])
    w = (torch.randn(shape[-1], generator=g, device=cuda_device) + 1).to(
        TORCH_DT[dtype])
    before = K5.launches()
    got = K5.rmsnorm_cuda(x, w, 1e-6)
    torch.cuda.synchronize()
    assert K5.launches() == before + 1
    _close(got, K5.rmsnorm_ref(x, w, 1e-6), TOL[dtype])
    other = torch.float32 if dtype == "bfloat16" else torch.bfloat16
    with pytest.raises(ValueError, match="w is"):
        K5.rmsnorm_cuda(x, w.to(other))


#: K5's forms for its two designs: the smoke's three timed forms, every
#: warp-slice width (1, 2, 4, 8 warps a row; 1-8 vectors a thread), the
#: block design's (a width of no whole 16-byte vectors, a row past 2,048
#: vectors), and a row count of several persistent sweeps
RMS_DESIGN_CASES = [(2048, 3584), (4096, 3584), (4096, 4096), (3, 8),
                    (1001, 1024), (37, 2056), (9, 16384), (5, 16392),
                    (70000, 64), (37, 4095)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_DESIGN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_designs_match_plain_on_card(cuda_device, shape, dtype):
    """The redesign (warp slices, rows in registers, a persistent grid) and
    the first design, each against the plain version; a misaligned x (a
    view one element in) takes the first design and agrees too."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dt = TORCH_DT[dtype]
    x = torch.randn(shape, generator=g, device=cuda_device).to(dt)
    w = (torch.randn(shape[-1], generator=g, device=cuda_device) + 1).to(dt)
    want = K5.rmsnorm_ref(x, w, 1e-6)
    _close(K5.rmsnorm_cuda(x, w, 1e-6), want, TOL[dtype])
    _close(K5.block_design_cuda(x, w, 1e-6), want, TOL[dtype])
    flat = torch.empty(x.numel() + 1, dtype=dt, device=cuda_device)
    x_off = flat[1:].view(shape).copy_(x)
    _close(K5.rmsnorm_cuda(x_off, w, 1e-6), want, TOL[dtype])


FA_CARD_CASES = [  # (B, S, H, Kv, hd, causal)
    (2, 256, 8, 2, 128, True),
    (1, 200, 4, 4, 64, False),
    (1, 77, 4, 1, 80, True),
    (2, 130, 2, 2, 16, True),
    (1, 96, 2, 1, 256, True),
    (1, 300, 8, 1, 112, True),       # MQA at the configs' other widths
    (1, 257, 8, 1, 120, False),
    (2, 384, 8, 1, 256, True),       # gemma-2b's MQA head
    (1, 4096, 4, 2, 128, True),      # many key tiles: the ring wraps
    (2, 1000, 4, 2, 64, True),       # S no multiple of the 128-row q tile
    (1, 150, 4, 2, 77, True),        # hd padded by the wrapper
    (2, 512, 10, 5, 64, True),       # lm100m's attention (f32 config)
    # more 128-row work tiles than an H100 has SMs (132), so a persistent
    # bf16 block takes several tiles at each compiled width (64, 128, 256)
    (4, 1024, 16, 2, 64, True),
    (4, 1024, 16, 2, 64, False),
    (4, 1024, 16, 2, 128, True),
    (4, 1024, 16, 2, 128, False),
    (4, 1024, 8, 1, 256, True),      # gemma-2b's prefill: 256 tiles
    (4, 1024, 8, 1, 256, False),
    (2, 1000, 28, 4, 128, True),     # qwen2-7b's heads (G = 7), ragged S
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CARD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, case,
                                                      dtype):
    B, S, H, Kv, hd, causal = case
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=cuda_device).to(
        TORCH_DT[dtype]) for n in (H, Kv, Kv))
    if dtype == "float32" and hd > 128:   # f32 tiles would not fit
        with pytest.raises(ValueError, match="head width"):
            K3.flash_attention_cuda(q, k, v, causal=causal)
        return
    before = K3.launches()
    got = K3.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K3.launches() == before + 1
    want = K3.attention_ref(q, k, v, causal=causal)
    _close(got, want, ATTN_TOL[dtype])
    if dtype == "bfloat16":
        g, w = got.double(), want.double()
        rel = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        assert float(rel.max()) <= ATTN_ROW_REL_TOL, float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 1024, 512, 16), (1, 37, 200, 8),
                                  (3, 100, 130, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_matches_plain_on_card(cuda_device, case, dtype):
    B, L, Di, N = case
    arrs = _ssm_inputs(B, L, Di, N, 5)
    x, delta, A, B_t, C_t, D = (
        _t(a, "float32" if i in (2, 5) else dtype, cuda_device)
        for i, a in enumerate(arrs))
    before = K4.launches()
    y, h = K4.mamba_scan_cuda(x, delta, A, B_t, C_t, D)
    torch.cuda.synchronize()
    assert K4.launches() == before + 1
    y_p, h_p = K4.mamba_scan_ref(x, delta, A, B_t, C_t, D)
    _close(y, y_p, TOL[dtype])
    _close(h, h_p, TOL["float32"] if dtype == "float32" else 2e-2)


#: K4's smoke forms beyond the model's (chip_smoke.py, lm_kernel_check):
#: (B, L, Di, N, general A)
MS_CARD_FORMS = {
    "serving-general-A": (4, 1024, 8192, 16, True),
    "B1-prefill": (1, 1024, 8192, 16, False),
    "N5-odd-Di": (2, 1000, 4099, 5, True),
    "L1": (4, 1, 8192, 16, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(MS_CARD_FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_forms_of_its_design_on_card(cuda_device, form,
                                                       dtype):
    """K4 against its plain version at the smoke's tolerances (LM_TOL on y,
    2e-4 on the f32 final state) on a general A, one request, N 5 at an
    odd Di (the wrapper pads a bf16 one to a 16-byte row) and a single
    step."""
    B, L, Di, N, general_a = MS_CARD_FORMS[form]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    dt = TORCH_DT[dtype]
    x = torch.randn(B, L, Di, generator=g, device=cuda_device).to(dt)
    delta = torch.nn.functional.softplus(torch.randn(
        B, L, Di, generator=g, device=cuda_device) * 0.5 - 1.0).to(dt)
    if general_a:
        A = -torch.exp(torch.rand(Di, N, generator=g, device=cuda_device) * 3
                       - 1)
    else:
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=cuda_device).expand(Di, N).contiguous()
    B_t, C_t = (torch.randn(B, L, N, generator=g, device=cuda_device).to(dt)
                for _ in range(2))
    D = torch.randn(Di, generator=g, device=cuda_device)
    before = K4.launches()
    y, h = K4.mamba_scan_cuda(x, delta, A, B_t, C_t, D)
    torch.cuda.synchronize()
    assert K4.launches() == before + 1
    y_p, h_p = K4.mamba_scan_ref(x, delta, A, B_t, C_t, D)
    assert y.dtype == dt and h.dtype == torch.float32
    _close(y, y_p, TOL[dtype])
    _close(h, h_p, 2e-4)


def _smoke():
    """chip_smoke.py, loaded as a module (its helpers, not its run)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
def test_reduced_jamba_prefill_gradients_on_card_match_the_plain_path(
        cuda_device, monkeypatch):
    """A backward pass through a reduced jamba's prefill on the card, whose
    forward launches K5, K3 and K4, gives the plain path's gradients (1e-3
    relative L2, chip_smoke.py's GRAD_REL_TOL) w.r.t. the input embeddings
    and a Mamba, an attention and a norm parameter; none is dropped.  The
    plain run replays the kernel run's MoE expert choices and launches no
    kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as PM

    cfg = reduced(get_config("jamba-v0.1-52b"))
    p = PM.init_params(cfg, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, S = 2, 24
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device=cuda_device)
    emb = PM._embed_in(p, {"tokens": toks}, cfg).detach()
    kinds = [s.kind for s in cfg.pattern]
    mi, ai = kinds.index("mamba"), kinds.index("attn")
    leaves = [emb, p["blocks"][mi]["mamba"]["A_log"],
              p["blocks"][ai]["attn"]["wq"], p["blocks"][ai]["norm1"]]
    for t in leaves:
        t.requires_grad_(True)
    w = torch.randn(B, cfg.vocab_size, generator=g, device=cuda_device)

    def grads():
        logits, _ = PM.prefill(p, {"embeds": emb}, cfg, S + 2)
        return torch.autograd.grad((logits * w).sum(), leaves)

    smoke = _smoke()
    for mod in (K3, K4, K5):
        mod.reset_launches()
    with smoke._moe_routes() as routes:
        got = grads()
    counts = [mod.launches() for mod in (K3, K4, K5)]
    assert all(n > 0 for n in counts), counts
    # the plain run takes the kernel run's MoE expert choices: near-tied
    # top-2 routings may flip at the kernels' rounding and then cascade
    with monkeypatch.context() as m, smoke._moe_routes(replay=routes):
        m.setattr(K5, "rmsnorm_cuda", K5.rmsnorm_ref)
        m.setattr(K3, "flash_attention_cuda", K3.attention_ref)
        m.setattr(K4, "mamba_scan_cuda", K4.mamba_scan_ref)
        want = grads()
    torch.cuda.synchronize()
    assert [mod.launches() for mod in (K3, K4, K5)] == counts
    for a, b in zip(got, want):
        rel = float((a - b).double().norm() / b.double().norm())
        assert rel <= 1e-3, rel
        assert not ((b != 0) & (a == 0)).any()


def test_smoke_sfu_time_counts_exponentials_at_sixteen_per_sm_clock():
    """chip_smoke.py's K4 diagnostic: B*L*Di*N exponentials at 16 per SM
    per clock; the serving shape's 537 M on 132 SMs at 1.98 GHz take
    0.1284 ms."""
    smoke = _smoke()
    exps = 4 * 1024 * 8192 * 16
    row = smoke.sfu_time(exps, 132, 1.98e9)
    assert row["exponentials"] == 536_870_912
    assert row["sfu_ms"] == pytest.approx(536_870_912 / (16 * 132 * 1.98e9)
                                          * 1e3)
    assert row["sfu_ms"] == pytest.approx(0.12838, abs=1e-5)


def test_k4_sass_counts_the_innermost_loop_with_the_most_exponentials():
    """tools/k4_sass.py on a hand-made dump: of two innermost loops inside
    an outer one, the step loop is the one with more MUFU.EX2; predicated
    opcodes count by name, NOPs not at all."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "k4_sass.py"
    spec = importlib.util.spec_from_file_location("k4_sass", path)
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    lines = ["\t\tFunction : _Z11scan_kernelI13__nv_bfloat16Li2ELi16EEvv"]
    body = ["LDC R1, c[0x0][0x28]",                  # 0x00
            "MUFU.EX2 R2, R2",                       # 0x10 outer loop from here
            "LDS.128 R4, [R3]",                      # 0x20 inner loop A
            "MUFU.EX2 R5, R5",                       # 0x30
            "FFMA R6, R5, R6, R7",                   # 0x40
            "MUFU.EX2 R8, R8",                       # 0x50
            "NOP",                                   # 0x60
            "@!P0 BRA 0x20",                         # 0x70 end of A
            "MUFU.EX2 R9, R9",                       # 0x80 inner loop B
            "@P1 BRA 0x80",                          # 0x90 end of B
            "@P2 BRA 0x10",                          # 0xa0 end of outer
            "EXIT"]
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     f"    /* 0x0000000000000000 */")
    funcs = sass.functions("\n".join(lines))
    (name, code), = funcs.items()
    assert "scan_kernel" in name and len(code) == len(body)
    assert sass.opcode("@!P0 BRA 0x20") == "BRA"
    loop = sass.step_loop(code)
    assert loop["loop"] == ["0x20", "0x70"]
    assert loop["ex2"] == 2 and loop["instructions"] == 5
    assert loop["per_element"] == 2.5
    assert loop["opcodes"] == {"MUFU.EX2": 2, "LDS.128": 1, "FFMA": 1,
                               "BRA": 1}
