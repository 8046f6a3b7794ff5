"""Kernels K3 (flash attention), K4 (Mamba scan) and K5 (RMSNorm): their
plain versions against the JAX reference, and the kernels against their
plain versions on the card.

On the CPU each plain version is held against the reference's Pallas kernel
in interpret mode and against its pure-jnp oracle, on the same numpy inputs,
at the reference's own tolerances (tests/test_kernels.py: 2e-5 in f32, 2e-2
in bf16, 3e-5 for f32 attention), ragged shapes included: a row count that
is no block multiple, a sequence that is no tile multiple, a length that is
no chunk multiple.  K4's final state is held against the reference's
``selective_scan_chunked``.  Tests marked ``cuda`` launch the kernels on the
card; they skip elsewhere (run them there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels import mamba_scan as K4
from repro_torch.kernels import rmsnorm as K5
from test_torch_harness import load_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
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
                             "flash_attention", "mamba_scan")
    for name in build.KERNELS:
        src = build.CSRC / f"{name}.cu"
        assert src.is_file(), src
        assert "extern \"C\"" in src.read_text()


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

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


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 256, 8, 2, 128, True),
                                  (1, 200, 4, 4, 64, False),
                                  (1, 77, 4, 1, 80, True),
                                  (2, 130, 2, 2, 16, True),
                                  (1, 96, 2, 1, 256, True)])
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
    _close(got, K3.attention_ref(q, k, v, causal=causal), ATTN_TOL[dtype])


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
