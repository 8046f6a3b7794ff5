"""The attention backward: the plain chunked attention's recompute, K3's
backward kernel and its plain version.

On the CPU, from seeded numpy inputs:

* ``models.attention.chunked_attention``'s gradient w.r.t. q, k and v
  against ``jax.grad`` of the reference's ``chunked_attention`` (its
  ``jax.checkpoint``-ed block scan), in f32: causal and not, a window,
  ragged S, GQA with G = 7 as in qwen2-7b.  Tolerance 2e-5 relative to
  the largest entry: the two frameworks sum the same f32 products in
  different orders, a few ulps apart (measured ~1e-6 here).
* A 1,024-token ``chunked_attention`` under autograd saves no tensor of
  S x S elements or more (``saved_tensors_hooks``): only the running
  (m, l, acc) cross the checkpointed blocks.
* K3's plain backward (``attention_backward_ref``, tile by tile from the
  saved row log-sum-exp) against autograd of the whole softmax
  (``attention_ref``) in f64 (1e-10) and against ``jax.grad`` of the
  reference's chunked attention in f32; the plain forward's lse against
  ``torch.logsumexp``; the new operators' fake shapes; the backward's FLOP
  formula against a hand count.

On the card (``cuda``-marked, skipped here; run there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_attention_grad.py``):
the backward kernel's dq, dk, dv against the plain backward at bf16 and f32,
hd 64 / 128 / 256 (and 77, padded), ragged S, G 1 / 7 / 8; the forward's lse
against ``torch.logsumexp`` of the plain scores.  Tolerances in relative L2
per output: f32 1e-4 (3xTF32 products keep f32's ~1e-6, the exponentials
ex2.approx ~2^-22; the sums over S run in other orders); bf16 2e-2 (dS and
P are rounded to bf16, 2^-9 relative, before three of the five products,
where the plain version keeps dS in f32).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as K3
from repro_torch.models.attention import chunked_attention
from test_torch_harness import load_reference

#: kernel backward vs plain backward, relative L2 per gradient
BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the kernel's lse vs torch.logsumexp of the plain scores (absolute: lse is
#: O(log S); f32 sums of exponentials ~1e-6 relative, bf16 inputs exact)
LSE_ABS = 1e-4
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _inputs(B, S, H, Kv, hd, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Kv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Kv, hd)).astype(np.float32),
            rng.standard_normal((B, S, H, hd)).astype(np.float32))


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_grads(ref, q, k, v, w, **kw):
    """jax.grad of sum(w * chunked_attention(q, k, v)) w.r.t. q, k, v."""
    jax, jnp = ref.jax, ref.jnp

    def loss(q, k, v):
        return jnp.sum(jnp.asarray(w) * ref.attention.chunked_attention(
            q, k, v, **kw))

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))


#: (B, S, H, Kv, hd, chunked_attention kwargs)
CHUNKED_CASES = {
    "causal": (2, 64, 4, 2, 16, dict(causal=True, q_chunk=16, k_chunk=16)),
    "non-causal": (1, 48, 2, 2, 16, dict(causal=False, q_chunk=16,
                                         k_chunk=16)),
    "window": (1, 64, 2, 1, 16, dict(causal=True, window=20, q_chunk=16,
                                     k_chunk=16)),
    "ragged": (2, 45, 2, 2, 8, dict(causal=True, q_chunk=16, k_chunk=16)),
    "gqa-7": (1, 40, 14, 2, 8, dict(causal=True, q_chunk=16, k_chunk=16)),
    "offset": (1, 32, 2, 2, 8, dict(causal=True, q_chunk=16, k_chunk=16,
                                    q_offset=16)),
}


@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_chunked_attention_gradient_matches_the_references(ref, name):
    """The port's checkpointed block loop has the reference's gradient."""
    B, S, H, Kv, hd, kw = CHUNKED_CASES[name]
    Sk = S + kw.get("q_offset", 0)
    q, k, v, w = _inputs(B, S, H, Kv, hd, seed=len(name), Sk=Sk)
    want = _ref_grads(ref, q, k, v, w, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, r in zip(got, want, strict=True):
        assert g.shape == tuple(r.shape)
        assert _max_rel(g.numpy(), r) <= 2e-5


def test_chunked_attention_forward_is_unchanged_by_the_checkpoint():
    """With grad and without, the forward gives the same bits."""
    q, k, v, _ = _inputs(1, 70, 4, 2, 16, seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=True, window=33, q_chunk=32, k_chunk=32)
    with torch.no_grad():
        plain = chunked_attention(tq, tk, tv, **kw)
    rec = chunked_attention(tq.requires_grad_(), tk, tv, **kw)
    assert rec.requires_grad and torch.equal(rec.detach(), plain)


def test_chunked_attention_saves_no_square_tensor_under_autograd():
    """A 1,024-token causal chunked attention (4 heads, 512-row blocks)
    under autograd: every tensor autograd saves has fewer than S x S
    elements.  Without the checkpoint, each live block's (1, 512, 2, 2,
    512) scores and probabilities alone are S x S elements."""
    S = 1024
    q, k, v, _ = _inputs(1, S, 4, 2, 16, seed=9)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: sizes.append(t.numel()) or t, lambda t: t):
        out = chunked_attention(tq, tk, tv, causal=True)
    assert sizes and max(sizes) < S * S, max(sizes)
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (tq, tk, tv))


# --------------------------------------------------------------------------
# K3's plain forward with lse, and its plain backward
# --------------------------------------------------------------------------

#: (B, Sq, Sk, H, Kv, hd, causal)
PLAIN_BWD_CASES = [(2, 37, 37, 4, 2, 8, True), (1, 50, 50, 7, 1, 8, True),
                   (1, 33, 33, 2, 2, 4, False), (1, 20, 29, 2, 1, 4, True),
                   (1, 300, 300, 2, 2, 4, True)]


@pytest.mark.parametrize("case", PLAIN_BWD_CASES)
def test_plain_backward_equals_autograd_of_the_plain_attention(case):
    """attention_backward_ref, tile by tile from lse, is autograd's
    gradient of attention_ref, in f64 (1e-10 relative to the largest
    entry); attention_lse_ref's O is attention_ref's and its lse is
    torch.logsumexp of the scaled, masked scores."""
    B, Sq, Sk, H, Kv, hd, causal = case
    g = torch.Generator().manual_seed(Sq)
    q, k, v = (torch.randn(B, s, n, hd, generator=g, dtype=torch.float64)
               .requires_grad_() for s, n in ((Sq, H), (Sk, Kv), (Sk, Kv)))
    do = torch.randn(B, Sq, H, hd, generator=g, dtype=torch.float64)
    o_ref = K3.attention_ref(q, k, v, causal=causal)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    o, lse = K3.attention_lse_ref(q.detach(), k.detach(), v.detach(),
                                  causal=causal)
    assert torch.allclose(o, o_ref.detach(), rtol=1e-12, atol=1e-12)
    s = torch.einsum("bqhd,bshd->bhqs", q.detach(),
                     k.detach().repeat_interleave(H // Kv, 2)) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool).triu(1),
                          -math.inf)
    assert lse.shape == (B, H, Sq)
    assert torch.allclose(lse, torch.logsumexp(s, -1), rtol=0, atol=1e-12)
    got = K3.attention_backward_ref(q.detach(), k.detach(), v.detach(), o,
                                    lse, do, causal=causal, block=16)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _max_rel(a.numpy(), b.numpy()) <= 1e-10


def test_plain_backward_matches_jax_grad_of_the_reference(ref):
    """The backward kernel's plain version, from the plain forward's lse,
    against jax.grad of the reference's chunked attention (GQA G = 7,
    ragged, causal) in f32."""
    B, S, H, Kv, hd = 1, 75, 7, 1, 16
    q, k, v, w = _inputs(B, S, H, Kv, hd, seed=11)
    want = _ref_grads(ref, q, k, v, w, causal=True, q_chunk=32, k_chunk=32)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    o, lse = K3.attention_lse_ref(tq, tk, tv, causal=True)
    got = K3.attention_backward_ref(tq, tk, tv, o, lse, tw, causal=True,
                                    block=32)
    for g, r in zip(got, want, strict=True):
        assert _max_rel(g.numpy(), r) <= 2e-5


# --------------------------------------------------------------------------
# the operators under fake tensors, and the FLOP formula
# --------------------------------------------------------------------------

def test_backward_operators_give_their_shapes_under_fake_tensors():
    """On fake CUDA tensors (no card), the forward-with-lse operator gives O
    and an f32 (B, H, Sq) lse, the backward operator dq, dk, dv of q, k,
    v's shapes and dtypes; no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    K3.reset_launches()
    K3.reset_backward_launches()
    with FakeTensorMode():
        q = torch.empty(2, 300, 4, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 300, 2, 64, dtype=torch.bfloat16, device="cuda")
        o, lse = K3.flash_attention_lse_op(q, k, k, True)
        dq, dk, dv = K3.flash_attention_backward_op(q, k, k, o, lse, o, True)
    assert (tuple(o.shape), o.dtype) == ((2, 300, 4, 64), torch.bfloat16)
    assert (tuple(lse.shape), lse.dtype) == ((2, 4, 300), torch.float32)
    assert [(tuple(t.shape), t.dtype) for t in (dq, dk, dv)] == [
        ((2, 300, 4, 64), torch.bfloat16), ((2, 300, 2, 64), torch.bfloat16),
        ((2, 300, 2, 64), torch.bfloat16)]
    assert all(t.device.type == "cuda" for t in (o, lse, dq, dk, dv))
    assert K3.launches() == K3.backward_launches() == 0


def test_backward_flop_formula_counts_the_forwards_blocks():
    """10 hd FLOPs per (query, key) pair over the forward's 128 x 128
    blocks.  B 2, S 300, H 4, hd 64, causal: 16384 + 32768 + 13200 = 62352
    pairs, 10 * 2 * 4 * 64 * 62352 = 319,242,240 FLOPs; non-causal 90000
    pairs.  The forward-with-lse and backward operators on fake CUDA
    tensors count the forward's 127,696,896 and this.  (Autograd's engine
    needs a card for CUDA tensors, fake ones too: the dry run traces the
    backward through these operators on the card.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    assert K3.backward_flops(2, 300, 300, 4, 64, True) == 319_242_240
    assert K3.backward_flops(2, 300, 300, 4, 64, False) == \
        10 * 2 * 4 * 64 * 90_000
    with FakeTensorMode():
        q = torch.empty(2, 300, 4, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 300, 2, 64, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as counter:
            o, lse = K3.flash_attention_lse_op(q, k, k, True)
            K3.flash_attention_backward_op(q, k, k, o, lse, o, True)
    assert counter.get_total_flops() == 127_696_896 + 319_242_240


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


#: (B, S, H, Kv, hd, causal): hd 64 / 128 / 256 (and 77, padded to 80), G 1
#: / 7 / 8, ragged S, more key tiles than one block's work
BWD_CARD_CASES = [
    (2, 256, 4, 4, 64, True),        # G 1
    (2, 256, 4, 4, 64, False),
    (1, 1000, 28, 4, 128, True),     # qwen2-7b's heads, G 7, ragged S
    (1, 300, 8, 1, 256, True),       # gemma-2b's MQA, G 8, ragged S
    (2, 130, 8, 1, 256, False),
    (1, 77, 2, 1, 64, True),         # one partial tile
    (1, 150, 4, 2, 77, True),        # hd padded by the wrapper
    (1, 2048, 8, 8, 128, True),      # many key tiles a block walks
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CARD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_backward_on_card(cuda_device, case,
                                                        dtype):
    B, S, H, Kv, hd, causal = case
    if dtype == "float32" and hd > 128:
        pytest.skip("K3 takes f32 head widths up to 128")
    g = torch.Generator(device=cuda_device).manual_seed(S + hd)
    dt = TORCH_DT[dtype]
    q, k, v, do = (torch.randn(B, S, n, hd, generator=g,
                               device=cuda_device).to(dt)
                   for n in (H, Kv, Kv, H))
    before = (K3.launches(), K3.backward_launches())
    o, lse = K3.flash_attention_lse_op(q, k, v, causal)
    got = K3.flash_attention_backward_op(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (K3.launches(), K3.backward_launches()) == (before[0] + 1,
                                                       before[1] + 1)
    # lse against torch.logsumexp of the plain scores
    s = torch.einsum("bqhd,bshd->bhqs", q.float(),
                     k.float().repeat_interleave(H // Kv, 2)) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=cuda_device).triu(1), -math.inf)
    lse_err = float((lse - torch.logsumexp(s, -1)).abs().max())
    assert lse_err <= LSE_ABS, lse_err
    want = K3.attention_backward_ref(q, k, v, o, lse, do, causal=causal)
    for name, a, b in zip("qkv", got, want, strict=True):
        assert a.shape == b.shape and a.dtype == dt
        assert torch.isfinite(a).all(), name
        rel = _rel_l2(a, b)
        assert rel <= BWD_REL[dtype], (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_gradient_through_autograd_matches_the_plain_path_on_card(
        cuda_device, dtype):
    """flash_attention_cuda under autograd (forward with lse, backward
    kernel) against autograd of attention_ref: one launch of each, the
    gradients within BWD_REL."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    dt = TORCH_DT[dtype]
    q, k, v = (torch.randn(2, 333, n, 64, generator=g, device=cuda_device)
               .to(dt).requires_grad_() for n in (8, 2, 2))
    do = torch.randn(2, 333, 8, 64, generator=g, device=cuda_device).to(dt)
    before = (K3.launches(), K3.backward_launches())
    got = torch.autograd.grad(K3.flash_attention_cuda(q, k, v), (q, k, v), do)
    assert (K3.launches(), K3.backward_launches()) == (before[0] + 1,
                                                       before[1] + 1)
    want = torch.autograd.grad(K3.attention_ref(q, k, v), (q, k, v), do)
    for a, b in zip(got, want, strict=True):
        assert _rel_l2(a, b) <= BWD_REL[dtype]
