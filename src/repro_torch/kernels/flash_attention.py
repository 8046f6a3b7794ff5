"""Causal / non-causal flash attention: kernel K3 of the port, with its plain
PyTorch version.

Both take the model's layout: ``q`` (B, Sq, H, hd), ``k`` and ``v``
(B, Sk, Kv, hd) with ``H % Kv == 0`` (GQA: query head h reads kv head
h // (H // Kv)), and return (B, Sq, H, hd) in ``q``'s dtype.  The causal
mask is aligned at position 0 of both (``q_pos >= k_pos``), as the
reference's Pallas kernel and its ``attention_ref`` do.

* :func:`attention_ref`        — plain PyTorch softmax attention in f32, any
  device: the CPU path's oracle, and the version the kernel is held against
  on the card;
* :func:`flash_attention_cuda` — the wrapper of kernel K3
  (``csrc/flash_attention.cu``), the Hopper port of the reference's Pallas
  ``flash_attention`` (``src/repro/kernels/flash_attention/kernel.py``) with
  its ``ops.gqa_flash_attention`` layout adaptation.  It takes CUDA tensors
  only: it launches the kernel or raises, and never falls back.  Under
  ``torch.no_grad()`` (or with no input that requires grad) it is one
  launch that writes O alone and saves nothing.  When autograd records
  the call it goes through :class:`FlashAttentionFunction`: the forward
  launch also writes each row's log-sum-exp ``lse`` (B, H, Sq) in f32,
  and the backward is the hand-written backward kernel
  (``csrc/flash_attention_bwd.cu``), which recomputes each live tile's
  scores from ``lse`` and keeps no (S, S) tensor, as the reference's
  ``jax.checkpoint``-ed chunked attention does.  The launches go through
  the dispatcher operators :data:`flash_attention_op`,
  :data:`flash_attention_lse_op` and :data:`flash_attention_backward_op`
  (``repro_torch::flash_attention*``), whose fake implementations and FLOP
  formulas (:func:`flops`, :func:`backward_flops`) let the dry run trace
  and count the card's program;
* :func:`attention_lse_ref` and :func:`attention_backward_ref` — the
  plain versions of the forward with ``lse`` and of the backward; the
  latter recomputes (query block, key block) tiles as the reference's
  backward does, never an (S, S) tensor.

The model's prefill attention (``repro_torch.models.transformer``) routes a
CUDA tensor of a layer without a window or query offset here, and every
other layer, and any CPU tensor, to ``models.attention.chunked_attention``.
:func:`launches` counts the forward kernel's launches,
:func:`backward_launches` the backward's.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from . import grad as G

__all__ = ["attention_ref", "attention_lse_ref", "attention_backward_ref",
           "flash_attention_cuda", "flash_attention_op",
           "flash_attention_lse_op", "flash_attention_backward_op",
           "FlashAttentionFunction", "gqa_flash_attention", "launches",
           "reset_launches", "backward_launches", "reset_backward_launches",
           "flops", "backward_flops", "FLOP_BLOCK", "BACKWARD_RANGE"]

_LAUNCHES = 0
_BACKWARD_LAUNCHES = 0
#: the profiler range around each backward launch
BACKWARD_RANGE = "repro_torch/kernel_backward/flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
#: elements in 16 bytes: the kernel's head width is a multiple of this
_ROW_ELEMS = {torch.float32: 4, torch.bfloat16: 8}
#: the square block of (query, key) pairs by which the FLOP count skips
#: causal work, as the kernel's bf16 path skips key tiles past a 128-row
#: query tile
FLOP_BLOCK = 128


def launches() -> int:
    """Kernel launches made by :func:`flash_attention_cuda` since the last
    reset."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def backward_launches() -> int:
    """Launches of the backward kernel since the last reset."""
    return _BACKWARD_LAUNCHES


def reset_backward_launches() -> None:
    global _BACKWARD_LAUNCHES
    _BACKWARD_LAUNCHES = 0


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Plain PyTorch attention: softmax(q k^T / sqrt(hd)) v in f32 (f64 for
    f64 inputs)."""
    return attention_lse_ref(q, k, v, causal=causal)[0]


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True) -> tuple:
    """:func:`attention_ref`'s output and each row's log-sum-exp of its
    scaled, masked scores, (B, H, Sq) in the plain versions' type: the
    forward launch's two outputs."""
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    ct = G.compute_dtype(q)
    qg = q.to(ct).reshape(B, Sq, Kv, H // Kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct)) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(ct))
    return (o.reshape(B, Sq, H, hd).to(q.dtype),
            lse.reshape(B, H, Sq))


def attention_backward_ref(q, k, v, o, lse, do, *, causal: bool = True,
                           block: int = FLOP_BLOCK) -> tuple:
    """(dq, dk, dv) of softmax attention at the saved forward (``o`` and
    its row log-sum-exp ``lse`` (B, H, Sq)), recomputed tile by tile as the
    reference's ``jax.checkpoint``-ed chunked attention recomputes it: for
    each ``block``-row query block, the key blocks up to its last row when
    causal; no tensor of (S, S) elements.  P is rounded to v's dtype before
    dV = P^T dO, as the forward rounds it; the rest is in the plain
    versions' type.  Returns tensors in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    Gq = H // Kv
    ct = G.compute_dtype(q)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(ct).reshape(B, Sq, Kv, Gq, hd)
    dof = do.to(ct).reshape(B, Sq, Kv, Gq, hd)
    kf, vf = k.to(ct), v.to(ct)
    delta = (dof * o.to(ct).reshape(B, Sq, Kv, Gq, hd)).sum(-1)
    lse_ = lse.to(ct).reshape(B, Kv, Gq, Sq).permute(0, 3, 1, 2)
    dq = torch.zeros_like(qf)
    dk = torch.zeros(B, Sk, Kv, hd, dtype=ct, device=dev)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, block):
        q1 = min(q0 + block, Sq)
        k_end = min(Sk, q1) if causal else Sk
        q_pos = torch.arange(q0, q1, device=dev)
        for k0 in range(0, k_end, block):
            k1 = min(k0 + block, k_end)
            s = torch.einsum("bqkgd,bskd->bqkgs", qf[:, q0:q1],
                             kf[:, k0:k1]) * scale
            p = torch.exp(s - lse_[:, q0:q1, :, :, None])
            if causal:
                mask = q_pos[:, None] >= torch.arange(k0, k1,
                                                      device=dev)[None, :]
                p = p.masked_fill(~mask[None, :, None, None, :], 0.0)
            dv[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd",
                                         p.to(v.dtype).to(ct), dof[:, q0:q1])
            dp = torch.einsum("bqkgd,bskd->bqkgs", dof[:, q0:q1],
                              vf[:, k0:k1])
            ds = p * (dp - delta[:, q0:q1, :, :, None])
            dq[:, q0:q1] += torch.einsum("bqkgs,bskd->bqkgd", ds,
                                         kf[:, k0:k1]) * scale
            dk[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd", ds,
                                         qf[:, q0:q1]) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K3's library, built on first use, with its C signatures declared."""
    from . import build

    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _backward_library() -> ctypes.CDLL:
    """The backward kernel's library, built on first use."""
    from . import build

    lib = build.load("flash_attention_bwd")
    lib.flash_attention_backward_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_backward_launch.restype = ctypes.c_int
    lib.flash_attention_backward_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_backward_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Kernel K3 on the card (same result as :func:`attention_ref`).

    ``q``, ``k``, ``v`` float32 or bfloat16, one dtype, on one CUDA device,
    in the layout above.  float32 takes head widths up to 128, bfloat16 up
    to 256 (the kernel compiles widths 64, 128 and 256 and zero-fills
    narrower heads; a width that is no multiple of 16 bytes is padded here).
    Raises on any other input and when the launch reports an error."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got q on "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not "
                         "supported (float32, bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_cuda: {name} is {t.dtype} on "
                             f"{t.device}; q is {q.dtype} on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda: q (B, Sq, H, hd), k and v "
                         f"(B, Sk, Kv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kv == 0 or H % Kv:
        raise ValueError("flash_attention_cuda: k, v must be (B, Sk, Kv, hd) "
                         f"with H % Kv == 0; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    limit = 128 if q.dtype == torch.float32 else 256
    if hd > limit:
        raise ValueError(f"flash_attention_cuda: head width {hd} > {limit} "
                         f"for {q.dtype}")
    return _differentiable(_kernel_forward, _kernel_backward, q, k, v,
                           causal)


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, use_kernel: bool = True,
                        interpret: Optional[bool] = None) -> torch.Tensor:
    """The reference's entry point (``kernels/flash_attention/ops.py``):
    q (B, S, H, hd); k, v (B, S, Kv, hd) -> (B, S, H, hd).  K3 for CUDA
    tensors with ``use_kernel`` (the kernel reads GQA heads in place, so the
    reference's repeat of k and v is not needed), else
    :func:`attention_ref`; ``interpret`` is unused (no interpret mode)."""
    del interpret
    if use_kernel and q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    return attention_ref(q, k, v, causal=causal)


class FlashAttentionFunction(torch.autograd.Function):
    """forward: ``o, lse = forward(q, k, v, causal)``, saving q, k, v, o and
    lse; backward: ``backward(q, k, v, o, lse, do, causal)`` -> (dq, dk,
    dv), inside the profiler range :data:`BACKWARD_RANGE`.  On the card the
    two are K3's forward with ``lse`` and the backward kernel; the CPU
    tests give it the plain versions."""

    @staticmethod
    def forward(ctx, forward, backward, causal, q, k, v):
        o, lse = forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.backward_fn, ctx.causal = backward, causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE):
            dq, dk, dv = ctx.backward_fn(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        need = ctx.needs_input_grad[3:]
        return (None, None, None, *(g if n else None
                                    for g, n in zip((dq, dk, dv), need)))


def _differentiable(forward, backward, q, k, v, causal):
    """Attention through :class:`FlashAttentionFunction` when autograd
    records the call; otherwise ``forward``'s O alone, which on the card is
    one launch of K3 without ``lse`` (serving under ``torch.no_grad()``
    pays nothing for it).  On the card ``forward`` / ``backward`` are the
    kernels' operators; the CPU tests pass :func:`attention_lse_ref` /
    :func:`attention_backward_ref` through the same seam."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(forward, backward, bool(causal),
                                            q, k, v)
    if forward is _kernel_forward:
        return flash_attention_op(q, k, v, causal)
    return forward(q, k, v, causal)[0]


def _pairs(Sq: int, Sk: int, causal: bool) -> int:
    """The (query, key) pairs the kernels compute: for each FLOP_BLOCK-row
    query block, the key blocks up to its last row when causal (every key
    block otherwise), the ragged edges at their true sizes."""
    bs = FLOP_BLOCK
    pairs = 0
    for q0 in range(0, Sq, bs):
        rows = min(bs, Sq - q0)
        keys = min(Sk, ((q0 + bs - 1) // bs + 1) * bs) if causal else Sk
        pairs += rows * keys
    return pairs


def flops(B: int, Sq: int, Sk: int, H: int, hd: int, causal: bool) -> int:
    """The forward's two products' FLOPs (q k^T and p v, 2 hd each per
    (query, key) pair) over the pairs of :func:`_pairs`."""
    return 4 * B * H * hd * _pairs(Sq, Sk, causal)


def backward_flops(B: int, Sq: int, Sk: int, H: int, hd: int,
                   causal: bool) -> int:
    """The backward's five products' FLOPs (q k^T recomputed, dO v^T,
    P^T dO, dS^T q, dS k: 2 hd each, 10 hd per (query, key) pair) over the
    same pairs as :func:`flops`."""
    return 10 * B * H * hd * _pairs(Sq, Sk, causal)


def _flash_attention_fake(q, k, v, causal):
    return q.new_empty(q.shape)


def _flash_attention_lse_fake(q, k, v, causal):
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


def _flash_attention_backward_fake(q, k, v, o, lse, do, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_attention_flops(q_shape, k_shape, v_shape, causal=True, *args,
                           out_shape=None, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return flops(B, Sq, k_shape[1], H, hd, bool(causal))


def _flash_attention_backward_flops(q_shape, k_shape, v_shape, o_shape,
                                    lse_shape, do_shape, causal=True, *args,
                                    out_shape=None, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return backward_flops(B, Sq, k_shape[1], H, hd, bool(causal))


def _padded_width(q: torch.Tensor) -> int:
    """The head width padded to whole 16-byte rows (TMA and cp.async read
    16-byte rows): a multiple of 8 (bf16) or 4 (f32)."""
    hd, n = q.shape[-1], _ROW_ELEMS[q.dtype]
    return -(-hd // n) * n


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, with_lse: bool = False):
    """One launch of K3 on inputs :func:`flash_attention_cuda` has checked:
    O, or (O, lse) with ``with_lse``."""
    global _LAUNCHES
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    # zero columns up to the padded width change no product; the output is
    # sliced back
    width = _padded_width(q)
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    qc, kc, vc = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(qc)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return (o[..., :hd], lse) if with_lse else o[..., :hd]
    if Sk == 0:
        raise ValueError("flash_attention_cuda: no keys (Sk == 0)")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _LAUNCHES += 1
        rc = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            o.data_ptr(), lse.data_ptr() if with_lse else None, B, Sq, Sk, H,
            Kv, width, int(bool(causal)), 1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError("flash_attention_cuda: kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    o = o if width == hd else o[..., :hd].contiguous()
    return (o, lse) if with_lse else o


def _launch_backward(q, k, v, o, lse, do, causal: bool) -> tuple:
    """One launch of the backward kernel (its three grids) on the saved
    forward: (dq, dk, dv) in the inputs' dtype."""
    global _BACKWARD_LAUNCHES
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    width = _padded_width(q)
    if width != hd:
        q, k, v, o, do = (F.pad(t, (0, width - hd))
                          for t in (q, k, v, o, do))
    qc, kc, vc, oc, doc = (_aligned(t) for t in (q, k, v, o, do))
    lc = _aligned(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (qc, kc, vc))
    if q.numel() and Sk:
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        # each query head's f32 share of dk and dv, summed by the kernel
        share = (torch.empty((2, H // Kv, B, Sk, Kv, width),
                             dtype=torch.float32, device=q.device)
                 if H > Kv else None)
        lib = _backward_library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _BACKWARD_LAUNCHES += 1
            rc = lib.flash_attention_backward_launch(
                _DTYPE_CODE[q.dtype], qc.data_ptr(), kc.data_ptr(),
                vc.data_ptr(), oc.data_ptr(), lc.data_ptr(), doc.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                delta.data_ptr(), None if share is None else share.data_ptr(),
                B, Sq, Sk, H, Kv, width,
                int(bool(causal)), 1.0 / math.sqrt(hd), stream)
        if rc != 0:
            raise RuntimeError(
                "flash_attention backward: kernel launch failed: "
                + lib.flash_attention_backward_error_string(rc).decode())
    if width != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied if its data does not start on 16 bytes."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


#: K3 as an operator of PyTorch's dispatcher
#: (``repro_torch::flash_attention``): its CUDA implementation is
#: :func:`_launch`, and it has no other device's.  Its fake implementation
#: gives the output's shape and dtype and its FLOP formula is
#: :func:`flops`, so that the dry run (:mod:`repro_torch.launch.dryrun`)
#: traces and counts the card's program.
flash_attention_op = G.kernel_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
    lambda q, k, v, causal: _launch(q, k, v, causal=causal),
    _flash_attention_fake)

#: K3's forward writing the row log-sum-exp beside O, for training
#: (``repro_torch::flash_attention_lse``): (O, lse (B, H, Sq) f32)
flash_attention_lse_op = G.kernel_op(
    "flash_attention_lse(Tensor q, Tensor k, Tensor v, bool causal) "
    "-> (Tensor, Tensor)",
    lambda q, k, v, causal: _launch(q, k, v, causal=causal, with_lse=True),
    _flash_attention_lse_fake)

#: the backward kernel (``repro_torch::flash_attention_backward``):
#: (dq, dk, dv) from q, k, v, O, lse and dO
flash_attention_backward_op = G.kernel_op(
    "flash_attention_backward(Tensor q, Tensor k, Tensor v, Tensor o, "
    "Tensor lse, Tensor do, bool causal) -> (Tensor, Tensor, Tensor)",
    _launch_backward, _flash_attention_backward_fake)


def _kernel_forward(q, k, v, causal):
    return flash_attention_lse_op(q, k, v, causal)


def _kernel_backward(q, k, v, o, lse, do, causal):
    return flash_attention_backward_op(q, k, v, o, lse, do, causal)


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula(torch.ops.repro_torch.flash_attention)(
        _flash_attention_flops)
    register_flop_formula(torch.ops.repro_torch.flash_attention_lse)(
        _flash_attention_flops)
    register_flop_formula(torch.ops.repro_torch.flash_attention_backward)(
        _flash_attention_backward_flops)


_register_flop_formula()
