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
  only: it launches the kernel or raises, and never falls back.  Its
  gradient is that of :func:`attention_ref` at the same inputs
  (:mod:`.grad`): a stop-gap whose backward builds the O(S^2) plain scores,
  until LM training gets a backward kernel.  Under ``torch.no_grad()`` it
  is one launch and saves nothing.  The launch goes through the dispatcher
  operator :func:`flash_attention_op` (``repro_torch::flash_attention``),
  whose fake implementation and FLOP formula (:func:`flops`) let the dry
  run trace and count the card's program.

The model's prefill attention (``repro_torch.models.transformer``) routes a
CUDA tensor of a layer without a window or query offset here, and every
other layer, and any CPU tensor, to ``models.attention.chunked_attention``.
:func:`launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import grad as G

__all__ = ["attention_ref", "flash_attention_cuda", "flash_attention_op",
           "gqa_flash_attention", "launches", "reset_launches", "flops",
           "FLOP_BLOCK"]

_LAUNCHES = 0
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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Plain PyTorch attention: softmax(q k^T / sqrt(hd)) v in f32 (f64 for
    f64 inputs)."""
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    ct = G.compute_dtype(q)
    qg = q.to(ct).reshape(B, Sq, Kv, H // Kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct)) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(ct))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K3's library, built on first use, with its C signatures declared."""
    from . import build

    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
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
    return _differentiable(flash_attention_op, q, k, v, causal)


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


def _differentiable(launch, q, k, v, causal):
    """``launch(q, k, v, causal=causal)`` with :func:`attention_ref`'s
    gradient when autograd records the call (:func:`.grad.through_kernel`)."""
    return G.through_kernel(launch, attention_ref, (q, k, v), causal=causal)


def flops(B: int, Sq: int, Sk: int, H: int, hd: int, causal: bool) -> int:
    """The two products' FLOPs (q k^T and p v, 2 hd each per (query, key)
    pair) over the pairs the kernel computes: for each FLOP_BLOCK-row query
    block, the key blocks up to its last row when causal (every key block
    otherwise), the ragged edges at their true sizes."""
    bs = FLOP_BLOCK
    pairs = 0
    for q0 in range(0, Sq, bs):
        rows = min(bs, Sq - q0)
        keys = min(Sk, ((q0 + bs - 1) // bs + 1) * bs) if causal else Sk
        pairs += rows * keys
    return 4 * B * H * hd * pairs


def _flash_attention_fake(q, k, v, causal):
    return q.new_empty(q.shape)


def _flash_attention_flops(q_shape, k_shape, v_shape, causal=True, *args,
                           out_shape=None, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return flops(B, Sq, k_shape[1], H, hd, bool(causal))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool) -> torch.Tensor:
    """One launch of K3 on inputs :func:`flash_attention_cuda` has checked."""
    global _LAUNCHES
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    # the kernel reads 16-byte rows (TMA, cp.async): pad the head width to a
    # multiple of 8 (bf16) or 4 (f32) with zero columns, which change no
    # product, and slice the output back
    width = -(-hd // _ROW_ELEMS[q.dtype]) * _ROW_ELEMS[q.dtype]
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    qc, kc, vc = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(qc)
    if o.numel() == 0:
        return o[..., :hd]
    if Sk == 0:
        raise ValueError("flash_attention_cuda: no keys (Sk == 0)")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _LAUNCHES += 1
        rc = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            o.data_ptr(), B, Sq, Sk, H, Kv, width, int(bool(causal)),
            1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError("flash_attention_cuda: kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    return o if width == hd else o[..., :hd].contiguous()


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


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula(torch.ops.repro_torch.flash_attention)(
        _flash_attention_flops)


_register_flop_formula()
