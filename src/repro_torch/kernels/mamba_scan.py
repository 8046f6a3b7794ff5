"""Mamba-1 selective scan: kernel K4 of the port, with its plain PyTorch
version.

    h_t = exp(delta_t * A) * h_{t-1} + (delta_t * x_t) * B_t,   h_0 = 0
    y_t = C_t . h_t + D * x_t

``x``, ``delta`` (B, L, Di); ``A`` (Di, N); ``B_t``, ``C_t`` (B, L, N);
``D`` (Di,).  Both return ``(y, h_final)``: ``y`` (B, L, Di) in ``x``'s
dtype and the state after the last step, ``h_final`` (B, Di, N) in f32.

* :func:`mamba_scan_ref`  — plain PyTorch, the time recurrence step by step
  in f32 as the Pallas body runs it, any device: the version the kernel is
  held against on the card;
* :func:`mamba_scan_cuda` — the wrapper of kernel K4 (``csrc/mamba_scan.cu``),
  the Hopper port of the reference's Pallas ``mamba_scan``
  (``src/repro/kernels/mamba_scan/kernel.py``), which also returns
  ``h_final`` for the decode cache.  It takes CUDA tensors only: it launches
  the kernel or raises, and never falls back.  Its gradient is that of
  :func:`mamba_scan_ref` at the same inputs (:mod:`.grad`): a stop-gap whose
  backward runs the plain L-step loop and keeps every step's (B, Di, N)
  state, until LM training gets a backward kernel.  Under
  ``torch.no_grad()`` it is one launch and saves nothing.  The launch goes
  through the dispatcher operator :func:`mamba_scan_op`
  (``repro_torch::mamba_scan``), whose fake implementation lets the dry run
  trace the card's program.

The model's Mamba prefill (``repro_torch.models.mamba``) routes a CUDA tensor
here and a CPU tensor to ``selective_scan_chunked``.  :func:`launches`
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import grad as G

__all__ = ["mamba_scan_ref", "mamba_scan_cuda", "mamba_scan_op",
           "selective_scan", "launches", "reset_launches", "MAX_STATE"]

#: the kernel keeps a channel's states in registers: at most this many
MAX_STATE = 16

_LAUNCHES = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}


def launches() -> int:
    """Kernel launches made by :func:`mamba_scan_cuda` since the last reset."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def mamba_scan_ref(x, delta, A, B_t, C_t, D
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: the recurrence one step at a time, in f32 (f64 for
    f64 inputs)."""
    Bb, L, Di = x.shape
    ct = G.compute_dtype(x)
    xf, df = x.to(ct), delta.to(ct)
    Af, bf, cf, Df = (t.to(ct) for t in (A, B_t, C_t, D))
    h = torch.zeros(Bb, Di, A.shape[1], dtype=ct, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(df[:, t, :, None] * Af)                      # (B, Di, N)
        b = (df[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        h = a * h + b
        ys.append((h * cf[:, t, None, :]).sum(-1) + Df * xf[:, t])
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros(Bb, 0, Di, dtype=ct, device=x.device))
    return y.to(x.dtype), h


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K4's library, built on first use, with its C signatures declared."""
    from . import build

    lib = build.load("mamba_scan")
    lib.mamba_scan_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.mamba_scan_launch.restype = ctypes.c_int
    lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
    lib.mamba_scan_error_string.restype = ctypes.c_char_p
    return lib


def mamba_scan_cuda(x, delta, A, B_t, C_t, D
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4 on the card (same result as :func:`mamba_scan_ref`).

    ``x``, ``delta``, ``B_t``, ``C_t`` float32 or bfloat16, one dtype, on one
    CUDA device; ``A`` and ``D`` are cast to f32 (they are f32 in the
    model).  ``N`` at most :data:`MAX_STATE`.  Raises on any other input and
    when the launch reports an error."""
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan_cuda needs CUDA tensors, got x on "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"mamba_scan_cuda: dtype {x.dtype} not supported "
                         "(float32, bfloat16)")
    if x.dim() != 3 or delta.shape != x.shape:
        raise ValueError("mamba_scan_cuda: x and delta must both be "
                         f"(B, L, Di); got {tuple(x.shape)}, "
                         f"{tuple(delta.shape)}")
    Bb, L, Di = x.shape
    if A.dim() != 2 or A.shape[0] != Di:
        raise ValueError(f"mamba_scan_cuda: A must be (Di, N) = ({Di}, N); "
                         f"got {tuple(A.shape)}")
    N = int(A.shape[1])
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"mamba_scan_cuda: N = {N} outside 1..{MAX_STATE}")
    for name, t, shape in (("B_t", B_t, (Bb, L, N)), ("C_t", C_t, (Bb, L, N)),
                           ("D", D, (Di,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan_cuda: {name} must be {shape}; got "
                             f"{tuple(t.shape)}")
    for name, t in (("delta", delta), ("B_t", B_t), ("C_t", C_t), ("A", A),
                    ("D", D)):
        if t.device != x.device:
            raise ValueError(f"mamba_scan_cuda: {name} is on {t.device}, "
                             f"x on {x.device}")
    for name, t in (("delta", delta), ("B_t", B_t), ("C_t", C_t)):
        if t.dtype != x.dtype:
            raise ValueError(f"mamba_scan_cuda: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    return _differentiable(mamba_scan_op, x, delta, A, B_t, C_t, D)


def selective_scan(x, delta, A, B_t, C_t, D, use_kernel: bool = True,
                   chunk: int = 64, interpret: Optional[bool] = None
                   ) -> torch.Tensor:
    """The reference's entry point (``kernels/mamba_scan/ops.py``): ``y``
    (B, L, Di) only.  K4 for CUDA tensors with ``use_kernel``, else
    :func:`mamba_scan_ref`; ``chunk`` (the Pallas body's time tile) and
    ``interpret`` are unused (K4 picks its own tiles)."""
    del chunk, interpret
    if use_kernel and x.device.type == "cuda":
        return mamba_scan_cuda(x, delta, A, B_t, C_t, D)[0]
    return mamba_scan_ref(x, delta, A, B_t, C_t, D)[0]


def _differentiable(launch, x, delta, A, B_t, C_t, D):
    """``launch(x, delta, A, B_t, C_t, D)`` with :func:`mamba_scan_ref`'s
    gradient when autograd records the call (:func:`.grad.through_kernel`)."""
    return G.through_kernel(launch, mamba_scan_ref, (x, delta, A, B_t, C_t, D))


def _mamba_scan_fake(x, delta, A, B_t, C_t, D):
    Bb, L, Di = x.shape
    return (x.new_empty((Bb, L, Di)),
            x.new_empty((Bb, Di, A.shape[1]), dtype=torch.float32))


def _launch(x, delta, A, B_t, C_t, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K4 on inputs :func:`mamba_scan_cuda` has checked."""
    global _LAUNCHES
    Bb, L, Di = x.shape
    N = int(A.shape[1])
    if Bb == 0 or Di == 0 or L == 0:
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                torch.zeros(Bb, Di, N, dtype=torch.float32, device=x.device))
    xc, dc = x.contiguous(), delta.contiguous()
    bc, cc = B_t.contiguous(), C_t.contiguous()
    Ac = A.float().contiguous()
    Dc = D.float().contiguous()
    # the kernel copies rows of x and dt in pieces of 16, 8 or 4 bytes: an
    # odd bf16 Di, which must be copied, is padded to a 16-byte row with
    # zero channels (A and D zero there too), sliced off again below, and
    # data that starts off 4 bytes is copied
    pad = -Di % 8 if x.dtype == torch.bfloat16 and Di % 2 else 0
    if pad:
        xc, dc = F.pad(xc, (0, pad)), F.pad(dc, (0, pad))
        Ac, Dc = F.pad(Ac, (0, 0, 0, pad)), F.pad(Dc, (0, pad))
    xc, dc = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (xc, dc))
    y = torch.empty_like(xc)
    h = torch.empty(Bb, Di + pad, N, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _LAUNCHES += 1
        rc = lib.mamba_scan_launch(
            _DTYPE_CODE[x.dtype], xc.data_ptr(), dc.data_ptr(), Ac.data_ptr(),
            bc.data_ptr(), cc.data_ptr(), Dc.data_ptr(), y.data_ptr(),
            h.data_ptr(), Bb, L, Di + pad, N, stream)
    if rc != 0:
        raise RuntimeError("mamba_scan_cuda: kernel launch failed: "
                           + lib.mamba_scan_error_string(rc).decode())
    if pad:
        return y[..., :Di].contiguous(), h[:, :Di].contiguous()
    return y, h


#: K4 as an operator of PyTorch's dispatcher (``repro_torch::mamba_scan``):
#: its CUDA implementation is :func:`_launch`, and it has no other
#: device's; its fake implementation gives ``y`` and ``h_final``'s shapes
#: and dtypes (the dry run traces it so).  No FLOP formula: the reference's
#: count has none for the scan.
mamba_scan_op = G.kernel_op(
    "mamba_scan(Tensor x, Tensor delta, Tensor A, Tensor B_t, Tensor C_t, "
    "Tensor D) -> (Tensor, Tensor)", _launch, _mamba_scan_fake)
