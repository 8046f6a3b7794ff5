"""Fused RMSNorm: kernel K5 of the port, with its plain PyTorch version.

    y = x * rsqrt(mean(x**2, axis=-1) + eps) * w        over rows of (..., D)

computed in float32 and returned in ``x``'s dtype.

* :func:`rmsnorm_ref`  — plain PyTorch, any device: the CPU path, and the
  version the kernel is held against on the card;
* :func:`rmsnorm_cuda` — the wrapper of kernel K5 (``csrc/rmsnorm.cu``), the
  Hopper port of the reference's Pallas ``rmsnorm``
  (``src/repro/kernels/rmsnorm/kernel.py``).  It takes CUDA tensors only: it
  launches the kernel or raises, and never falls back.  Its gradient is that
  of :func:`rmsnorm_ref` at the same inputs (:mod:`.grad`), a stop-gap until
  LM training gets a backward kernel; under ``torch.no_grad()`` it is one
  launch and saves nothing.  The launch goes through the dispatcher
  operator :func:`rmsnorm_op` (``repro_torch::rmsnorm``), whose fake
  implementation lets ``FakeTensorMode`` trace the card's program
  (:mod:`repro_torch.launch.dryrun`).

``repro_torch.models.layers.rms_norm`` routes between the two by device:
a CUDA tensor always goes to the kernel.  :func:`launches` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import grad as G

__all__ = ["rmsnorm_ref", "rmsnorm_cuda", "rmsnorm_op", "fused_rmsnorm",
           "block_design_cuda", "launches", "reset_launches"]

_LAUNCHES = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}


def launches() -> int:
    """Kernel launches made by :func:`rmsnorm_cuda` since the last reset."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """Plain PyTorch RMSNorm over the last axis, in float32 (float64 for
    float64 inputs)."""
    ct = G.compute_dtype(x)
    xf = x.to(ct)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(ct)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K5's library, built on first use, with its C signatures declared."""
    from . import build

    lib = build.load("rmsnorm")
    lib.rmsnorm_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    lib.rmsnorm_launch_block.argtypes = lib.rmsnorm_launch.argtypes
    lib.rmsnorm_launch_block.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                 ) -> torch.Tensor:
    """Kernel K5 on the card (same result as :func:`rmsnorm_ref`).

    ``x`` (..., D) float32 or bfloat16 on a CUDA device; ``w`` (D,) on the
    same device in the same dtype (every config keeps its norms in its
    compute dtype).  Raises on any other input and when the launch reports
    an error."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors, got x on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm_cuda: x dtype {x.dtype} not supported "
                         "(float32, bfloat16)")
    if x.dim() < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm_cuda: w has shape {tuple(w.shape)}; "
                         f"expected ({x.shape[-1] if x.dim() else '?'},)")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"rmsnorm_cuda: w is {w.dtype} on {w.device}; x is "
                         f"{x.dtype} on {x.device}")
    return _differentiable(rmsnorm_op, x, w, eps)


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                  use_kernel: bool = True, interpret: Optional[bool] = None
                  ) -> torch.Tensor:
    """The reference's entry point (``kernels/rmsnorm/ops.py``): K5 for
    CUDA tensors with ``use_kernel``, else :func:`rmsnorm_ref`;
    ``interpret`` is unused (no interpret mode)."""
    del interpret
    if use_kernel and x.device.type == "cuda":
        return rmsnorm_cuda(x, w, eps)
    return rmsnorm_ref(x, w, eps)


def _differentiable(launch, x, w, eps):
    """``launch(x, w, eps=eps)`` with :func:`rmsnorm_ref`'s gradient when
    autograd records the call (:func:`.grad.through_kernel`)."""
    return G.through_kernel(launch, rmsnorm_ref, (x, w), eps=eps)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """One launch of K5 on inputs :func:`rmsnorm_cuda` has checked."""
    global _LAUNCHES
    D = int(x.shape[-1])
    rows = x.numel() // D if D else 0
    xc = x.contiguous()
    wc = w.contiguous()
    y = torch.empty_like(xc)
    if rows == 0 or D == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _LAUNCHES += 1
        rc = lib.rmsnorm_launch(_DTYPE_CODE[x.dtype], xc.data_ptr(),
                                wc.data_ptr(), y.data_ptr(), rows, D,
                                float(eps), stream)
    if rc != 0:
        raise RuntimeError("rmsnorm_cuda: kernel launch failed: "
                           + lib.rmsnorm_error_string(rc).decode())
    return y


def block_design_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                      ) -> torch.Tensor:
    """K5's first design (a warp or a block a row, the row read twice),
    launched alone on the inputs :func:`rmsnorm_cuda` takes, so that it can
    be timed beside the redesign on the same tensors (``chip_smoke.py``,
    the card tests).  On no path of the model; it counts no launch."""
    xc, wc = x.contiguous(), w.contiguous()
    y = torch.empty_like(xc)
    D = int(x.shape[-1])
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_launch_block(
            _DTYPE_CODE[x.dtype], xc.data_ptr(), wc.data_ptr(), y.data_ptr(),
            rows, D, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("rmsnorm block design: kernel launch failed: "
                           + lib.rmsnorm_error_string(rc).decode())
    return y


def _rmsnorm_fake(x, w, eps):
    return x.new_empty(x.shape)


#: K5 as an operator of PyTorch's dispatcher (``repro_torch::rmsnorm``):
#: its CUDA implementation is :func:`_launch`, and it has no other
#: device's; its fake implementation gives the output's shape and dtype
#: (the dry run traces it so).  No FLOP formula: the reference's count has
#: none for a norm.
rmsnorm_op = G.kernel_op("rmsnorm(Tensor x, Tensor w, float eps) -> Tensor",
                         _launch, _rmsnorm_fake)
