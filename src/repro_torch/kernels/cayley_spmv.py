"""Cayley-graph adjacency matvec: kernel K2 of the port, with its plain
PyTorch version and the Lanczos matvec factory.

    y[i] = sum_j x[table[i, j]] + loops[i] * x[i]

unsigned, accumulated in float32 for float32 and bfloat16 inputs, returned in
``x``'s dtype; any other dtype raises.  ``x`` is (n,) or a batch (B, n) over
the one (n, k) table (the port's Lanczos hands its matvec a (1, n) tensor).

* :func:`cayley_spmv_ref`  — plain PyTorch, any device: the CPU path, and the
  version the kernel is held against on the card;
* :func:`cayley_spmv_cuda` — the wrapper of kernel K2
  (``csrc/cayley_spmv.cu``), the Hopper port of the reference's Pallas
  ``cayley_spmv`` (``src/repro/kernels/cayley_spmv/kernel.py``).  It takes
  CUDA tensors only: it launches the kernel or raises, and never falls back;
* :func:`cayley_spmv`      — picks one of the two by the tensor's device;
* :func:`adjacency_matvec` / :func:`kernel_matvec` — the reference's
  ``ops`` entry points: one product, and the drop-in ``matvec=`` operator of
  :func:`repro_torch.core.spectral.rho2_lanczos`.

K2 and K1 (:mod:`repro_torch.kernels.spmv`) share the gather-table contract
but not the accumulation contract (K1 sums float64 inputs in float64; K2
takes float32 and bfloat16 only), so K2 is its own kernel.
:func:`launches` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["cayley_spmv_ref", "cayley_spmv_cuda", "cayley_spmv",
           "adjacency_matvec", "kernel_matvec", "launches", "reset_launches"]

_LAUNCHES = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}


def launches() -> int:
    """Kernel launches made by :func:`cayley_spmv_cuda` since the last reset."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def _check_dtype(x: torch.Tensor, who: str) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{who}: x dtype {x.dtype} not supported "
                         "(float32, bfloat16)")


def cayley_spmv_ref(x: torch.Tensor, table: torch.Tensor,
                    loops: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch: ``sum_j x[table[i,j]] + loops[i]*x[i]`` in float32,
    returned in ``x``'s dtype — the arithmetic of the kernel."""
    _check_dtype(x, "cayley_spmv_ref")
    xa = x.float()
    y = xa[..., table.long()].sum(dim=-1)      # (n, k) or (B, n, k) gather
    if loops is not None:
        y = y + loops.float() * xa
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K2's library, built on first use, with its C signatures declared."""
    from . import build

    lib = build.load("cayley_spmv")
    lib.cayley_spmv_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.cayley_spmv_launch.restype = ctypes.c_int
    lib.cayley_spmv_error_string.argtypes = [ctypes.c_int]
    lib.cayley_spmv_error_string.restype = ctypes.c_char_p
    return lib


def cayley_spmv_cuda(x: torch.Tensor, table: torch.Tensor,
                     loops: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K2 on the card (same result as :func:`cayley_spmv_ref`).

    ``x``: contiguous (n,) or (B, n) CUDA tensor, float32 or bfloat16;
    ``table``: (n, k) int32 on the same device, entries in ``[0, n)``
    (:func:`kernel_matvec` checks that once on the host); ``loops``: (n,),
    cast to float32 as the Pallas body casts it.  Raises on any other input
    and when the launch reports an error."""
    global _LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"cayley_spmv_cuda needs CUDA tensors, got x on "
                         f"{x.device}")
    _check_dtype(x, "cayley_spmv_cuda")
    if x.dim() not in (1, 2) or not x.is_contiguous():
        raise ValueError("cayley_spmv_cuda: x must be a contiguous (n,) or "
                         f"(B, n) tensor, got shape {tuple(x.shape)}")
    n = int(x.shape[-1])
    B = int(x.shape[0]) if x.dim() == 2 else 1
    if table.dim() != 2 or table.shape[0] != n:
        raise ValueError(f"cayley_spmv_cuda: table has shape "
                         f"{tuple(table.shape)}; expected ({n}, k)")
    if table.device != x.device or table.dtype != torch.int32:
        raise ValueError(f"cayley_spmv_cuda: table must be int32 on "
                         f"{x.device}, got {table.dtype} on {table.device}")
    k = int(table.shape[1])
    tab = table.contiguous()
    lps = None
    if loops is not None:
        if tuple(loops.shape) != (n,) or loops.device != x.device:
            raise ValueError(f"cayley_spmv_cuda: loops must be ({n},) on "
                             f"{x.device}, got {tuple(loops.shape)} on "
                             f"{loops.device}")
        lps = loops.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if n == 0 or B == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _LAUNCHES += 1
        rc = lib.cayley_spmv_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), tab.data_ptr(),
            None if lps is None else lps.data_ptr(), y.data_ptr(), n, k, B,
            stream)
    if rc != 0:
        raise RuntimeError("cayley_spmv_cuda: kernel launch failed: "
                           + lib.cayley_spmv_error_string(rc).decode())
    return y


def cayley_spmv(x: torch.Tensor, table: torch.Tensor,
                loops: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return cayley_spmv_cuda(x, table, loops)
    return cayley_spmv_ref(x, table, loops)


def adjacency_matvec(x: torch.Tensor, table: torch.Tensor,
                     loops: Optional[torch.Tensor] = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """One adjacency product: through :func:`cayley_spmv`, or with
    ``use_kernel=False`` the plain version (the reference's oracle route)."""
    if use_kernel:
        return cayley_spmv(x, table, loops)
    return cayley_spmv_ref(x, table, loops)


def kernel_matvec(table, loops=None, *,
                  device: Union[str, torch.device, None] = DEFAULT_DEVICE
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Drop-in ``matvec=`` for :func:`repro_torch.core.spectral.rho2_lanczos`
    (the reference's replacement for ``table_matvec``): the operands move to
    ``device`` once, as int32 and float32, and every call goes through
    :func:`cayley_spmv` — kernel K2 on the card."""
    dev = resolve_device(device)
    tab_np = np.asarray(table)
    n = tab_np.shape[0]
    if tab_np.size and (tab_np.min() < 0 or tab_np.max() >= n):
        raise ValueError("kernel_matvec: table entries must lie in [0, n)")
    tab = torch.as_tensor(tab_np, dtype=torch.int32, device=dev)
    lw = None if loops is None else torch.as_tensor(
        np.asarray(loops), dtype=torch.float32, device=dev)

    def mv(x: torch.Tensor) -> torch.Tensor:
        return cayley_spmv(x, tab, lw)

    return mv
