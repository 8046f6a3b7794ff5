"""Universal padded gather-table spmv: one matvec, every engine, two backends.

Every hot path applies the same operator family through the padded
gather-table contract (``graphs.Topology.gather_operands``):

    (A x)[i] = sum_j  signs[i, j] * x[table[i, j]]  +  loops[i] * x[i]

with ``signs`` defaulting to all-ones (plain adjacency; the signed form is
the Bilu–Linial operator of the synthesis subsystem) and ``loops`` to zero.
Batched forms write the batch out as a leading dimension: ``x`` (B, n) with
a shared (n, k) table or a (B, n, k) table stack; ``loops`` (n,) or (B, n);
``signs`` (n, k) or (B, n, k).  The reference batches by ``vmap``; its
Pallas body had no batch.  On the card the batched forms split two ways
(``csrc/spmv.cu``): a shared table with two or more vectors goes through a
batch-interleaved copy of ``x`` (n, P), so that one gathered neighbour
brings its B values in ceil(B elem / 32) L2 sectors instead of B; a table
stack and a single vector take the row path (one thread per row, the table
tile staged in shared memory).
Both sum each row's slots in table order, so the two give the same bits.

* :func:`spmv_ref`  — plain PyTorch (gather + sum), any device: the CPU path,
  and the version the kernel is held against on the card;
* :func:`spmv_cuda` — the wrapper of kernel K1 (``csrc/spmv.cu``), the
  Hopper port of the reference's Pallas ``spmv_padded``.  It takes CUDA
  tensors only: it launches the kernel or raises, and never falls back;
* :func:`spmv`      — backend dispatcher.

Backend resolution order: explicit ``backend=`` argument >
:func:`use_backend` context override > ``REPRO_TORCH_SPMV_BACKEND`` env var >
auto (``"cuda"`` for a CUDA tensor, ``"ref"`` for a CPU tensor).

Dispatch is observable through :mod:`repro_torch.obs` counters:
``spmv/dispatch/<backend>`` counts dispatcher decisions and
``spmv/matvec/<backend>`` matvec closures per resolved backend.  Kernel
launches are counted by :func:`spmv_cuda` itself (:func:`launches`).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "BACKENDS", "spmv", "spmv_ref", "spmv_cuda", "spmv_matvec",
    "default_backend", "resolve_backend", "use_backend", "launches",
    "reset_launches", "interleave_stride",
]

#: "ref" = plain PyTorch gather+sum; "cuda" = the hand-written kernel K1.
BACKENDS = ("ref", "cuda")

_OVERRIDE: Optional[str] = None
_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def launches() -> int:
    """Kernel launches made by :func:`spmv_cuda` since the last reset."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def _validate(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown spmv backend {backend!r} "
                         f"(known: {BACKENDS})")
    return backend


def default_backend(device: Union[str, torch.device, None] = None) -> str:
    """Ambient default: env ``REPRO_TORCH_SPMV_BACKEND`` if set, else the
    kernel for CUDA tensors and the plain path for CPU tensors."""
    env = os.environ.get("REPRO_TORCH_SPMV_BACKEND")
    if env:
        return _validate(env)
    if device is None:
        device = DEFAULT_DEVICE
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def resolve_backend(backend: Optional[str] = None,
                    device: Union[str, torch.device, None] = None) -> str:
    """Explicit argument > :func:`use_backend` override > ambient default."""
    if backend is not None:
        return _validate(backend)
    if _OVERRIDE is not None:
        return _OVERRIDE
    return default_backend(device)


@contextlib.contextmanager
def use_backend(backend: str):
    """Force every default-resolved spmv onto ``backend`` inside the block."""
    global _OVERRIDE
    _validate(backend)
    prev = _OVERRIDE
    _OVERRIDE = backend
    try:
        yield
    finally:
        _OVERRIDE = prev


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


# --------------------------------------------------------------------------
# plain path
# --------------------------------------------------------------------------

def spmv_ref(x: torch.Tensor, table: torch.Tensor,
             loops: Optional[torch.Tensor] = None,
             signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch: ``sum_j signs[i,j] * x[table[i,j]] + loops[i]*x[i]``,
    accumulated in f32 (f64 for f64 input) and returned in ``x``'s dtype —
    the arithmetic of the kernel, in PyTorch operators."""
    acc = _acc_dtype(x.dtype)
    xa = x.to(acc)
    idx = table.long()
    if x.dim() == 1:
        g = xa[idx]                                        # (n, k)
    else:
        B, n = x.shape
        k = idx.shape[-1]
        flat = idx.reshape(-1, n * k).expand(B, n * k)
        g = torch.gather(xa, 1, flat).reshape(B, n, k)     # (B, n, k)
    if signs is not None:
        g = g * signs.to(acc)
    y = g.sum(dim=-1)
    if loops is not None:
        y = y + loops.to(acc) * xa
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# kernel K1
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K1's library, built on first use, with its C signatures declared."""
    from . import build

    lib = build.load("spmv")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.spmv_padded_launch.argtypes = [
        ci, vp, vp, vp, vp, vp, ll, ci, ci, ll, ll, ll, vp, ci, vp]
    lib.spmv_padded_launch.restype = ci
    lib.spmv_error_string.argtypes = [ci]
    lib.spmv_error_string.restype = ctypes.c_char_p
    return lib


def interleave_stride(B: int, elem: int) -> int:
    """Row stride P, in elements, of the batch path's interleaved x (n, P):
    a row of B values padded to a power of two below 32 bytes (so that it
    never straddles a sector), else to whole 32-byte sectors."""
    nbytes = B * elem
    if nbytes < 32:
        return (1 << (nbytes - 1).bit_length()) // elem
    return -(-nbytes // 32) * 32 // elem


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy where it does not start on a 16-byte boundary
    (the kernel stages its tiles in 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _batch_operand(t: torch.Tensor, what: str, dev: torch.device,
                   dtype: torch.dtype, row_shape: tuple, B: int,
                   batched: bool) -> tuple:
    """(contiguous operand, batch stride) for a shared or per-batch operand."""
    if t.device != dev:
        raise ValueError(f"spmv_cuda: {what} is on {t.device}, x on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"spmv_cuda: {what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) == row_shape:
        return _aligned(t.contiguous()), 0
    if batched and tuple(t.shape) == (B,) + row_shape:
        return _aligned(t.contiguous()), int(np.prod(row_shape))
    raise ValueError(f"spmv_cuda: {what} has shape {tuple(t.shape)}; expected "
                     f"{row_shape}" + (f" or {(B,) + row_shape}" if batched
                                       else ""))


def spmv_cuda(x: torch.Tensor, table: torch.Tensor,
              loops: Optional[torch.Tensor] = None,
              signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K1 on the card (same operands and result as :func:`spmv_ref`).

    ``x`` must be a contiguous CUDA tensor of dtype float32, float64 or
    bfloat16; ``table`` int32 on the same device.  ``loops`` and ``signs``
    are cast to the accumulation dtype (f64 for f64, else f32), as the
    reference's ``astype(acc_dt)``.  Table entries must lie in ``[0, n)``;
    :func:`spmv_matvec` checks that once on the host, since a per-call check
    would make the device wait.  Raises on any other input and when the
    launch reports an error; never falls back to the plain path.  One call
    counts one launch (:func:`launches`), whichever path it takes.
    """
    return _spmv_cuda(x, table, loops, signs)


def _spmv_cuda(x, table, loops=None, signs=None,
               interleave: bool = True) -> torch.Tensor:
    """:func:`spmv_cuda`; ``interleave=False`` sends a shared-table batch
    down the row path instead of the batch path (the card tests and
    chip_smoke.py hold the two to the same bits)."""
    global _LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"spmv_cuda needs CUDA tensors, got x on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"spmv_cuda: x dtype {x.dtype} not supported "
                         f"(float32, float64, bfloat16)")
    if x.dim() not in (1, 2) or not x.is_contiguous():
        raise ValueError("spmv_cuda: x must be a contiguous (n,) or (B, n) "
                         f"tensor, got shape {tuple(x.shape)}")
    batched = x.dim() == 2
    B, n = (x.shape if batched else (1, x.shape[0]))
    if table.dim() not in (2, 3):
        raise ValueError(f"spmv_cuda: table must be (n, k) or (B, n, k), got "
                         f"{tuple(table.shape)}")
    k = int(table.shape[-1])
    dev = x.device
    acc = _acc_dtype(x.dtype)
    tab, tab_bs = _batch_operand(table, "table", dev, torch.int32, (n, k), B,
                                 batched)
    lps = lps_bs = sg = sg_bs = None
    if loops is not None:
        lps, lps_bs = _batch_operand(loops.to(acc), "loops", dev, acc, (n,), B,
                                     batched)
    if signs is not None:
        sg, sg_bs = _batch_operand(signs.to(acc), "signs", dev, acc, (n, k),
                                   B, batched)
    y = torch.empty_like(x)
    xt, P = None, 0
    if batched and tab_bs == 0 and B > 1 and interleave and n > 0:
        P = interleave_stride(B, x.element_size())
        xt = torch.empty(n * P, dtype=x.dtype, device=dev)    # scratch
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _LAUNCHES += 1
        rc = lib.spmv_padded_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), tab.data_ptr(),
            None if lps is None else lps.data_ptr(),
            None if sg is None else sg.data_ptr(), y.data_ptr(),
            n, k, B, tab_bs, lps_bs or 0, sg_bs or 0,
            None if xt is None else xt.data_ptr(), P, stream)
    if rc != 0:
        raise RuntimeError("spmv_cuda: kernel launch failed: "
                           + lib.spmv_error_string(rc).decode())
    return y


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def spmv(x: torch.Tensor, table: torch.Tensor,
         loops: Optional[torch.Tensor] = None,
         signs: Optional[torch.Tensor] = None, *,
         backend: Optional[str] = None) -> torch.Tensor:
    """Apply the padded gather-table operator through the resolved backend."""
    b = resolve_backend(backend, x.device)
    obs.count("spmv/dispatch/" + b)
    if b == "ref":
        return spmv_ref(x, table, loops, signs)
    return spmv_cuda(x, table, loops, signs)


def spmv_matvec(table, loops=None, *, backend: Optional[str] = None,
                device: Union[str, torch.device, None] = DEFAULT_DEVICE
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Adjacency-operator closure over one (n, k) table — the drop-in matvec
    for :func:`repro_torch.core.spectral.lanczos_tridiag` and friends.  The
    operands move to ``device`` and the backend is resolved once, at closure
    creation."""
    dev = resolve_device(device)
    b = resolve_backend(backend, dev)
    obs.count("spmv/matvec/" + b)
    tab_np = np.asarray(table)
    n = tab_np.shape[0]
    if tab_np.size and (tab_np.min() < 0 or tab_np.max() >= n):
        raise ValueError("spmv_matvec: table entries must lie in [0, n)")
    tab = torch.as_tensor(tab_np, dtype=torch.int32, device=dev)
    lw = None if loops is None else torch.as_tensor(
        np.asarray(loops), dtype=torch.float32, device=dev)

    def mv(x: torch.Tensor) -> torch.Tensor:
        return spmv(x, tab, lw, backend=b)

    return mv
