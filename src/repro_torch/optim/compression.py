"""int8 gradient compression with error feedback.

The port of the reference's ``optim/compression.py``.  Per-row symmetric
scaling: g ~ scale * int8.  The residual (g - dequant) is carried in an
error buffer and added to the next step's gradient, so the compression bias
vanishes over time (error-feedback SGD/Adam).  In a multi-host run this
would shrink the data-parallel all-reduce; on one card it applies the same
quantize/dequantize pair to the gradients.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so on the same input the result is the
reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T

__all__ = ["compress", "decompress", "init_error_state", "apply_error_feedback"]


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8 quantization. Returns (q, scale)."""
    g32 = g.to(torch.float32)
    flat = g32.reshape(g32.shape[0], -1) if g32.dim() > 1 else g32.reshape(1, -1)
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    shape = ((g32.shape[0],) + (1,) * (g32.dim() - 1) if g32.dim() > 1
             else (1,))
    return q.reshape(g32.shape), scale.reshape(shape)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params) -> Any:
    """A zero f32 error buffer beside each parameter, on its device."""
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def apply_error_feedback(grads, err_state):
    """Returns (quantize-then-dequantize grads, new error state).

    The returned grads are what every worker would see after the int8
    all-reduce; err accumulates the per-worker quantization residual."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = compress(g32)
        deq = decompress(q, s)
        return deq.to(g.dtype), g32 - deq

    flat_g, tdef = T.flatten(grads)
    flat_e = T.leaves(err_state)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (T.unflatten(tdef, [o[0] for o in out]),
            T.unflatten(tdef, [o[1] for o in out]))
