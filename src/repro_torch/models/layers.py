"""Elemental layers: RMSNorm, RoPE (incl. M-RoPE), gated MLPs.

Plain functions over explicit parameter dicts of tensors, the port of the
reference's ``models/layers.py``.  ``rms_norm`` on a CUDA tensor launches the
hand-written kernel K5 (:mod:`repro_torch.kernels.rmsnorm`); on a CPU tensor
it runs the plain version.  On a DTensor it runs shard by shard
(:func:`repro_torch.parallel.act.per_shard`): every dim but the normalized
last one is independent, so only that one is gathered first.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as K5
from repro_torch.parallel.act import is_sharded, per_shard, reduced_grad

__all__ = ["rms_norm", "rope_angles", "apply_rope", "mrope_positions",
           "gated_mlp", "init_linear", "init_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * weight`` over the last axis, in f32,
    returned in ``x``'s dtype: kernel K5 on the card, else the plain version."""
    if is_sharded(x):
        lead = tuple(f"x{i}" for i in range(x.dim() - 1))
        return per_shard(rms_norm, (x, weight), (lead + ("d",), ("d",)),
                         (lead + ("d",),), frozenset(lead), eps=eps)
    if x.device.type == "cuda":
        return K5.rmsnorm_cuda(x, weight, eps)
    return K5.rmsnorm_ref(x, weight, eps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Optional[Tuple[int, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables.

    positions: (B, S) for standard RoPE, or (3, B, S) for M-RoPE where the
    three planes are (temporal, height, width) and ``sections`` splits the
    head_dim/2 frequency bands across planes (qwen2-vl §2.1).
    Returns cos/sin of shape (B, S, head_dim/2), f32.
    """
    half = head_dim // 2
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=dev) / half))
    if positions.dim() == 2:     # standard
        ang = positions[..., None].to(torch.float32) * freqs
    else:                        # M-RoPE: pick the plane per frequency band
        assert sections is not None and sum(sections) == half
        plane = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
        pos_per_band = positions[torch.as_tensor(plane, device=dev)]  # (half, B, S)
        ang = torch.movedim(pos_per_band, 0, -1).to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, head_dim); cos/sin: (B, S, head_dim/2). Rotate-half form."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def mrope_positions(B: int, S: int, offset: int = 0,
                    device=None) -> torch.Tensor:
    """Text-stream M-RoPE positions: all three planes share 1D positions."""
    p = torch.arange(offset, offset + S, device=device)[None, :].repeat(B, 1)
    return torch.stack([p, p, p], dim=0)


def gated_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU / GeGLU: down( act(x@wg) * (x@wu) ); on a mesh each of the two
    products' input gradients is reduced on its own
    (:func:`~repro_torch.parallel.act.reduced_grad`)."""
    g = reduced_grad(x) @ wg
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * (reduced_grad(x) @ wu)) @ wd


#: f32 elements drawn at once by init_linear (512 MB): a full-width expert
#: stack is drawn in slices, so the f32 draw never doubles its footprint
_INIT_CHUNK = 1 << 27


def init_linear(shape, dtype: torch.dtype, generator: torch.Generator,
                device=None, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] drawn in f32 from ``generator``, times
    ``scale`` (default 1/sqrt(fan_in)), cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), _INIT_CHUNK):
        hi = min(lo + _INIT_CHUNK, flat.numel())
        t = torch.empty(hi - lo, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        flat[lo:hi] = (t * scale).to(dtype)
    return out


def init_norm(shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)
