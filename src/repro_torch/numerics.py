"""float32 arithmetic with the rounding of the reference's compiled programs.

XLA's CPU backend contracts ``fadd(fmul)`` into one fused multiply-add and
rounds float32 divisions and square roots correctly; numpy and eager torch
round the product and the sum apart, and torch's vectorized float32
``sqrt`` may miss by an ulp.  Where the port must give the reference's bits
(the ``jax.random`` draws of :mod:`repro_torch.core.threefry`, the float8
dispatch's slot scales of :mod:`repro_torch.models.moe`) it computes these
operations here, in float64 with the one rounding to float32 made exact.
Every operand is a float32 value: a Python scalar is rounded to float32
first, as a constant of the reference's float32 program is.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma32", "fma32_t", "div32_t", "sqrt32_t"]


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, the sum is rounded to odd there (TwoSum
    error term), and the rounding to float32 is then correct."""
    a, b, c = (np.asarray(v, dtype=np.float32).astype(np.float64)
               for v in (a, b, c))
    s = a * b
    t = s + c
    bb = t - s
    err = (s - (t - bb)) + (c - bb)
    even = (t.view(np.int64) & 1) == 0
    t = np.where((err != 0) & even,
                 np.nextafter(t, np.where(err > 0, np.inf, -np.inf)), t)
    return t.astype(np.float32)


def _f64(v):
    """A float32 tensor or scalar as a float64 operand (a scalar rounded to
    float32 first)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float64)
    return float(np.float32(v))


def fma32_t(a: torch.Tensor, b, c) -> torch.Tensor:
    """:func:`fma32` as torch ops on ``a``'s device: ``a * b + c`` of
    float32 values rounded once (exact float64 product, round-to-odd sum,
    rounding to float32)."""
    a, b, c = a.to(torch.float64), _f64(b), _f64(c)
    s = a * b
    t = s + c
    bb = t - s
    err = (s - (t - bb)) + (c - bb)
    even = (t.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, math.inf, -math.inf)
    t = torch.where((err != 0) & even, torch.nextafter(t, away), t)
    return t.to(torch.float32)


def div32_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a / b`` correctly rounded: the float64 quotient rounded to
    float32 (the double rounding is exact for division)."""
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def sqrt32_t(a: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded, as numpy's and XLA's are; the
    float64 root rounded to float32 is exact."""
    return torch.sqrt(a.to(torch.float64)).to(torch.float32)
