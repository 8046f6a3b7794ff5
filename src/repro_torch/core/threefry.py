"""The reference's Lanczos start vectors, drawn without JAX.

The reference draws every Lanczos start vector as
``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``.  Where a
result is an argmin over unconverged Lanczos scores — the lift tower keeps,
at each level, the signing whose 90-step score is smallest — the choice
depends on the start vectors as much as on the candidates (two candidates'
exact lambda_max can lie closer together than the 90-step scores' error),
so the port draws the same vectors to build the same graph.

This module is a numpy copy of that draw: the Threefry-2x32 block cipher
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011,
20 rounds) in JAX's partitionable counter layout (each element's 64-bit
row-major index is the counter, and its two output words are XORed into
one 32-bit draw), the uniform float in [nextafter(-1, 0), 1) built from
the draw's top 23 bits, and ``sqrt(2) * erfinv(u)`` with XLA's float32
``erfinv`` (Giles' polynomial, "Approximating the erfinv function", GPU
Computing Gems, 2011).  The bits and the uniforms are those of JAX; about
one normal in a hundred differs from JAX's by a few float32 ulps (its
``log1p`` and fused multiply-adds round differently from numpy's).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["threefry2x32", "random_bits", "normal"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
#: XLA's float32 erfinv coefficients for w = -log1p(-u^2) below / above 5
_ERFINV_W_LT5 = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941], dtype=np.float32)
_ERFINV_W_GE5 = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682], dtype=np.float32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under
    ``key`` = (k0, k1); uint32 arithmetic wraps."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ _PARITY)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """uint32 draws of ``jax.random.bits(PRNGKey(seed), shape)`` for a
    seed in [0, 2^32), whose key is (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    key = (0, seed)
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _erfinv32(u: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv; each Horner step rounds once, as a fused
    multiply-add does."""
    f32 = np.float32
    w = (-np.log1p(-(u * u).astype(np.float64))).astype(f32)
    small = w < f32(5)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3)).astype(f32)
    p = np.where(small, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for lt5, ge5 in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        c = np.where(small, np.float64(lt5), np.float64(ge5))
        p = (c + p.astype(np.float64) * w).astype(f32)
    return p * u


def normal(seed: int, shape: Tuple[int, ...],
           device: torch.device) -> torch.Tensor:
    """float32 standard normals equal to ``jax.random.normal(
    jax.random.PRNGKey(seed), shape, float32)`` (to a few ulps), placed on
    ``device``."""
    bits = random_bits(seed, shape)
    one = np.float32(1.0)
    unit = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, unit * (one - lo) + lo)
    z = np.float32(np.sqrt(2.0)) * _erfinv32(u)
    return torch.from_numpy(z).to(device)
