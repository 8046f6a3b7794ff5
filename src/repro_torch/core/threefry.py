"""The reference's ``jax.random`` draws, made without JAX.

The reference draws every Lanczos start vector as
``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``, and its
lift annealer draws start vectors, flip indices and acceptance uniforms
from a ``jax.random.split`` chain of that key.  Where a result is an argmin
over unconverged Lanczos scores — the lift tower keeps, at each level, the
signing whose 90-step score is smallest — the choice depends on these
draws as much as on the candidates (two candidates' exact lambda_max can
lie closer together than the 90-step scores' error), so the port draws the
same numbers to build the same graph.

This module is a numpy copy of those draws: the Threefry-2x32 block cipher
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011,
20 rounds) in JAX's partitionable counter layout (each element's 64-bit
row-major index is the counter; a draw XORs the two output words into one
32-bit word, a split keeps both words as the new key), ``randint``'s
two-draw construction modulo the span, the uniform float in [minval,
maxval) built from the draw's top 23 bits, and ``sqrt(2) * erfinv(u)`` with
XLA's float32 ``erfinv`` (Giles' polynomial, "Approximating the erfinv
function", GPU Computing Gems, 2011).  A key is a pair of uint32 words;
an integer seed in [0, 2^32) stands for ``PRNGKey(seed)`` = (0, seed).
Keys, bits, integers, uniforms and normals are those of JAX on the CPU,
bit for bit: ``log1p`` is XLA's own (Cephes' approximations, as its CPU
backend compiles them), and every multiply-add that XLA fuses rounds once
here too.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.numerics import div32_t, fma32, fma32_t, sqrt32_t

__all__ = ["threefry2x32", "prng_key", "split", "fold_in", "random_bits",
           "randint", "uniform", "normal", "normal_host", "gumbel",
           "gumbel_host", "categorical", "categorical_host"]

#: a key pair (k0, k1) of uint32 words, or a seed standing for PRNGKey(seed)
Key = Union[int, Tuple[int, int], np.ndarray]

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
#: XLA's float32 log1p: Cephes' rational approximation for |x| below
#: sqrt(2) - 1 (numerator, denominator after its leading 1) ...
_LOG1P_SMALL = np.float32(0.414213568)
_LOG1P_NUM = np.array([
    4.52700006e-05, 0.498541027, 6.57873249, 29.9119186, 60.9496689,
    57.1129646, 20.0395527], dtype=np.float32)
_LOG1P_DEN = np.array([
    15.0629091, 83.0475693, 221.762405, 309.098724, 216.427887, 60.11866],
    dtype=np.float32)
#: ... and Cephes' logf above it: ln 2 split in two, the mantissa's
#: sqrt(1/2) pivot, and the polynomial's nine coefficients in the order
#: the compiled code pairs them
_LOG_LN2_HI = np.float32(0.693359375)
_LOG_LN2_LO = np.float32(-0.000212194442)
_LOG_SQRT_HALF = np.float32(0.707106769)
_LOG_POLY = np.array([
    0.0703768358, -0.115146101, 0.116769984,
    -0.12420141, 0.142493233, -0.166680574,
    0.200007141, -0.24999994, 0.333333313], dtype=np.float32)


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


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32): (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return np.array([0, seed], dtype=np.uint32)


def _key(key: Key) -> np.ndarray:
    if isinstance(key, (int, np.integer)):
        return prng_key(key)
    key = np.asarray(key)
    if key.shape != (2,):
        raise ValueError(f"a key is a pair of uint32 words, got {key!r}")
    return key.astype(np.uint32)


def _counters(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """(high, low) uint32 words of each element's row-major index."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys, key i being
    both output words of Threefry at counter i."""
    b0, b1 = threefry2x32(tuple(_key(key)), *_counters((num,)))
    return np.stack([b0, b1], axis=1)


def fold_in(key: Key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2^32): both
    output words of Threefry at the counter (0, data) under ``key``."""
    data = int(data)
    if not 0 <= data < 2 ** 32:
        raise ValueError(f"fold_in data must lie in [0, 2**32), got {data}")
    b0, b1 = threefry2x32(tuple(_key(key)), np.zeros(1, np.uint32),
                          np.array([data], dtype=np.uint32))
    return np.array([b0[0], b1[0]], dtype=np.uint32)


def random_bits(key: Key, shape: Tuple[int, ...]) -> np.ndarray:
    """uint32 draws of ``jax.random.bits(key, shape)``."""
    b0, b1 = threefry2x32(tuple(_key(key)), *_counters(shape))
    return (b0 ^ b1).reshape(shape)


def randint(key: Key, shape: Tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """int32 draws of ``jax.random.randint(key, shape, minval, maxval)``
    for int32 bounds: two 32-bit draws (high, low) from ``split(key)``,
    reduced modulo the span as ``(high % span) * (2^32 % span) + low % span``
    in uint32 arithmetic that wraps, as JAX's does."""
    lo_i, hi_i = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    minval, maxval = int(minval), int(maxval)
    if not (lo_i <= minval <= hi_i and lo_i <= maxval <= hi_i):
        raise ValueError("randint bounds must fit in int32")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(1 if maxval <= minval else (maxval - minval) % 2 ** 32)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = np.uint32(mult * mult) % span
        off = (higher % span) * mult + lower % span
    off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform(key: Key, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 draws of ``jax.random.uniform(key, shape, float32, minval,
    maxval)``: the top 23 bits as a float in [1, 2), minus 1, scaled by
    one fused multiply-add (rounded once, as XLA contracts it)."""
    f32 = np.float32
    lo, hi = f32(minval), f32(maxval)
    bits = random_bits(key, shape)
    one = f32(1.0)
    unit = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(f32) - one
    scaled = unit.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(f32))


def _log32(y: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` as its CPU backend compiles it (Cephes'
    ``logf``): the exponent and a polynomial in the mantissa, each
    ``fadd(fmul)`` that codegen contracts one
    :func:`~repro_torch.numerics.fma32`; ``y`` is clamped to the
    smallest normal float first."""
    f32, one = np.float32, np.float32(1.0)
    with np.errstate(all="ignore"):
        y = np.maximum(y, np.finfo(f32).tiny).astype(f32)
        bits = y.view(np.int32)
        mant = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)       # [0.5, 1)
        expo = ((bits >> 23) - 127).astype(f32) + one
        low = mant < _LOG_SQRT_HALF
        z = (mant - one) + np.where(low, mant, f32(0.0))
        expo = np.where(low, expo - one, expo).astype(f32)
        z2 = z * z
        z3 = z2 * z
        a0, a1, a2, b0, b1, b2, c0, c1, c2 = _LOG_POLY
        pa = fma32(fma32(z, a0, a1), z, a2)
        pb = fma32(fma32(z, b0, b1), z, b2)
        pc = fma32(fma32(z, c0, c1), z, c2)
        poly = fma32(z3, fma32(z3, pa, pb), pc)
        tail = fma32(z3, poly, expo * _LOG_LN2_LO)
        return fma32(expo, _LOG_LN2_HI, fma32(f32(-0.5), z2, z) + tail)


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` as its CPU backend compiles it for x in
    (-1, 0]: Cephes' rational form for |x| < sqrt(2) - 1, else
    :func:`_log32` of ``1 + x``; each ``fadd(fmul)`` that codegen
    contracts is one :func:`~repro_torch.numerics.fma32`."""
    f32, one = np.float32, np.float32(1.0)
    with np.errstate(all="ignore"):
        large = _log32(x + one)
        x2 = x * x
        zero = x * f32(0.0)
        num = zero + _LOG1P_NUM[0]
        for c in _LOG1P_NUM[1:]:
            num = fma32(num, x, c)
        den = zero + one
        for c in _LOG1P_DEN:
            den = fma32(den, x, c)
        small = x + fma32(x2, f32(-0.5), (x * x2) * (num / den))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, large).astype(f32)


def _erfinv32(u: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv: w = -log1p(-u^2), then Horner steps that each
    round once, as a fused multiply-add does."""
    f32 = np.float32
    w = -_log1p32(-(u * u))
    small = w < f32(5)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3)).astype(f32)
    p = np.where(small, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for lt5, ge5 in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = fma32(p, w, np.where(small, lt5, ge5))
    return p * u


def normal_host(key: Key, shape: Tuple[int, ...]) -> np.ndarray:
    """float32 standard normals equal to ``jax.random.normal(key, shape,
    float32)`` on the CPU, computed in numpy: the plain version of
    :func:`normal`, which holds the same bits."""
    f32 = np.float32
    u = uniform(key, shape, np.nextafter(f32(-1.0), f32(0.0)), 1.0)
    return f32(np.sqrt(2.0)) * _erfinv32(u)


def gumbel_host(key: Key, shape: Tuple[int, ...]) -> np.ndarray:
    """float32 draws of ``jax.random.gumbel(key, shape, float32)`` (the
    default "low" mode) on the CPU: ``-log(-log(u))`` of uniforms in
    [tiny, 1), with XLA's float32 ``log``; the plain version of
    :func:`gumbel`."""
    f32 = np.float32
    u = uniform(key, shape, np.finfo(f32).tiny, 1.0)
    return -_log32(-_log32(u))


def categorical_host(key: Key, logits: np.ndarray) -> np.ndarray:
    """``jax.random.categorical(key, logits)`` over the last axis of
    float32 ``logits``: the argmax of Gumbel draws plus the logits (the
    first index of a tie, as ``jnp.argmax``); the plain version of
    :func:`categorical`."""
    logits = np.asarray(logits)
    if logits.dtype != np.float32:
        raise ValueError(f"categorical takes float32 logits, got "
                         f"{logits.dtype}")
    return np.argmax(gumbel_host(key, logits.shape) + logits, axis=-1)


# --------------------------------------------------------------------------
# the same normals as torch ops on the caller's device
# --------------------------------------------------------------------------
#
# Every step below is one eager torch op, so each rounds once: a fused or
# compiled kernel could contract ``a * b + c`` into a fused multiply-add
# and change bits.  uint32 words ride in int64 tensors, masked to 32 bits
# after each add and shift.

_M32 = 0xFFFFFFFF


def _threefry_t(key: np.ndarray, x0: torch.Tensor, x1: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors holding uint32 words."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _uniform_t(key: Key, shape: Tuple[int, ...], minval: float,
               maxval: float, device: torch.device) -> torch.Tensor:
    """:func:`uniform` as torch ops on ``device``."""
    f32 = np.float32
    lo, hi = f32(minval), f32(maxval)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    b0, b1 = _threefry_t(_key(key), idx >> 32, idx & _M32)
    bits = (b0 ^ b1) >> 9
    unit = (bits | int(f32(1.0).view(np.uint32))).to(torch.int32).view(
        torch.float32) - 1.0
    scaled = (unit.to(torch.float64) * float(np.float64(hi - lo))
              + float(lo)).to(torch.float32)
    return torch.clamp(scaled, min=float(lo)).reshape(shape)


def _log1p32_small_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`_log1p32`'s rational branch (|x| < sqrt(2) - 1)."""
    x2 = x * x
    num = x * 0.0 + float(_LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma32_t(num, x, c)
    den = x * 0.0 + 1.0
    for c in _LOG1P_DEN:
        den = fma32_t(den, x, c)
    return x + fma32_t(x2, -0.5, (x * x2) * div32_t(num, den))


def _log32_t(y: torch.Tensor) -> torch.Tensor:
    """:func:`_log32` as torch ops."""
    y = torch.clamp(y, min=float(np.finfo(np.float32).tiny))
    bits = y.view(torch.int32)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    expo = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = mant < float(_LOG_SQRT_HALF)
    z = (mant - 1.0) + torch.where(low, mant, 0.0)
    expo = torch.where(low, expo - 1.0, expo)
    z2 = z * z
    z3 = z2 * z
    a0, a1, a2, b0, b1, b2, c0, c1, c2 = _LOG_POLY
    pa = fma32_t(fma32_t(z, a0, a1), z, a2)
    pb = fma32_t(fma32_t(z, b0, b1), z, b2)
    pc = fma32_t(fma32_t(z, c0, c1), z, c2)
    poly = fma32_t(z3, fma32_t(z3, pa, pb), pc)
    tail = fma32_t(z3, poly, expo * float(_LOG_LN2_LO))
    return fma32_t(expo, _LOG_LN2_HI, fma32_t(z2, -0.5, z) + tail)


def _log1p32_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`_log1p32` as torch ops, each element through the one branch
    it takes."""
    small = torch.abs(x) < float(_LOG1P_SMALL)
    out = torch.empty_like(x)
    out[small] = _log1p32_small_t(x[small])
    out[~small] = _log32_t(x[~small] + 1.0)
    return out


def _erfinv32_t(u: torch.Tensor) -> torch.Tensor:
    """:func:`_erfinv32` as torch ops."""
    w = -_log1p32_t(-(u * u))
    small = w < 5.0
    w = torch.where(small, w - 2.5, sqrt32_t(w) - 3.0)
    lt5 = torch.from_numpy(_ERFINV_W_LT5).to(u.device)
    ge5 = torch.from_numpy(_ERFINV_W_GE5).to(u.device)
    p = torch.where(small, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_W_LT5)):
        p = fma32_t(p, w, torch.where(small, lt5[i], ge5[i]))
    return p * u


def normal(key: Key, shape: Tuple[int, ...],
           device: torch.device) -> torch.Tensor:
    """float32 standard normals equal to ``jax.random.normal(key, shape,
    float32)`` on the CPU, computed by torch ops on ``device`` (the same
    bits as :func:`normal_host`)."""
    f32 = np.float32
    u = _uniform_t(key, shape, np.nextafter(f32(-1.0), f32(0.0)), 1.0,
                   torch.device(device))
    return float(f32(np.sqrt(2.0))) * _erfinv32_t(u)


def gumbel(key: Key, shape: Tuple[int, ...],
           device: torch.device) -> torch.Tensor:
    """float32 draws equal to ``jax.random.gumbel(key, shape, float32)``
    on the CPU, computed by torch ops on ``device`` (the same bits as
    :func:`gumbel_host`)."""
    tiny = np.finfo(np.float32).tiny
    u = _uniform_t(key, shape, tiny, 1.0, torch.device(device))
    return -_log32_t(-_log32_t(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of
    float32 ``logits``, on their device: int64 indices, those of
    :func:`categorical_host` for the same key and logits."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical takes float32 logits, got "
                         f"{logits.dtype}")
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)
