"""GQA/MQA attention with causal masking, sliding windows, and a KV cache.

The port of the reference's ``models/attention.py``.  ``chunked_attention``
is the plain prefill path: a block-chunked online softmax that never
materializes the (S, S) score matrix and skips key blocks wholly outside the
causal / window band.  When autograd records it, each live block's step
runs under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of
the reference's ``jax.checkpoint(body)``: the backward recomputes the
block's scores and probabilities, and only the running (m, l, acc) are
kept.  It is the oracle of the hand-written flash-attention kernel K3
(:mod:`repro_torch.kernels.flash_attention`), which the model's prefill
calls instead on the card.  ``decode_attention`` is plain PyTorch
everywhere (the reference has no kernel for it).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_attention", "decode_attention"]

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512, k_chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, Kv, hd) with H % Kv == 0.

    ``q_offset``: absolute position of q[0] (for prefill continuation).
    Key blocks entirely outside the causal/window band of a query block are
    skipped.  Under autograd each block's step is checkpointed: its
    backward recomputes the block, as the reference's does.
    """
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    Sq_p, Sk_p = nq * q_chunk, nk * k_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, Sk_p - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, Sk_p - Sk))
    dev = q.device
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    def body(m, l, acc, qc, kc_, vc_, q_pos, k_lo):
        s = torch.einsum("bqkgd,bskd->bqkgs", qc.float(),
                         kc_.float()) * scale
        k_pos = k_lo + torch.arange(k_chunk, device=dev)
        mask = _block_mask(q_pos, k_pos, causal, window)
        mask &= (k_pos < Sk)[None, :]                      # padding
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", p.to(vc_.dtype).float(), vc_.float())
        return m_new, l, acc

    out_chunks = []
    for qi in range(nq):
        qc = qp[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(
            B, q_chunk, Kv, G, hd)
        q_lo = q_offset + qi * q_chunk
        q_hi = q_lo + q_chunk - 1
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        m = torch.full((B, q_chunk, Kv, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, q_chunk, Kv, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, q_chunk, Kv, G, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_lo, k_hi = ki * k_chunk, ki * k_chunk + k_chunk - 1
            if causal and k_lo > q_hi:
                continue                                   # future block
            if window is not None and k_hi < q_lo - window + 1:
                continue                                   # expired block
            args = (m, l, acc, qc, kp[:, k_lo:k_hi + 1],
                    vp[:, k_lo:k_hi + 1], q_pos, k_lo)
            if record:
                m, l, acc = checkpoint(body, *args, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                m, l, acc = body(*args)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out_chunks.append(out.reshape(B, q_chunk, H, hd))
    o = torch.cat(out_chunks, dim=1)[:, :Sq]
    return o.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-position decode: q (B, 1, H, hd) against cache (B, S, Kv, hd).

    ``length``: number of valid cache positions.
    """
    B, _, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    G = H // Kv
    qg = q.reshape(B, Kv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    valid = pos < length
    if window is not None:
        valid &= pos >= length - window
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
