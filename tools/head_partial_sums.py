"""The head's input gradient on a model axis of M ranks that shards the
vocabulary, summed as the reference's partitioner and the port sum it,
and the ``final_norm`` weight gradient it gives, against one device's.

    PYTHONPATH=src python tools/head_partial_sums.py [--tokens 512,2048] \
        [--ranks 2,4,8] [--threads 4]

At qwen2-7b's published widths (d_model 3584, vocabulary 152,064, bf16),
with random normalized hidden states y (T, D), a random head (a normal
clipped to +-2, / sqrt(D), as the port's initial weights) and random
labels: the logits ``(y @ w).float()`` a chunk of 512 tokens at a time, their gradient g (softmax
minus the label, over T), and the head's input gradient dh = g @ w.T in
three ways: one device's single bf16 product; each of M vocabulary blocks'
bf16 product, summed in bf16 one rank after another (the reference's
partitioned HLO reduces the head's partial input gradient in a bf16
all-reduce, ``all-reduce.10 = bf16[16,512,3584]`` in its qwen2-7b
``train_4k`` loss scan, and so does the port); the same blocks summed in
float32.  ``final_norm``'s weight gradient is sum_t dh_t * y_t.  Prints
one JSON line a (T, M): the relative L2 error of each sum's ``final_norm``
gradient and of dh itself against one device's.  CPU; a few seconds a
line at 4 threads.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

D_MODEL, VOCAB = 3584, 152064
CHUNK = 512


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def head_input_grads(y: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     ranks: List[int], one: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """dh (T, D) for y (T, D) and w (D, V), both bf16, and labels (T,):
    ``one`` device's product (where asked), and for each M in ``ranks``
    the M blocks' bf16 partial products (``parts_M``, (M, T, D)), summed
    in bf16 in rank order (``bf16_M``) and in float32 (``f32_M``)."""
    T, V = y.shape[0], w.shape[1]
    out = {"one": torch.empty_like(y)} if one else {}
    parts = {m: torch.empty((m, *y.shape), dtype=y.dtype) for m in ranks}
    for c0 in range(0, T, CHUNK):
        c = slice(c0, c0 + CHUNK)
        g = torch.softmax((y[c] @ w).float(), dim=-1)
        g[torch.arange(g.shape[0]), labels[c]] -= 1.0
        g = (g / T).to(y.dtype)
        if one:
            out["one"][c] = g @ w.T
        for m in ranks:
            n = V // m
            for r in range(m):
                parts[m][r, c] = g[:, r * n:(r + 1) * n] @ w[:, r * n:(
                    r + 1) * n].T
    for m, p in parts.items():
        out[f"parts_{m}"] = p
        out[f"bf16_{m}"] = bf16_sum(p)
        out[f"f32_{m}"] = p.float().sum(0)
    return out


def bf16_sum(parts: torch.Tensor, order: Optional[List[int]] = None
             ) -> torch.Tensor:
    """The blocks ``parts`` (M, T, D) summed in bf16 one after another, in
    ``order`` (rank order if None), each partial sum rounded to bf16."""
    order = list(range(parts.shape[0])) if order is None else order
    s = parts[order[0]].clone()
    for r in order[1:]:
        s = (s.float() + parts[r].float()).to(parts.dtype)
    return s


def ring_orders(m: int) -> List[List[int]]:
    """The orders in which a ring of ``m`` ranks sums a chunk: starting at
    each rank, in either direction."""
    return [[(s + d * i) % m for i in range(m)] for s in range(m)
            for d in (1, -1)]


def final_norm_grad(dh: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """The RMSNorm weight's gradient, sum_t dh_t * xhat_t in float32 (the
    norm's plain backward; xhat the normalized input)."""
    return (dh.float() * xhat.float()).sum(0)


def draw(T: int, seed: int = 0):
    """(y bf16, xhat f32, w bf16, labels) at the published widths."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(T, D_MODEL, generator=gen)
    xhat = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
    w = torch.randn(D_MODEL, VOCAB, generator=gen).clamp_(-2.0, 2.0)
    w = (w / np.sqrt(D_MODEL)).bfloat16()
    labels = torch.randint(0, VOCAB, (T,), generator=gen)
    return xhat.bfloat16(), xhat, w, labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", default="512,2048")
    ap.add_argument("--ranks", default="2,4,8")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    ranks = [int(m) for m in args.ranks.split(",")]
    for T in (int(t) for t in args.tokens.split(",")):
        y, xhat, w, labels = draw(T)
        dh = head_input_grads(y, w, labels, ranks)
        one = final_norm_grad(dh["one"], xhat)
        for m in ranks:
            print(json.dumps(dict(
                tokens=T, ranks=m,
                final_norm_rel_bf16_sum=_rel(final_norm_grad(
                    dh[f"bf16_{m}"], xhat), one),
                final_norm_rel_f32_sum=_rel(final_norm_grad(
                    dh[f"f32_{m}"], xhat), one),
                dh_rel_bf16_sum=_rel(dh[f"bf16_{m}"], dh["one"]),
                dh_rel_f32_sum=_rel(dh[f"f32_{m}"], dh["one"]))),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
