"""One train step of a config at published widths on a mesh of ranks
sharing one card, against the single-device step: the loss and grad norm,
relative, and each small leaf's gradient, relative L2 (the quantities
``chip_smoke.py``'s ``sharded_lowering`` holds), for several variants in
one call.

    python tools/lowering_leaf_errors.py --arch qwen2-7b --mesh 1,8 \
        [--layers 1] [--batch 4] [--seq 512] \
        [--variants bfloat16,bfloat16:padded,float32]

A variant is a dtype (``bfloat16``: the config as published; ``float32``:
parameters and compute in f32) with, after a colon, ``padded`` to force
``models.transformer._padded_heads_attention`` where the kv-group path
would run (the lowering before it).  Each variant's ranks (gloo, the
card's tensors staged through the host, as the smoke runs them) start
after its single-device step has run and been freed.  Prints one JSON
line a variant.  Needs the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

LEAF_ELEMENTS = 1 << 20


def _config(arch: str, layers: int, dtype: str):
    from repro_torch.serve import serving_config

    cfg = serving_config(arch, layers=layers)
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


def _force_padded(padded: bool) -> None:
    if padded:
        from repro_torch.models import transformer as TF

        TF._kv_group_attention = TF._padded_heads_attention


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_names(v, f"{prefix}/{i}")
    else:
        yield prefix.lstrip("/")


def single(cfg, opt_cfg, B: int, S: int) -> dict:
    from repro_torch.parallel.ranks import train_batch, whole_leaves
    from repro_torch.train.steps import init_train_state, make_train_step

    dev = torch.device("cuda")
    params, opt = init_train_state(cfg, opt_cfg, seed=0, device=dev)
    names = list(_leaf_names(params))
    grads = []
    step = make_train_step(cfg, opt_cfg, on_grads=lambda g: grads.append(
        whole_leaves(g, LEAF_ELEMENTS)))
    _, _, m = step(params, opt, train_batch(cfg, B, S, dev, 0))
    out = dict(metrics={k: float(v) for k, v in m.items()}, grads=grads[0],
               names=names)
    del params, opt, step, m, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rank_job(rank, world, cfg, opt_cfg, B, S, mesh, padded):
    from repro_torch.parallel.ranks import sharded_train_steps

    _force_padded(padded)
    return sharded_train_steps(rank, world, [cfg], opt_cfg, B, S, mesh,
                               "cuda", 1, LEAF_ELEMENTS)[0]


def main(argv=None) -> int:
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim.adamw import AdamWConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--mesh", default="1,8")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--variants", default="bfloat16,bfloat16:padded,float32")
    args = ap.parse_args(argv)
    mesh = tuple(int(m) for m in args.mesh.split(","))
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    for variant in args.variants.split(","):
        dtype, _, how = variant.partition(":")
        cfg = _config(args.arch, args.layers, dtype)
        one = single(cfg, opt_cfg, args.batch, args.seq)
        ranks = run_ranks(rank_job, int(np.prod(mesh)), cfg, opt_cfg,
                          args.batch, args.seq, mesh, how == "padded",
                          device="cuda", stage_through_host=True)
        got, mine = ranks[0]["grads"][0], ranks[0]["metrics"][0]
        leaves = {}
        for j, want in one["grads"].items():
            a, b = got[j].astype(np.float64), want.astype(np.float64)
            leaves[one["names"][j]] = float(np.linalg.norm(a - b)
                                            / np.linalg.norm(b))
        ref = one["metrics"]
        print(json.dumps(dict(
            arch=args.arch, mesh=mesh, variant=variant, batch=args.batch,
            seq=args.seq, loss=mine["loss"], single_loss=ref["loss"],
            loss_rel=abs(mine["loss"] - ref["loss"]) / abs(ref["loss"]),
            grad_norm_rel=abs(mine["grad_norm"] - ref["grad_norm"])
            / abs(ref["grad_norm"]),
            leaf_rel_l2=leaves,
            launches=ranks[0]["launches"],
            peak_reserved_gb_per_rank=max(
                r["peak_reserved_bytes"] for r in ranks) / 1e9)),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
