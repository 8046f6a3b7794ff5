"""What a reordered float32 sum in step 1's backward does to step 2's loss,
on the reduced kimi-k2-1t-a32b config that
``tests/test_torch_moe_fp8.py::test_sharded_fp8_train_step_matches_single_device``
trains (B 8, S 32, AdamW lr 1e-3, warm-up 1; single device, CPU).

    PYTHONPATH=src python tools/fp8_step_noise.py [--seeds 4]

Each element of step 1's gradient is moved by -1, 0 or +1 float32 ulp
(2^-24 relative) at random, as summing its partial sums in another order
moves it, and step 2 runs from the resulting parameters.  Against the
unperturbed run, for the e4m3 dispatch and the bf16 one, and with the
perturbation on every element, only on those with |g| > 1e-5 or only on
those with |g| <= 1e-5 (where AdamW's eps, 1e-8, could amplify it),
prints one JSON line a run: |step 2's loss change| and |step 2's grad
norm change|, the step-2 dispatch
table entries that differ (top-k flips), the step-2 e4m3 payload elements
that round to another value (fp8 only), and the largest change of a
slot's scale, relative.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe as MOE
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.ranks import train_batch
from repro_torch.train.steps import init_train_state, make_train_step

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
B, S = 8, 32
SMALL = 1e-5
SETS = {"all": None, "above": lambda g: g.abs() > SMALL,
        "below": lambda g: g.abs() <= SMALL}


def run(cfg, seed=None, where=None):
    """Two train steps from seed 0's state; with ``seed``, step 1's
    gradients moved by -1, 0 or +1 ulp (where ``where`` holds).  Returns
    (losses, grad norms, step 2's dispatch tables, step 2's e4m3 payloads
    and scales)."""
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    routes, payloads = [], []
    route, quantize = MOE._route_group, MOE._quantize_local

    def rec_route(*a, **k):
        out = route(*a, **k)
        routes.append(out[0].clone())
        return out

    def rec_quantize(xe):
        q, s = quantize(xe)
        payloads.append((q.view(torch.uint8).clone(), s.detach().clone()))
        return q, s

    def perturb(grads):
        gen = torch.Generator().manual_seed(seed)
        for g in T.leaves(grads):
            d = g * torch.randint(-1, 2, g.shape, generator=gen).to(
                g.dtype) * 2.0 ** -24
            if where is not None:
                d = torch.where(where(g), d, torch.zeros_like(d))
            g.add_(d)

    MOE._route_group, MOE._quantize_local = rec_route, rec_quantize
    losses, norms, at = [], [], []
    try:
        for k in range(2):
            at.append((len(routes), len(payloads)))
            hook = perturb if k == 0 and seed is not None else None
            params, opt, m = make_train_step(cfg, OPT, on_grads=hook)(
                params, opt, train_batch(cfg, B, S, "cpu", k))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        MOE._route_group, MOE._quantize_local = route, quantize
    r2, q2 = at[1]
    return losses, norms, routes[r2:], payloads[q2:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    base_cfg = reduced(get_config("kimi-k2-1t-a32b"))
    for dtype in ("float8_e4m3fn", "bfloat16"):
        cfg = dataclasses.replace(base_cfg, moe_dispatch_dtype=dtype)
        losses0, norms0, routes0, pay0 = run(cfg)
        for name, where in SETS.items():
            for seed in range(args.seeds):
                losses, norms, routes, pay = run(cfg, seed, where)
                row = dict(dispatch=dtype, perturbed=name, seed=seed,
                           loss2=losses[1], loss2_change=abs(
                               losses[1] - losses0[1]),
                           grad_norm2_change=abs(norms[1] - norms0[1]),
                           dispatch_entries_changed=sum(
                               int((a != b).sum())
                               for a, b in zip(routes, routes0)))
                if pay0:
                    row.update(
                        payload_elements=sum(q.numel() for q, _ in pay0),
                        payload_rounded_otherwise=sum(
                            int((a != b).sum())
                            for (a, _), (b, _) in zip(pay, pay0)),
                        scale_rel_change_max=max(
                            float(((a - b) / b).abs().max())
                            for (_, a), (_, b) in zip(pay, pay0)))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
