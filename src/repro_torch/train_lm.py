"""End-to-end driver: train an LM with checkpoint/restart.

The port of ``examples/train_lm.py``::

    PYTHONPATH=src python -m repro_torch.train_lm --arch qwen2-7b \\
        --layers 12 --batch 1 --seq 4096 --steps 6 --ckpt-dir ''

    PYTHONPATH=src python -m repro_torch.train_lm --arch qwen2-7b \\
        --reduced --device cpu

Kill it mid-run and re-run the same command: it resumes from the latest
checkpoint under ``--ckpt-dir`` and reproduces the straight-through loss
curve (an empty ``--ckpt-dir`` writes no checkpoint).  On the card (the
default device) the model runs at the config's published widths with
random weights drawn from seed 0; ``--layers`` cuts the depth to a multiple
of the config's pattern, as ``repro_torch.serve`` does, and ``--reduced``
trains the reference's ``reduced`` config (tiny widths) instead, which
runs on the CPU.  (The reference's example reduces every architecture but
its default ``lm100m``; here the cut is asked for.)  It prints the
example's step lines, then one JSON object: the config, what was cut
(``reduced``), the loss curve, step milliseconds and tokens/s, and the
peak device memory.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Any, Dict

import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.serve import serving_config

__all__ = ["main"]


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_lm",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to smoke size")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to this many layers (pattern multiple)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="experiments/train_lm_ckpt",
                    help="checkpoint directory ('' writes none)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = serving_config(args.arch, args.layers, args.reduced)
    base = reduced(full) if args.reduced else full
    cut = ["reduced config (tiny widths, experts, vocab)"] if args.reduced else []
    if cfg.n_layers != base.n_layers:
        cut.append(f"layers {cfg.n_layers} of {base.n_layers}")
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M")
    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    data = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab_size=cfg.vocab_size)
    ckpt_dir = args.ckpt_dir or None
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=ckpt_dir, log_every=10,
                         grad_compression=args.compress_grads)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, opt, data, tcfg, device=dev)
    start = tr.init_or_restore()
    if start:
        print(f"resumed from checkpoint at step {start}")
    step_s = []
    t0, last_log = time.time(), start
    while tr.step < args.steps:
        t = time.perf_counter()
        tr.run(steps=1)             # float() of each metric waits for the device
        step_s.append(time.perf_counter() - t)
        if tr.step % 10 and tr.step < args.steps:
            continue
        h = tr.history[-1]
        tok_s = (tr.step - last_log) * args.batch * args.seq / max(time.time() - t0, 1e-9)
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  lr {h['lr']:.2e}  "
              f"gnorm {h['grad_norm']:.2f}  {tok_s:,.0f} tok/s"
              + ("  [straggler]" if h["straggler"] else ""), flush=True)
        t0, last_log = time.time(), tr.step
    if ckpt_dir:
        tr.save()
        print(f"done at step {tr.step}; checkpoints in {ckpt_dir}")
    steady = step_s[1:] or step_s
    step_ms = statistics.median(steady) * 1e3 if steady else None
    out = dict(
        arch=args.arch, config=cfg.name, n_layers=cfg.n_layers, reduced=cut,
        params=sum(p.numel() for p in T.leaves(tr.params)),
        device=str(dev),
        device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
        batch=args.batch, seq=args.seq, steps=args.steps, resumed_from=start,
        compress_grads=args.compress_grads,
        loss=[h["loss"] for h in tr.history],
        grad_norm=[h["grad_norm"] for h in tr.history],
        step_ms=step_ms,
        step_ms_note="median over this run's steps after its first",
        tokens_per_s=(args.batch * args.seq / (step_ms / 1e3)
                      if step_ms else None),
        peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else "not measured"))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
