"""Fault-tolerance walkthrough: crash -> restore -> elastic re-mesh, plus the
paper's discrepancy certificate for degraded operation.

The port of ``examples/elastic_demo.py``::

    PYTHONPATH=src python -m repro_torch.elastic_demo
    PYTHONPATH=src python -m repro_torch.elastic_demo --device cpu

It trains the reduced qwen2-7b (one repeat) on the card unless asked for
the CPU, in a temporary checkpoint directory it removes at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import (degraded_operation_certificate,
                                                 plan_elastic_remesh, reshard)
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.elastic_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tmp = tempfile.mkdtemp(prefix="elastic_demo_")
    try:
        cfg = reduced(get_config("qwen2-7b"), repeats=1)
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=24)
        data = DataConfig(global_batch=4, seq_len=32, vocab_size=cfg.vocab_size)
        tcfg = TrainerConfig(total_steps=24, ckpt_every=6, ckpt_dir=tmp)

        print(f"1. train 12 steps with checkpoints every 6 ({dev}) ...")
        t = Trainer(cfg, opt, data, tcfg, device=dev)
        t.init_or_restore()
        t.run(steps=12)
        print(f"   loss at step 12: {t.history[-1]['loss']:.4f}")

        print("2. 'crash' — new process restores from the atomic checkpoint ...")
        t2 = Trainer(cfg, opt, data, tcfg, device=dev)
        resumed = t2.init_or_restore()
        print(f"   resumed at step {resumed}")
        t2.run(steps=12)
        print(f"   loss at step 24: {t2.history[-1]['loss']:.4f}")

        print("3. elastic re-mesh after losing 16 of 512 chips (TP axis kept):")
        plan = plan_elastic_remesh(n_devices=512, lost=16, model_axis=16)
        print(f"   {plan.old_devices} -> {plan.new_devices} chips, "
              f"new mesh {plan.new_mesh_shape}  ({plan.note})")
        moved = reshard(t2.params, dev)
        print("   (restore path re-places the same checkpoint on the new "
              f"devices via runtime.fault_tolerance.reshard: "
              f"{len(moved['blocks'])} block stacks on {dev})")

        print("4. the paper's degraded-operation certificate (LPS interconnect):")
        for alpha in (0.97, 0.9, 0.8):
            cert = degraded_operation_certificate(n=4896, radix=18, alpha=alpha)
            print(f"   alpha={alpha:.2f}: guaranteed bisection >= "
                  f"{cert.guaranteed_bisection_edges:8.0f} edges on ANY surviving set")
        print("   a torus gives 0 guaranteed edges for non-contiguous survivors.")
        return dict(loss_step_12=t.history[-1]["loss"], resumed_at=resumed,
                    loss_step_24=t2.history[-1]["loss"], plan=plan)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
