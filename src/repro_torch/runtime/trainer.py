"""Training loop with checkpoint/restart, straggler monitoring, and optional
int8 gradient compression.

The port of the reference's ``runtime/trainer.py``, on one device: the
loop makes the step's synthetic batch (numpy, moved to the device), runs
the eager train step, reads each metric with ``float()`` (which waits for
the device), flags stragglers, appends to ``history`` and writes a
checkpoint every ``ckpt_every`` steps.  There is no ``jax.jit``
counterpart and no ``torch.compile``: the step runs eagerly.  The device
defaults to the card and raises without one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import init_error_state
from repro_torch.train.steps import init_train_state, make_train_step

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fault_tolerance import StragglerMonitor

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    grad_compression: bool = False
    keep_ckpts: int = 3


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE):
        self.cfg, self.opt_cfg, self.data_cfg, self.tcfg = cfg, opt_cfg, data_cfg, tcfg
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor()
        self.history: List[Dict[str, float]] = []
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       grad_compression=tcfg.grad_compression)
        self.params = None
        self.opt_state = None
        self.err_state = None
        self.step = 0

    # -- state ---------------------------------------------------------------
    def init_or_restore(self):
        """Draw the initial state from ``tcfg.seed``, then restore the
        latest checkpoint under ``ckpt_dir`` over it if there is one;
        returns the step it resumes at (0 for a fresh start)."""
        self.params, self.opt_state = init_train_state(
            self.cfg, self.opt_cfg, self.tcfg.seed, device=self.device)
        if self.tcfg.grad_compression:
            self.err_state = init_error_state(self.params)
        if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
            state = dict(params=self.params, opt=self.opt_state)
            state, step = restore_checkpoint(self.tcfg.ckpt_dir, state)
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = step
            return step
        return 0

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        batch = synthetic_batch(self.data_cfg, step,
                                frontend=self.cfg.frontend,
                                d_model=self.cfg.d_model)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # -- loop ----------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
        assert self.params is not None, "call init_or_restore() first"
        target = self.step + (steps if steps is not None else
                              self.tcfg.total_steps - self.step)
        while self.step < target:
            batch = self._batch(self.step)
            self.monitor.step_start()
            if self.tcfg.grad_compression:
                self.params, self.opt_state, self.err_state, metrics = \
                    self.step_fn(self.params, self.opt_state, batch,
                                 self.err_state)
            else:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            straggle = self.monitor.step_end(self.step)
            metrics["straggler"] = float(straggle)
            self.step += 1
            self.history.append(dict(step=self.step, **metrics))
            if self.tcfg.ckpt_dir and self.step % self.tcfg.ckpt_every == 0:
                self.save()
        return self.history

    def save(self):
        state = dict(params=self.params, opt=self.opt_state)
        return save_checkpoint(self.tcfg.ckpt_dir, self.step, state,
                               keep=self.tcfg.keep_ckpts)
