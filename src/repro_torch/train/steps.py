"""Step functions: train_step / prefill_step / decode_step.

The port of the reference's ``train/steps.py``.  ``train_step`` takes the
gradient of :func:`repro_torch.models.model.loss_fn` with
``torch.autograd.grad`` over the parameter leaves, optionally passes it
through int8 compression with error feedback, and applies
:func:`repro_torch.optim.adamw.adamw_update`, which updates the parameters
and the optimizer state in place.  It runs eagerly: the reference's
``jax.jit`` has no counterpart here.  Its forward, backward and optimizer
run inside profiler ranges named ``repro_torch/train_step/<part>``, which
``chip_smoke.py`` reads to split a traced step's device time.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import apply_error_feedback

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "init_train_state"]


def _range(part: str):
    return torch.profiler.record_function(f"repro_torch/train_step/{part}")


def init_train_state(cfg: ArchConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     device: Union[str, torch.device, None] = DEFAULT_DEVICE):
    """(parameters drawn by the port's ``init_params`` from ``seed`` on
    ``device``, zero AdamW state beside them)."""
    params = M.init_params(cfg, seed=seed, device=device)
    return params, adamw_init(params, opt_cfg)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    grad_compression: bool = False):
    """Returns ``train_step(params, opt_state, batch[, err_state])`` ->
    ``(params, opt_state[, err_state], metrics)``; ``batch`` holds tensors
    on the parameters' device."""

    def train_step(params, opt_state, batch, err_state=None):
        flat, treedef = T.flatten(params)
        was = [p.requires_grad for p in flat]
        for p in flat:
            p.requires_grad_(True)
        try:
            with _range("forward"):
                loss, metrics = M.loss_fn(params, batch, cfg)
            # a leaf the loss does not reach (a stub frontend's embedding)
            # gets a zero gradient, as jax.grad gives it
            with _range("backward"):
                grads = T.unflatten(treedef, list(torch.autograd.grad(
                    loss, flat, allow_unused=True, materialize_grads=True)))
        finally:
            for p, w in zip(flat, was):
                p.requires_grad_(w)
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        new_err = None
        with _range("optimizer"):
            if grad_compression:
                grads, new_err = apply_error_feedback(grads, err_state)
            params, opt_state, opt_metrics = adamw_update(params, grads,
                                                          opt_state, opt_cfg)
        metrics = dict(metrics, total_loss=loss, **opt_metrics)
        if grad_compression:
            return params, opt_state, new_err, metrics
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: Optional[int] = None):
    @torch.no_grad()
    def prefill_step(params, batch):
        L = max_len if max_len is not None else (
            batch["tokens"].shape[1] if "tokens" in batch
            else batch["embeds"].shape[1])
        return M.prefill(params, batch, cfg, max_len=L)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    @torch.no_grad()
    def decode_step(params, token, caches, cur_pos):
        return M.decode_step(params, token, caches, cur_pos, cfg)
    return decode_step
