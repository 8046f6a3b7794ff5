"""Step functions: train_step / prefill_step / decode_step.

The port of the reference's ``train/steps.py``.  ``train_step`` takes the
gradient of :func:`repro_torch.models.model.loss_fn` with
``torch.autograd.grad`` over the parameter leaves, optionally passes it
through int8 compression with error feedback, and applies
:func:`repro_torch.optim.adamw.adamw_update`, which updates the parameters
and the optimizer state in place.  It runs eagerly: the reference's
``jax.jit`` has no counterpart here.  Its forward, backward and optimizer
run inside profiler ranges named ``repro_torch/train_step/<part>``, which
``chip_smoke.py`` reads to split a traced step's device time (and
:data:`part_running` names the part, for the dry run's accounting).

Sharded: with parameters, optimizer state and batch placed as DTensors
(:func:`repro_torch.parallel.sharding.device_put` by ``param_pspecs`` /
``opt_pspecs`` / ``batch_pspecs``) and the step called inside
:class:`repro_torch.parallel.act.activation_mesh`, the same step runs on
the mesh: forward and backward under DTensor's implicit replication (the
rope tables and zero accumulators the model builds are plain tensors,
replicated), the optimizer as :mod:`repro_torch.optim.adamw` describes,
and the metrics come back whole.  Gradient compression is single-device
only.  The prefill and decode steps run on DTensor parameters, batch and
caches the same way, under implicit replication; decode takes its
position as a 0-d tensor without a host read.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Union

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import apply_error_feedback
from repro_torch.parallel.act import is_sharded

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "init_train_state"]


#: the part of a train step running now (forward, backward, optimizer),
#: None outside one: the dry run's accounting counts collectives by it
part_running: Optional[str] = None


@contextlib.contextmanager
def _range(part: str):
    global part_running
    before, part_running = part_running, part
    try:
        with torch.profiler.record_function(
                f"repro_torch/train_step/{part}"):
            yield
    finally:
        part_running = before


def _replicating(sharded: bool):
    """DTensor's implicit replication of plain tensors for a sharded step."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_sharded(t) else t


def init_train_state(cfg: ArchConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     device: Union[str, torch.device, None] = DEFAULT_DEVICE):
    """(parameters drawn by the port's ``init_params`` from ``seed`` on
    ``device``, zero AdamW state beside them)."""
    params = M.init_params(cfg, seed=seed, device=device)
    return params, adamw_init(params, opt_cfg)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    grad_compression: bool = False,
                    on_grads: Optional[Callable[[Any], None]] = None):
    """Returns ``train_step(params, opt_state, batch[, err_state])`` ->
    ``(params, opt_state[, err_state], metrics)``; ``batch`` holds tensors
    on the parameters' device.  ``on_grads``, if given, is called with the
    gradient tree before the optimizer reads it (a check's hook: it must
    not write the gradients)."""

    def train_step(params, opt_state, batch, err_state=None):
        flat, treedef = T.flatten(params)
        sharded = any(is_sharded(p) for p in flat)
        if sharded and grad_compression:
            raise NotImplementedError("train_step: gradient compression "
                                      "of a sharded step is not supported")
        was = [p.requires_grad for p in flat]
        for p in flat:
            p.requires_grad_(True)
        try:
            with _replicating(sharded):
                with _range("forward"):
                    loss, metrics = M.loss_fn(params, batch, cfg)
                # a leaf the loss does not reach (a stub frontend's
                # embedding) gets a zero gradient, as jax.grad gives it
                with _range("backward"):
                    grads = T.unflatten(treedef, list(torch.autograd.grad(
                        loss, flat, allow_unused=True,
                        materialize_grads=True)))
        finally:
            for p, w in zip(flat, was):
                p.requires_grad_(w)
        loss = _full(loss.detach())
        metrics = {k: _full(v.detach()) for k, v in metrics.items()}
        if on_grads is not None:
            on_grads(grads)
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


def _any_sharded(tree) -> bool:
    return any(is_sharded(t) for t in T.leaves(tree))


def make_prefill_step(cfg: ArchConfig, max_len: Optional[int] = None):
    """Returns ``prefill_step(params, batch)`` -> ``(logits, caches)``;
    on DTensor parameters it runs under implicit replication, as the train
    step does."""
    @torch.no_grad()
    def prefill_step(params, batch):
        L = max_len if max_len is not None else (
            batch["tokens"].shape[1] if "tokens" in batch
            else batch["embeds"].shape[1])
        with _replicating(_any_sharded(params)):
            return M.prefill(params, batch, cfg, max_len=L)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """Returns ``decode_step(params, token, caches, cur_pos)`` -> ``(logits,
    caches)``; ``cur_pos`` an int or a 0-d integer tensor (never read on
    the host).  On DTensor parameters and caches (placed by
    ``sharding.cache_pspecs``) it runs under implicit replication."""
    @torch.no_grad()
    def decode_step(params, token, caches, cur_pos):
        with _replicating(_any_sharded(params)):
            return M.decode_step(params, token, caches, cur_pos, cfg)
    return decode_step
