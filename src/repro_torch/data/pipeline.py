"""Deterministic synthetic LM data pipeline, shardable per host.

The port's copy of the reference's ``data/pipeline.py``, in numpy (the
reference imports jax there but does not use it).  Batches are a pure
function of (step, config): every host can materialize exactly its shard,
and a restart reproduces the identical stream.  Token streams are a
Markov-ish walk, so the loss curve has structure to learn.  The batches are
numpy arrays equal to the reference's bit for bit; the trainer moves them
to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["DataConfig", "synthetic_batch", "host_shard_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0


def synthetic_batch(cfg: DataConfig, step: int,
                    frontend: str = "none", d_model: int = 0
                    ) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic stream: t_{i+1} = (a * t_i + noise) mod V."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    a = 31
    t0 = rng.integers(0, V, size=(B, 1))
    noise = rng.integers(0, 17, size=(B, S + 1))
    toks = np.zeros((B, S + 1), dtype=np.int64)
    toks[:, 0] = t0[:, 0]
    for i in range(S):
        toks[:, i + 1] = (a * toks[:, i] + noise[:, i]) % V
    batch: Dict[str, np.ndarray] = dict(
        tokens=toks[:, :S].astype(np.int32),
        labels=toks[:, 1:].astype(np.int32))
    if frontend != "none":
        emb = rng.standard_normal(size=(B, S, d_model)).astype(np.float32)
        batch = dict(embeds=emb, labels=batch["labels"])
    return batch


def host_shard_batch(batch: Dict[str, np.ndarray], host_id: int,
                     n_hosts: int) -> Dict[str, np.ndarray]:
    """Slice a global batch to this host's rows (data-parallel input feeding)."""
    def shard(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: shard(v) for k, v in batch.items()}
