"""Atomic checkpoints in the reference's on-disk format (npz shards + json
manifest).

The port of the reference's ``runtime/checkpoint.py``.  Layout::

    <dir>/step_000000123/
        manifest.json          # step, tree structure, dtypes, shapes, owners
        shard_00000.npz        # leaf_<i> -> array, for the leaves this host owns
    <dir>/LATEST               # atomic pointer (rename), written LAST

Leaf ``i`` is the i-th leaf in ``jax.tree.flatten``'s order (dict keys
sorted, lists in order; :mod:`repro_torch.tree`), bfloat16, float16 and
float8 (``float8_e4m3fn``, ``float8_e5m2``) leaves are stored as float32
(lossless) and cast back on restore, and the manifest's ``dtypes`` are the
reference's names (``"bfloat16"``, ``"float8_e4m3fn"``, ``"float32"``,
``"int32"``).  So a checkpoint written by either package restores in the
other; only the manifest's ``treedef`` string differs.  Writes are
crash-safe: the step directory is written under a tmp name and renamed,
then ``LATEST`` is flipped by an atomic rename; old steps are
garbage-collected, and a torn ``LATEST`` falls back to the newest complete
step.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints"]


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


#: leaf types stored as float32, which holds each of their values exactly
_AS_FLOAT32 = (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
               torch.float8_e5m2)


def _storable(x) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16, float16 and float8 (types
    numpy lacks or stores as the reference does) as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in _AS_FLOAT32:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def save_checkpoint(directory: str, step: int, state: Any,
                    keep: int = 3, host_id: int = 0, n_hosts: int = 1) -> str:
    """Write ``state`` (a tree of tensors) atomically; returns final path."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    leaves, treedef = T.flatten(state)
    owned = [i for i in range(len(leaves)) if i % n_hosts == host_id]
    final = d / f"step_{step:09d}"
    tmp = d / f".tmp_step_{step:09d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = {f"leaf_{i}": _storable(leaves[i]) for i in owned}
    np.savez(tmp / f"shard_{host_id:05d}.npz", **arrays)
    manifest = dict(
        step=step,
        n_leaves=len(leaves),
        n_hosts=n_hosts,
        treedef=T.describe(treedef),
        dtypes=[_dtype_name(x) for x in leaves],
        shapes=[list(x.shape) for x in leaves],
        owner={str(i): i % n_hosts for i in range(len(leaves))},
    )
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish of the step
    tmp_latest = d / f".LATEST_{os.getpid()}"
    tmp_latest.write_text(final.name)
    os.rename(tmp_latest, d / "LATEST")         # atomic pointer flip
    _gc(d, keep)
    return str(final)


def _gc(d: Path, keep: int):
    steps = sorted(p for p in d.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory)
    ptr = d / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (d / name / "manifest.json").exists():
        # torn write of the step dir: fall back to newest complete step
        steps = sorted(p for p in d.iterdir() if p.name.startswith("step_")
                       and (p / "manifest.json").exists())
        if not steps:
            return None
        name = steps[-1].name
    return int(name.split("_")[1])


def list_checkpoints(directory: str):
    d = Path(directory)
    if not d.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in d.iterdir()
                  if p.name.startswith("step_") and (p / "manifest.json").exists())


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None
                       ) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf a tensor of the
    matching ``like`` leaf's dtype on its device.  Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves, treedef = T.flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target tree has {len(leaves)}")
    loaded: Dict[int, np.ndarray] = {}
    for shard in sorted(d.glob("shard_*.npz")):
        with np.load(shard) as z:
            for key in z.files:
                loaded[int(key.split("_")[1])] = z[key]
    new_leaves = []
    for i, ref in enumerate(leaves):
        arr = loaded[i]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"target {tuple(ref.shape)}")
        new_leaves.append(torch.as_tensor(arr).to(device=ref.device,
                                                  dtype=ref.dtype))
    return T.unflatten(treedef, new_leaves), step
