"""AdamW + cosine schedule with warmup + global-norm clipping.

The port of the reference's ``optim/adamw.py``, with its numerics:

* the schedule and the bias corrections are 0-d float32 tensors, computed
  as jnp computes them (``step`` cast to f32, ``b1 ** step``, ``cos`` in
  f32);
* the global norm sums the leaves' f32 squares in ``jax.tree.leaves``
  order (:mod:`repro_torch.tree`);
* clipping scales each gradient in f32 and casts it back to its dtype, so
  a bf16 gradient is rounded after scaling, as the reference rounds it;
* weight decay applies to every leaf with ``ndim >= 2``: stacked block
  leaves carry the leading (R,) axis, so stacked norms and biases ((R, D))
  are decayed and ``final_norm`` ((D,)) is not, as in the reference;
* m and v are kept in ``state_dtype`` (float32 or bfloat16), ``step`` is a
  0-d int32.

:func:`adamw_update` works in place under ``torch.no_grad()``: it writes
the new parameters, m and v into the given tensors, elementwise in slices
of ``_CHUNK`` elements, so that a full-width step needs no second copy of
the parameters or the state and only slice-sized float32 temporaries.  It
returns the trees all the same, as the reference's pure update does.

On DTensor parameters (sharded execution) the gradients' pending sums (a
replicated parameter's gradient is a partial sum over the axes its batch
shards) are completed in one all-reduce per (mesh axes, dtype), their
leaves flattened into one buffer, as XLA's combiner joins the reference's
(:func:`_completed`); the global norm is each rank's local f32
square-sums, one a leaf (from the first replica of each shard only),
summed over the whole mesh in one all-reduce and then in leaf order
(:func:`_sharded_norm`), so it needs no DTensor rule for adding partial
and replicated sums, which torch 2.11 completes one leaf at a time.  The
update itself runs on each rank's local shards, every gradient first
redistributed to its parameter's placements (elementwise work is exact
shard by shard).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as T
from repro_torch.parallel.act import _flat_group, is_sharded, redistribute

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: elements of one leaf updated at once (256 MB of f32 per temporary)
_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d float32 tensor), in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * prog))
    return _f32(cfg.lr, step) * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares, summed in leaf order."""
    total = None
    for x in T.leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """The functional all-reduce (looked up at the call, so that a staged
    replacement is the one run), waited."""
    import torch.distributed._functional_collectives as funcol

    got = funcol.all_reduce(t, op, group)
    return got.wait() if isinstance(got, funcol.AsyncCollectiveTensor) \
        else got


def _completed(leaves: list) -> list:
    """The DTensor leaves with their ``Partial`` sums completed, the others
    as they are: the leaves partial over the same mesh axes with the same
    dtype and reduce op flattened into one buffer, one all-reduce over
    those axes (flattened) each."""
    from torch.distributed.tensor import DTensor, Replicate

    buckets: Dict[tuple, list] = {}
    for i, x in enumerate(leaves):
        if not is_sharded(x):
            continue
        dims = tuple(j for j, p in enumerate(x.placements) if p.is_partial())
        if dims:
            op = x.placements[dims[0]].reduce_op
            key = (x.device_mesh, dims, x.dtype, op)
            buckets.setdefault(key, []).append(i)
    out = list(leaves)
    for (_, dims, _, op), idx in buckets.items():
        mesh = leaves[idx[0]].device_mesh
        local = [leaves[i].to_local() for i in idx]
        flat = _all_reduce(torch.cat([t.reshape(-1) for t in local]), op,
                           _flat_group(mesh, list(dims)))
        parts = torch.split(flat, [t.numel() for t in local])
        for i, t, part in zip(idx, local, parts):
            x = leaves[i]
            out[i] = DTensor.from_local(
                part.view(t.shape), mesh,
                [Replicate() if p.is_partial() else p for p in x.placements],
                shape=x.shape, stride=x.stride())
    return out


def _sharded_norm(leaves: list) -> torch.Tensor:
    """:func:`global_norm` of leaves on one mesh, none of them partial: each
    leaf's f32 square-sum over this rank's shard, counted by the rank that
    holds the first replica of that shard on every mesh dim that does not
    shard the leaf (zero elsewhere); the (leaves,) vector summed over the
    whole mesh in one all-reduce, then its entries in leaf order."""
    mesh = next(x.device_mesh for x in leaves if is_sharded(x))
    sums = []
    for x in leaves:
        t = x.to_local() if is_sharded(x) else x
        first = all(mesh.get_local_rank(i) == 0 for i in range(mesh.ndim)
                    if not is_sharded(x) or x.placements[i].is_replicate())
        s = torch.sum(torch.square(t.to(torch.float32)))
        sums.append(s if first else torch.zeros_like(s))
    vec = _all_reduce(torch.stack(sums), "sum",
                      _flat_group(mesh, list(range(mesh.ndim))))
    total = vec[0]
    for s in vec[1:]:
        total = total + s
    return torch.sqrt(total)


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to global norm <= ``max_norm``, in f32 and cast back
    to each leaf's dtype; the global norm before clipping)."""
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    return T.tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                      tree), g


def adamw_init(params, cfg: AdamWConfig):
    """Zero m and v in ``cfg.state_dtype`` beside each parameter, and a 0-d
    int32 step, on the parameters' device."""
    dt = _STATE_DTYPES[cfg.state_dtype]
    # zeros_like keeps a DTensor parameter's placements
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
    first = T.leaves(params)[0]
    return dict(m=T.tree_map(zeros, params), v=T.tree_map(zeros, params),
                step=torch.zeros((), dtype=torch.int32, device=first.device))


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor (``t`` if plain)."""
    return t.full_tensor() if is_sharded(t) else t


def _local(t: torch.Tensor, like=None) -> torch.Tensor:
    """The tensor the update writes: a DTensor's local shard (after moving
    it to ``like``'s placements), a plain tensor itself."""
    if not is_sharded(t):
        return t
    if like is not None and tuple(t.placements) != tuple(like.placements):
        t = redistribute(t, like.device_mesh, like.placements)
    return t.to_local()


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A flat view of a tensor the update writes into."""
    if not t.is_contiguous():
        raise ValueError("adamw_update: parameters and state must be "
                         "contiguous (it updates them in place)")
    return t.view(-1)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step: ``(params, state, dict(lr=, grad_norm=))``, the
    parameters, m, v and step updated in place (see the module's note)."""
    step = _full(state["step"]) + 1
    stepf = step.to(torch.float32)
    lr = cosine_schedule(cfg, stepf)
    flat_g, gdef = T.flatten(grads)
    if any(is_sharded(g) for g in flat_g):
        grads = T.unflatten(gdef, _completed(flat_g))
        gnorm = _sharded_norm(T.leaves(grads))
    else:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)

    def upd(p, g, m, v, decay: bool):
        g32 = (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:          # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta), m32, v32

    flat_p, tdef = T.flatten(params)
    flat_g = T.leaves(grads)
    flat_m = T.leaves(state["m"])
    flat_v = T.leaves(state["v"])
    if not (len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v)):
        raise ValueError("adamw_update: params, grads, m and v differ in "
                         "their number of leaves")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        decay = p.dim() >= 2
        p, g, m, v = _local(p), _local(g, p), _local(m, p), _local(v, p)
        pf, mf, vf, gf = _flat(p), _flat(m), _flat(v), g.reshape(-1)
        for lo in range(0, pf.numel(), _CHUNK):
            s = slice(lo, lo + _CHUNK)
            # slice assignment casts to the stored dtype, as .astype does
            pf[s], mf[s], vf[s] = upd(pf[s], gf[s], mf[s], vf[s], decay)
    _local(state["step"]).copy_(step)
    return (T.unflatten(tdef, flat_p),
            dict(m=state["m"], v=state["v"], step=state["step"]),
            dict(lr=lr, grad_norm=gnorm))
