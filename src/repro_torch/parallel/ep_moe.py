"""Explicit expert-parallel MoE forward: two all-to-alls on the model axis.

The port of the reference's ``parallel/ep_moe.py``.  Inside the reference's
``shard_map`` over the ('data', 'model') mesh each data shard routes its
own token groups, and the dispatch and return exchanges are explicit
``all_to_all`` calls on the 'model' axis: the exact expert-parallel volume,
nothing replicated.  Here each rank of a ``DeviceMesh`` does the same with
its local shards and ``torch.distributed.all_to_all_single`` on the mesh's
'model' process group.

Layout (per (data d, model m) rank):
  tokens   : local groups (G/d, S, D), the same on every model rank of a
             data row
  experts  : wg/wu/wd shards (E/m, D, F) and (E/m, F, D)
  dispatch : (m, G/d, E/m, C, D) -> all_to_all on 'model' -> each model
             rank gets the slots destined for ITS experts from every model
             rank of its data row.

Forward only, as in the reference.  Routing is :func:`repro_torch.models.
moe._route_group` on each local group (sort key ``expert * (S*k) +
assignment``, so a capacity drop drops the same assignments as the
single-device path).  Exchange-shape contract: each exchange moves the
padded (G/d, E, C, D) slot tensor of a rank, ``C = capacity(S, E, k,
capacity_factor)``; capacity padding travels even when slots are empty.
The payload travels in the activations' dtype, as the reference's does:
its explicit-EP forward never reads ``moe_dispatch_dtype``, so a config
with the float8 dispatch (which :func:`repro_torch.models.moe.moe_forward`
quantizes) exchanges its slots here in the compute dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.moe import (_act, _combine, _gather_slots,
                                    _route_group, capacity)

from .act import mesh_axes

__all__ = ["ep_moe_forward", "exchange_stats", "reset_exchange_stats"]

_STATS = dict(all_to_all=0, all_to_all_bytes=0)


def exchange_stats() -> Dict[str, int]:
    """All-to-alls issued by :func:`ep_moe_forward` on this rank since the
    last reset, and the bytes each sent (summed)."""
    return dict(_STATS)


def reset_exchange_stats() -> None:
    _STATS.update(all_to_all=0, all_to_all_bytes=0)


def _local(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t`` at ``placements``: a DTensor is
    redistributed (if needed) and unwrapped; a plain tensor is the whole
    array, of which the rank keeps its slice."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        return t.to_local()
    return distribute_tensor(t, mesh, placements,
                             src_data_rank=None).to_local()


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """One all-to-all of ``t`` (M, ...) on ``group``: chunk m to rank m."""
    import torch.distributed as dist

    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    _STATS["all_to_all"] += 1
    _STATS["all_to_all_bytes"] += t.numel() * t.element_size()
    return out


def ep_moe_forward(mesh, params: Dict, x: torch.Tensor, cfg, *,
                   return_dispatch: bool = False):
    """Explicit-EP MoE forward over a ('data', 'model') ``DeviceMesh``.

    Args:
      mesh: mesh whose 'model' axis hosts the experts (E % model == 0).
      params: ``router (D, E)`` and ``wg / wu (E, D, F)``, ``wd (E, F, D)``:
        DTensors (sharded on the expert axis over 'model'), or whole
        tensors, of which each rank keeps its shard.
      x: token groups (G, S, D), a DTensor or the whole tensor; sharded on
        'data'.
      cfg: reads n_experts, experts_per_token, capacity_factor, mlp_act.

    Returns y (G, S, D) as a DTensor sharded on 'data' (and, with
    ``return_dispatch``, the (G, E, C) dispatch table likewise).  All
    cross-rank traffic is two all-to-alls of the rank's (G/d, E, C, D)
    slots on the 'model' group, dispatch and return.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    axes = mesh_axes(mesh)
    E, k = cfg.n_experts, cfg.experts_per_token
    M = axes["model"]
    if E % M:
        raise ValueError(f"ep_moe_forward: {E} experts do not divide the "
                         f"model axis ({M})")
    dims = list(axes)
    on_data = tuple(Shard(0) if a == "data" else Replicate() for a in dims)
    on_model = tuple(Shard(0) if a == "model" else Replicate() for a in dims)
    whole = tuple(Replicate() for _ in dims)
    x_l = _local(x, mesh, on_data)
    router = _local(params["router"], mesh, whole)
    wg, wu, wd = (_local(params[n], mesh, on_model)
                  for n in ("wg", "wu", "wd"))
    G_l, S, D = x_l.shape
    C = capacity(S, E, k, cfg.capacity_factor)

    logits = x_l @ router.to(x_l.dtype)                         # (G_l, S, E)
    dispatch, gate, _, valid = _route_group(logits, k, C, E)
    token_idx = torch.where(valid, dispatch // k,
                            torch.full_like(dispatch, S))
    xe = _gather_slots(x_l, token_idx)                          # (G_l, E, C, D)

    # dispatch: chunk m (the slots of model rank m's experts) goes to rank
    # m; what comes back from rank m are its groups' slots for my experts
    group = mesh.get_group("model")
    send = xe.reshape(G_l, M, E // M, C, D).transpose(0, 1)
    recv = _exchange(send, group).reshape(M * G_l, E // M, C, D)
    act = _act(cfg)
    g = torch.einsum("gecd,edf->gecf", recv, wg.to(recv.dtype))
    u = torch.einsum("gecd,edf->gecf", recv, wu.to(recv.dtype))
    ye = torch.einsum("gecf,efd->gecd", act(g) * u, wd.to(recv.dtype))
    # return: the inverse exchange, my groups' outputs of every expert
    back = _exchange(ye.reshape(M, G_l, E // M, C, D), group)
    ye_b = back.transpose(0, 1).reshape(G_l, E, C, D)
    y_l = _combine(ye_b, gate, dispatch, valid, token_idx)
    y = DTensor.from_local(y_l, mesh, on_data)
    if return_dispatch:
        return y, DTensor.from_local(dispatch, mesh, on_data)
    return y
