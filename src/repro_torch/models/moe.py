"""Token-choice top-k MoE with sort-based capacity dispatch.

The port of the reference's ``models/moe.py``, plain PyTorch (the reference
has no kernel here).  Routing is local to a group (one sequence): each group
routes its own tokens with per-group capacity C = ceil(S*k/E * cf); tokens
past an expert's capacity are dropped.  Dispatch and combine are gathers and
scatters over the (G, E, C, D) slot tensor, and the expert FFN is one
batched matmul per projection over the E axis.  The reference's per-group
``vmap`` is written out as a leading group axis.

With ``cfg.moe_dispatch_dtype = "float8_e4m3fn"`` the slots cross the
expert-parallel boundary as the reference's DeepSeek-V3-style payload: each
slot scaled by its own max (``amax(|slot|) / 448 + 1e-12``, 448 being
e4m3's largest finite value), cast to e4m3, and dequantized after the
boundary (:func:`quantize_slots`, :func:`dequantize_slots`): D + 4 bytes a
slot against 2 D in bfloat16.  Plain torch ops, as the reference's are
plain ``jnp``; autograd runs through the casts as JAX's VJP does (the
cotangent is cast to e4m3 too).

``moe_ref`` is the capacity-unbounded dense oracle used by tests.

Sharded execution (DTensor inputs inside an ``activation_mesh``), as the
reference's partitioner lowers it: the router's logits are computed whole
on each rank for its own groups (its d_model shard gathered,
:func:`repro_torch.parallel.act.gathered_product`); each token's top-k
experts are chosen on the routing probabilities all-gathered over the
batch axes (:func:`_batch_top_k`), as the reference's compiled top_k runs
on the whole batch; the routing, the
gather into slots and the combine run group by group
(:func:`repro_torch.parallel.act.per_shard`: DTensor has no sharding rule
for their sorts and indexed scatters, ``index_put_`` with ``accumulate``,
and a group's routing is local to it anyway); the slot tensor is
constrained to (groups, experts); the expert products run on each rank's
own slots with the weights' FSDP shard gathered, their gradients
reduce-scattered.  Where the experts are sharded (expert parallelism),
the slots never cross ranks: each rank gathers the slots of its own
experts, and scatters its own (groups, experts) shard of the outputs
into a whole-batch result (zeros outside its groups), a partial sum that
an all-reduce over each mesh axis completes, as GSPMD replicates the
reference's scatter; the slots' gradients stay on their shard.  The
explicit expert-parallel forward with its two all-to-alls is
:mod:`repro_torch.parallel.ep_moe`.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.numerics import fma32_t
from repro_torch.parallel.act import (BATCH, TP, constrain, gathered_product,
                                      is_sharded, mesh_axes, per_shard,
                                      redistribute, reduce_over, shard_start,
                                      slice_to)

__all__ = ["moe_params_shapes", "moe_forward", "moe_ref", "capacity",
           "quantize_slots", "dequantize_slots", "E4M3_MAX", "timed_parts"]

#: e4m3's largest finite value, the top of each slot's scaled range
E4M3_MAX = 448.0
#: its float32 reciprocal: the reference's compiled program divides by the
#: constant 448 as XLA rewrites it, a product with this reciprocal (an
#: eager division rounds differently in about half the slots)
_E4M3_INV_MAX = float(np.float32(1.0) / np.float32(E4M3_MAX))
#: the slot tensor's dims, as ``per_shard`` names them
_SLOT_DIMS = ("g", "e", "c")


#: the stamp taker of :func:`timed_parts`, while one is entered
_STAMP: List = [None]


def _mark(part: str) -> None:
    """Stamp the end of ``moe_forward``'s part ``part`` (nothing unless
    :func:`timed_parts` is entered)."""
    if _STAMP[0] is not None:
        _STAMP[0](part)


@contextlib.contextmanager
def timed_parts(device):
    """Within the block, time the parts of each ``moe_forward``: route
    and gather (``route``), ``quantize`` (e4m3), the EP boundary
    (``exchange``), ``dequantize``, the expert ``products`` and the
    ``combine``.  On a card by CUDA events on the current stream, else by
    the host's clock.  Yields a dict part -> seconds, summed over the
    forwards and filled at the block's end."""
    dev = torch.device(device)
    stamps: List[tuple] = []
    if dev.type == "cuda":
        def stamp(part):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            stamps.append((part, event))
    else:
        def stamp(part):
            stamps.append((part, time.perf_counter()))
    parts: Dict[str, float] = {}
    if _STAMP[0] is not None:
        raise RuntimeError("timed_parts: already entered")
    _STAMP[0] = stamp
    try:
        yield parts
    finally:
        _STAMP[0] = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for (_, a), (part, b) in zip(stamps, stamps[1:]):
        if part == "start":
            continue
        took = (a.elapsed_time(b) / 1e3 if dev.type == "cuda" else b - a)
        parts[part] = parts.get(part, 0.0) + took


def capacity(tokens_per_group: int, n_experts: int, k: int, cf: float) -> int:
    """Per-expert slot count C for one routing group.

    ``ceil(tokens * k / n_experts * cf)``, floored at 1 — the padded slot
    tensor is ``(n_experts, C, d_model)`` regardless of actual routing.
    """
    return max(1, math.ceil(tokens_per_group * k / n_experts * cf))


def moe_params_shapes(cfg) -> Dict[str, tuple]:
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return dict(router=(D, E), wg=(E, D, F_), wu=(E, D, F_), wd=(E, F_, D),
                norm=(D,))


def _act(cfg):
    if cfg.mlp_act == "silu":
        return F.silu
    return lambda a: F.gelu(a, approximate="tanh")


def _route_group(router_logits: torch.Tensor, k: int, C: int, E: int,
                 expert_idx: torch.Tensor = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Every group's routing at once.  router_logits: (G, S, E);
    ``expert_idx`` (G, S, k): each token's top-k experts where they were
    already chosen (:func:`_batch_top_k`), else chosen here.

    Returns (dispatch_idx (G, E, C) into each group's S*k assignment list
    with sentinel S*k, gate (G, S, k), expert of each assignment (G, S*k),
    valid mask (G, E, C)).
    """
    G, S, _ = router_logits.shape
    dev = router_logits.device
    probs = torch.softmax(router_logits.float(), dim=-1)
    if expert_idx is None:
        expert_idx = torch.topk(probs, k, dim=-1).indices         # (G, S, k)
    gate = torch.gather(probs, -1, expert_idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_expert = expert_idx.reshape(G, S * k)                    # (G, S*k)
    ar = torch.arange(S * k, device=dev)
    # stable sort by expert id (ties keep token order)
    order = torch.argsort(flat_expert * (S * k) + ar, dim=-1)
    sorted_expert = torch.gather(flat_expert, 1, order)
    counts = torch.zeros(G, E, dtype=torch.long, device=dev).scatter_add_(
        1, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, dim=-1) - counts                # exclusive
    rank = ar - torch.gather(starts, 1, sorted_expert)            # within-expert slot
    slot = torch.where(rank < C, sorted_expert * C + rank,
                       torch.full_like(rank, E * C))              # overflow -> dropped
    dispatch = torch.full((G, E * C + 1), S * k, dtype=torch.long, device=dev)
    dispatch.scatter_(1, slot, order)                             # sentinel slot E*C
    dispatch = dispatch[:, :E * C].reshape(G, E, C)
    valid = dispatch < S * k
    return dispatch, gate, flat_expert, valid


def _route(logits: torch.Tensor, expert_idx=None, *, k: int, C: int,
           E: int):
    """:func:`_route_group` and each slot's token (sentinel S = no token)."""
    S = logits.shape[1]
    dispatch, gate, flat_expert, valid = _route_group(
        logits, k, C, E, expert_idx=expert_idx)
    token_idx = torch.where(valid, dispatch // k,
                            torch.full_like(dispatch, S))
    return dispatch, gate, flat_expert, valid, token_idx


def _batch_top_k(logits, k: int):
    """On a mesh, each token's top-k experts (G, S, k), chosen as the
    reference's partitioner chooses them: the routing probabilities (f32)
    all-gathered over the batch axes, one collective, the top-k taken on the
    whole batch, each rank keeping its own groups' rows (the same experts as
    its own rows' top-k: a row's choice is its own).  No gradient flows
    through the choice.  None off a mesh (the routing chooses them)."""
    if not is_sharded(logits):
        return None
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    whole = [Replicate() if a in BATCH else p
             for a, p in zip(mesh_axes(mesh), logits.placements)]
    with torch.no_grad():
        probs = redistribute(torch.softmax(logits.float(), dim=-1), mesh,
                             whole)
        idx = torch.topk(probs.to_local(), k, dim=-1).indices
        idx = DTensor.from_local(idx, mesh, whole, run_check=False)
        return redistribute(idx, mesh, logits.placements)


def _gather_slots(x: torch.Tensor, token_idx: torch.Tensor) -> torch.Tensor:
    """Tokens into expert slots: (G, S, D) -> (G, E, C, D); an empty slot
    reads the zero sentinel row."""
    G, S, D = x.shape
    _, E, C = token_idx.shape
    xpad = torch.cat([x, torch.zeros((G, 1, D), dtype=x.dtype,
                                     device=x.device)], dim=1)    # sentinel row
    gidx = torch.arange(G, device=x.device)[:, None]
    return xpad[gidx, token_idx.reshape(G, E * C)].reshape(G, E, C, D)


def _combine(ye: torch.Tensor, gate: torch.Tensor, dispatch: torch.Tensor,
             valid: torch.Tensor, token_idx: torch.Tensor, *,
             groups: int = 0, first: int = 0) -> torch.Tensor:
    """Expert outputs (G, E, C, D) back to tokens (G, S, D), weighted by
    each assignment's gate.  With ``groups``, the result has that many
    groups, these G written from group ``first`` on and zeros elsewhere."""
    G, E, C, D = ye.shape
    S, k = gate.shape[1], gate.shape[2]
    gidx = torch.arange(first, first + G, device=ye.device)[:, None]
    gate_flat = torch.cat([gate.reshape(G, S * k),
                           torch.zeros((G, 1), device=ye.device)], dim=1)
    assign_gate = torch.gather(
        gate_flat, 1, torch.where(valid, dispatch, torch.full_like(
            dispatch, S * k)).reshape(G, E * C)).reshape(G, E, C)
    # bf16 accumulation, as the reference: each token sums <= k outputs
    y = torch.zeros((groups or G, S + 1, D), dtype=ye.dtype, device=ye.device)
    y.index_put_((gidx[:, :, None].expand(G, E, C), token_idx),
                 ye * assign_gate[..., None].to(ye.dtype), accumulate=True)
    return y[:, :S]


def _experts_sharded(t) -> bool:
    """True where a mesh dim shards the slot tensor's experts (dim 1)."""
    from torch.distributed.tensor import Shard

    return is_sharded(t) and Shard(1) in t.placements


def _fsdp_gathered(w):
    """An expert weight with its FSDP (batch-axes) shard gathered, its
    other placements kept: the reference's partitioner gathers the weight
    and keeps each rank's slots where they are, and the gradient is
    reduce-scattered back (DTensor's own choice for the product gathers
    the slots of every group instead)."""
    if not is_sharded(w):
        return w
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    want = [Replicate() if a in BATCH else p
            for a, p in zip(mesh_axes(mesh), w.placements)]
    if want == list(w.placements):
        return w
    return redistribute(w, mesh, want)


def _top1_one_hot(flat_expert: torch.Tensor, *, k: int, E: int
                  ) -> torch.Tensor:
    """(G, S, E) one-hot of each token's first expert, f32."""
    G = flat_expert.shape[0]
    return F.one_hot(flat_expert.reshape(G, -1, k)[..., 0], E).float()


def _slot_scale(xf: torch.Tensor) -> torch.Tensor:
    """Each slot's scale, ``amax(|slot|) / 448 + 1e-12`` in float32, with
    the reference's compiled bits: XLA turns the division by the constant
    into a product with its reciprocal and fuses that product and the sum
    into one multiply-add, rounded once.  The value is that fused result
    (:func:`repro_torch.numerics.fma32_t`, exact); the gradient is
    the product's and the sum's, ``1 / 448`` to the max, as JAX's."""
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = amax * _E4M3_INV_MAX + 1e-12
    with torch.no_grad():
        fused = fma32_t(amax, _E4M3_INV_MAX, 1e-12)
        # within an ulp of the two-rounding value: the difference is exact
        step = fused - scale
    return scale + step


def _quantize_local(xe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = xe.float()
    scale = _slot_scale(xf)
    return (xf / scale).to(torch.float8_e4m3fn), scale


def quantize_slots(xe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots (G, E, C, D) -> (e4m3 payload (G, E, C, D), float32 scale (G,
    E, C, 1)): the scale is the slot's largest magnitude over 448 (plus
    1e-12, so an empty slot quantizes to zeros), the payload the slot over
    its scale, rounded to nearest even; ``|payload| <= 448`` by
    construction.  A DTensor is quantized shard by shard with each D row
    whole (a D shard is gathered first), so the max spans the row."""
    return per_shard(_quantize_local, (xe,), (_SLOT_DIMS + ("d",),),
                     (_SLOT_DIMS + ("d",), _SLOT_DIMS + ("one",)),
                     frozenset(_SLOT_DIMS))


def _dequantize_local(xq: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    return (xq.float() * scale).to(dtype)


def dequantize_slots(xq: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """The payload times its scale in float32, rounded to ``dtype``.  A
    DTensor runs shard by shard, so a gradient that arrives as a partial
    sum over the mesh is summed in ``dtype`` before its cast to e4m3, as
    GSPMD sums it, never as float8 partials."""
    return per_shard(_dequantize_local, (xq, scale),
                     (_SLOT_DIMS + ("d",), _SLOT_DIMS + ("one",)),
                     (_SLOT_DIMS + ("d",),), frozenset(_SLOT_DIMS),
                     dtype=dtype)


def moe_forward(params: Dict, x: torch.Tensor, cfg, *,
                return_dispatch: bool = False):
    """x: (G, S, D) grouped tokens -> (y, aux_loss), and with
    ``return_dispatch`` the (G, E, C) dispatch table the forward routed by
    (each slot's assignment index, as ``ep_moe_forward``'s) as well."""
    G, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(S, E, k, cfg.capacity_factor)
    _mark("start")
    logits = gathered_product(x, params["router"])                # (G, S, E)
    slots = _SLOT_DIMS
    groups = frozenset({"g"})
    dispatch, gate, flat_expert, valid, token_idx = per_shard(
        _route, (logits, _batch_top_k(logits, k)),
        (("g", "s", "e"), ("g", "s", "k")),
        (slots, ("g", "s", "k"), ("g", "a"), slots, slots), groups,
        k=k, C=C, E=E)

    # switch-style load-balance aux loss (ahead of the combine, whose
    # reductions then end the layer: a checkpoint's recompute stops at the
    # combine's last saved tensor, before them, as XLA's remat does)
    # reductions (the means' sums over the batch axes completed at once)
    probs = torch.softmax(logits.float(), dim=-1)
    me = reduce_over(probs.mean(dim=(0, 1)))                      # (E,)
    one_hot = per_shard(_top1_one_hot, (flat_expert,), (("g", "a"),),
                        (("g", "s", "e"),), groups, k=k, E=E)
    ce = reduce_over(one_hot.reshape(-1, E).mean(dim=0))
    aux = E * torch.sum(me * ce)

    # gather tokens into expert slots: token of assignment a is a // k;
    # where the slots' EP layout is a slice of the table's (the groups not
    # on 'model'), each rank gathers its own experts' slots, so the EP
    # boundary below moves nothing and the slots' gradient stays on its rank
    token_idx = slice_to(token_idx, BATCH, TP, None)
    xe = per_shard(_gather_slots, (x, token_idx), (("g", "s", "d"), slots),
                   (slots + ("d",),), frozenset({"g", "e"}))
    _mark("route")
    # EP boundary: groups on the batch axis, experts on the model axis;
    # the optional fp8 payload crosses it quantized, with its scales
    if getattr(cfg, "moe_dispatch_dtype", "bfloat16").startswith("float8"):
        xq, scale = quantize_slots(xe)
        _mark("quantize")
        xq = constrain(xq, BATCH, TP, None, None)
        scale = constrain(scale, BATCH, TP, None, None)
        _mark("exchange")
        xe = dequantize_slots(xq, scale, x.dtype)
        _mark("dequantize")
    else:
        xe = constrain(xe, BATCH, TP, None, None)
        _mark("exchange")

    # expert FFN: (E, G*C, D) @ (E, D, F) per projection
    act = _act(cfg)
    wg, wu, wd = (_fsdp_gathered(params[n]).to(x.dtype)
                  for n in ("wg", "wu", "wd"))
    xe_e = xe.permute(1, 0, 2, 3).reshape(E, G * C, D)
    g = xe_e @ wg
    u = xe_e @ wu
    ye = (act(g) * u) @ wd                                        # (E, G*C, D)
    ye = ye.reshape(E, G, C, D).permute(1, 0, 2, 3)               # (G, E, C, D)
    ye = constrain(ye, BATCH, TP, None, None)
    _mark("products")

    # combine: scatter expert outputs back to tokens with gate weights
    args = (ye, gate, dispatch, valid, token_idx)
    arg_dims = (slots + ("d",), ("g", "s", "k"), slots, slots, slots)
    if _experts_sharded(ye):
        # each rank its own (groups, experts) shard into the whole batch,
        # summed as GSPMD sums the reference's scatter: one all-reduce over
        # 'model', one over the batch axes at once, then its groups kept;
        # the tables move to the slots' layout (a slice, or a small
        # exchange where the groups also lie on 'model'), never the slots
        args = (ye, constrain(gate, BATCH, None, None),
                *(constrain(t, BATCH, TP, None)
                  for t in (dispatch, valid, token_idx)))
        y = per_shard(_combine, args, arg_dims, (("all", "s", "d"),),
                      frozenset(), summed=frozenset({"g", "e"}), groups=G,
                      first=shard_start(ye, 0))
        y = constrain(constrain(reduce_over(y, TP), None, None, None),
                      BATCH, None, None)
    else:
        y = per_shard(_combine, args, arg_dims, (("g", "s", "d"),), groups)
    _mark("combine")
    if return_dispatch:
        return y, aux, dispatch
    return y, aux


def moe_ref(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Capacity-unbounded dense oracle: every token goes to its top-k experts."""
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = x @ params["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    act = _act(cfg)
    # run every expert on every token (test sizes only)
    g = torch.einsum("gsd,edf->gsef", x, params["wg"].to(x.dtype))
    u = torch.einsum("gsd,edf->gsef", x, params["wu"].to(x.dtype))
    ye = torch.einsum("gsef,efd->gsed", act(g) * u, params["wd"].to(x.dtype))
    mask = F.one_hot(idx, E).float() * gate[..., None]            # (G,S,k,E)
    w = mask.sum(dim=2)                                           # (G,S,E)
    return torch.einsum("gsed,gse->gsd", ye.float(), w).to(x.dtype)
