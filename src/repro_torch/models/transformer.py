"""Block assembly: (attn | mamba) mixer + (dense | MoE) FFN, a loop over
repeats.

The port of the reference's ``models/transformer.py``.  A model is
``pattern`` applied ``n_repeats`` times; parameters for pattern position p
are stacked with a leading (R,) axis, and the reference's ``lax.scan`` over
repeats is a Python loop over that axis here (so is the decode caches'
leading axis).  With ``cfg.remat``,
when autograd records, each repeat of the pattern in :func:`blocks_forward`
runs under ``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, as the reference's ``jax.checkpoint`` around
its scan body recomputes them.  The recompute launches the repeat's kernels
again, so a training step with remat launches K5 and K3 twice per layer.

Routing to the hand-written kernels, on a CUDA tensor: every ``norm1`` /
``norm2`` goes to K5 (through ``layers.rms_norm``); prefill attention of a
layer without a window and without a query offset goes to K3
(``kernels.flash_attention``); the Mamba prefill scan goes to K4 (through
``models.mamba``).  K3, like the reference's Pallas kernel, has no window
and no query offset: a windowed layer, or a query offset, runs the plain
``chunked_attention`` on whatever device its tensors are, as the reference
runs every layer.  Decode attention is plain PyTorch everywhere.

Sharded execution: inside :class:`repro_torch.parallel.act.activation_mesh`
with DTensor parameters and batch, ``constrain`` redistributes activations
at the reference's call sites (the hidden state between blocks, q / k / v
on their heads, or k / v on head_dim for MQA), DTensor propagates the
rest op by op, and attention runs shard by shard through
:func:`repro_torch.parallel.act.per_shard` (batch- and head-sharded; a
head_dim or sequence shard is gathered first, since K3 and the plain
attention need them whole).  Where the query heads divide the model axis
and the kv heads do not (kimi-k2's 64 / 8 at 16, jamba's 32 / 8), q and
the output stay on their own heads' shards and only k and v are whole on
the axis, each rank reading the kv heads its query heads read
(:func:`_kv_whole_attention`).  Where the query heads do not divide it
either, ``act.split_dim`` gathers q / k / v's uneven shard before
splitting out the heads; where the kv heads (more than one) divide the
axis (qwen2-7b's 28 / 4 at 16), each rank computes its kv group's
attention (7 heads, not all 28) and keeps its own columns of the output,
those of ``wo``'s row shard (:func:`_kv_group_attention`); elsewhere
(gemma-2b's 8 / 1) the train and prefill steps take the reference
partitioner's padded layout (:func:`_padded_heads_attention`): each model
rank computes attention for its own heads only, and the result is
reduce-scattered onto ``wo``'s row shards.
Decode gathers the uneven heads:
``act.split_dim`` gathers its q before splitting the kv groups, and
``act.merge_last`` flattens the attention output on the local tensor, so
that its backward gathers the gradient's shard on the flattened dim before
unflattening it; and it gathers a head_dim shard (decode beside a cache
sharded on head_dim) before the output projection.  The serving steps run
sharded too: the prefill caches are the tail of k / v padded to the cache
length, and a decode step writes its slot by a select over the cache, so
its position may be a 0-d tensor.  On plain tensors none of this changes
a bit.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as K3
from repro_torch.parallel.act import (BATCH, TP, axis_groups, constrain,
                                      gather_dim, merge_last,
                                      model_axis_size, padded_heads,
                                      per_shard, redistribute, reduced_grad,
                                      split_dim, split_last)

from .attention import chunked_attention
from .layers import apply_rope, gated_mlp, rms_norm
from .mamba import (mamba_decode_step, mamba_forward, mamba_params_shapes,
                    mamba_prefill)
from .moe import moe_forward, moe_params_shapes

__all__ = ["block_param_shapes", "blocks_forward", "blocks_prefill",
           "blocks_decode", "init_block_cache", "attn_cache_len"]


# --------------------------------------------------------------------------
# parameter shape declarations (one dict per pattern position; stacked by R)
# --------------------------------------------------------------------------

def _attn_shapes(cfg) -> Dict[str, tuple]:
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = dict(wq=(D, H * hd), wk=(D, Kv * hd), wv=(D, Kv * hd), wo=(H * hd, D))
    if cfg.qkv_bias:
        s.update(bq=(H * hd,), bk=(Kv * hd,), bv=(Kv * hd,))
    return s


def block_param_shapes(cfg, spec) -> Dict[str, Any]:
    """Shapes for one pattern position (without the leading repeat axis)."""
    D = cfg.d_model
    p: Dict[str, Any] = dict(norm1=(D,))
    if spec.kind == "attn":
        p["attn"] = _attn_shapes(cfg)
    else:
        p["mamba"] = mamba_params_shapes(cfg)
    if spec.moe:
        p["norm2"] = (D,)
        p["moe"] = moe_params_shapes(cfg)
        del p["moe"]["norm"]
    elif cfg.d_ff:
        p["norm2"] = (D,)
        p["mlp"] = dict(wg=(D, cfg.d_ff), wu=(D, cfg.d_ff), wd=(cfg.d_ff, D))
    if spec.kind == "mamba":
        del p["mamba"]["norm"]
    return p


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def _qkv(p, x, cfg, S):
    """q, k, v on their heads; each projection's input gradient is reduced
    on its own (:func:`~repro_torch.parallel.act.reduced_grad`), as the
    reference's partitioner reduces it: three all-reduces on a mesh."""
    B = x.shape[0]
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = reduced_grad(x) @ p["wq"]
    k = reduced_grad(x) @ p["wk"]
    v = reduced_grad(x) @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(split_last(q, H, hd), BATCH, None, TP, None)
    k, v = split_last(k, Kv, hd), split_last(v, Kv, hd)
    if Kv == 1:   # MQA: the single kv head cannot carry TP — shard head_dim
        k = constrain(k, BATCH, None, None, TP)
        v = constrain(v, BATCH, None, None, TP)
    else:
        k = constrain(k, BATCH, None, TP, None)
        v = constrain(v, BATCH, None, TP, None)
    return q, k, v


def _attend(q, k, v, *, causal: bool, window, chunk: int, q_offset: int):
    """Prefill attention on whole sequences and heads: K3 on the card where
    it applies (no window, no query offset), else the plain chunked
    attention."""
    if q.device.type == "cuda" and window is None and q_offset == 0:
        return K3.flash_attention_cuda(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=chunk, k_chunk=chunk, q_offset=q_offset)


#: attention's dims for :func:`per_shard`: batch and heads are independent
_ATTN_DIMS = ("b", "s", "h", "d")
_ATTN_FREE = frozenset({"b", "h"})


def _attn_sublayer(p, x, cfg, spec, rope, q_offset=0,
                   return_kv: bool = False):
    M = model_axis_size(x)
    q, k, v = _qkv(p, x, cfg, x.shape[1])
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kw = dict(causal=cfg.causal, window=spec.window, chunk=cfg.attn_chunk,
              q_offset=q_offset)
    if M > 1 and cfg.n_heads % M == 0 and cfg.n_kv_heads % M:
        o = _kv_whole_attention(q, k, v, cfg, M, **kw)
        out = merge_last(o) @ p["wo"]
    elif M > 1 and cfg.n_heads % M and cfg.n_kv_heads > 1 and \
            M % cfg.n_kv_heads == 0:
        out = _kv_group_attention(q, k, v, p["wo"], cfg, M, **kw)
    elif M > 1 and (cfg.n_heads % M or cfg.n_kv_heads % M):
        out = _padded_heads_attention(q, k, v, p["wo"], cfg, M, **kw)
    else:
        o = per_shard(_attend, (q, k, v), (_ATTN_DIMS,) * 3, (_ATTN_DIMS,),
                      _ATTN_FREE, **kw)
        out = merge_last(o) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def _kv_whole_attention(q, k, v, cfg, M: int, **kw):
    """Attention on a mesh whose model axis (M wide) divides the query heads
    but not the kv heads, as the reference's partitioner runs it: q and the
    output stay on their own heads' shards (H / M a rank), k and v are
    whole on the axis (gathered where their heads are split out), and each
    rank passes attention the kv heads its query heads read, in K3's
    grouped layout (:func:`_grouped_kv`).  The output meets ``wo``'s row
    shards as it is; dK and dV are partial sums over the axis (each rank
    its own kv heads'), reduced onto k's and v's shards."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    m = list(mesh.mesh_dim_names).index(TP)
    _, kvh = zip(*padded_heads(cfg.n_heads, cfg.n_kv_heads, M,
                               mesh.get_local_rank(TP)))
    kv = _grouped_kv(kvh)
    heads = list(q.placements)                  # Shard(2) on 'model'
    whole = heads[:m] + [Replicate()] + heads[m + 1:]
    summed = heads[:m] + [Partial()] + heads[m + 1:]
    # k / v: whole on the axis (MQA's head_dim shard gathered)
    k, v = (redistribute(t, mesh, whole) for t in (k, v))

    def local(q, k, v):
        k, v = (torch.cat([t[:, :, h:h + 1] for h in kv], dim=2)
                for t in (k, v))
        return _attend(q, k, v, **kw)

    run = local_map(local, out_placements=heads,
                    in_placements=(heads, whole, whole),
                    in_grad_placements=(heads, summed, summed),
                    device_mesh=mesh)
    return run(q, k, v)


def _kv_group_attention(q, k, v, wo, cfg, M: int, **kw):
    """Attention and the output projection on a mesh whose model axis (M
    wide) the query heads do not divide and the kv heads (Kv > 1) do, as
    the reference's partitioner runs it (qwen2-7b's 28 / 4 at 16, read
    from its HLO): the axis's ranks in Kv groups of R = M / Kv, each group
    one kv group's G query heads, every rank of a group computing that
    group's attention, and each keeping only its own w = H hd / M columns
    of the output, which are the columns of ``wo``'s row shard on that
    rank, so the output meets ``wo`` where it lies (no reduce-scatter of
    a padded output).  q, k and v arrive whole on the axis (the uneven
    shard is gathered where the heads are split out).  The backward is the
    reference's (:class:`_GatheredGrad`): the output's gradient is
    all-gathered over the R ranks of the kv group, so that each rank
    computes its group's dq, dk and dv whole, and those are all-gathered
    over the Kv groups: every rank ends with the whole gradients, and none
    is a partial sum.  The two gathers run on subgroups of the model axis
    (:func:`~repro_torch.parallel.act.axis_groups`)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G, R, w = H // Kv, M // Kv, H * hd // M
    mesh = q.device_mesh
    r = mesh.get_local_rank(TP)
    g, c0 = r // R, (r % R) * w
    act = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
           else Replicate() for pl in q.placements]
    names = mesh.mesh_dim_names
    cols = [Shard(2) if names[i] == TP else pl for i, pl in enumerate(act)]
    q, k, v = (t.redistribute(mesh, act) for t in (q, k, v))
    groups, in_group = axis_groups(mesh, TP, R)

    def local(q, k, v):
        o = _attend(_GatheredGrad.apply(q, g * G, G, groups),
                    _GatheredGrad.apply(k, g, 1, groups),
                    _GatheredGrad.apply(v, g, 1, groups), **kw)
        return _GatheredGrad.apply(o.reshape(*o.shape[:2], G * hd), c0, w,
                                   in_group)

    run = local_map(local, out_placements=cols,
                    in_placements=(act, act, act),
                    in_grad_placements=(act, act, act), device_mesh=mesh)
    return run(q, k, v) @ wo


class _GatheredGrad(torch.autograd.Function):
    """``t[:, :, lo:lo + n]``, whose gradient is all-gathered along dim 2
    over ``group`` (in its rank order): the ranks of ``group`` hold the
    other blocks of dim 2, so each ends with the gradient of the whole of
    ``t``.  :func:`_kv_group_attention` slices its kv group's heads of q,
    k and v (the gradient gathered over the groups) and its own columns of
    the group's output (the gradient gathered over the group's ranks)."""

    @staticmethod
    def forward(ctx, t, lo: int, n: int, group):
        ctx.group = group
        return t[:, :, lo:lo + n]

    @staticmethod
    def backward(ctx, grad):
        return gather_dim(grad, ctx.group, 2), None, None, None


def _padded_heads_attention(q, k, v, wo, cfg, M: int, **kw):
    """Attention and the output projection on a mesh whose model axis (M
    wide) the query or kv heads do not divide, in the reference
    partitioner's padded layout (:func:`repro_torch.parallel.act.
    padded_heads`): each model rank computes attention for its own heads
    only, each with its kv head, and places them among zero heads, a
    partial sum over the axis; that is reduce-scattered onto the flattened
    heads (the columns ``wo``'s rows are sharded by) and multiplied by
    ``wo`` row-parallel, as for evenly divided heads.  q, k, v arrive
    whole on the axis (the uneven shard is gathered where the heads are
    split out).  A zero head's query is zero and its output is dropped,
    so its dO is zero: q, k and v get no gradient from it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    H, hd = cfg.n_heads, cfg.head_dim
    mesh = q.device_mesh
    # per local head: its query head (None for a zero head) and kv head
    qh, kvh = zip(*padded_heads(H, cfg.n_kv_heads, M,
                                mesh.get_local_rank(TP)))
    # a rank's real heads are contiguous, in order, at local positions
    # [i0, i0 + len(real)) (zero heads only pad a group or the axis)
    real = [(i, h) for i, h in enumerate(qh) if h is not None]
    i0, h0 = real[0] if real else (0, 0)
    kv = _grouped_kv(kvh)

    act = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
           else Replicate() for pl in q.placements]
    names = mesh.mesh_dim_names
    part = [Partial() if names[i] == TP else pl for i, pl in enumerate(act)]
    # DTensor's own (only 'model' changes): where q, k or v already lies
    # so, its no-op is still an autograd node, whose backward completes a
    # partial gradient there (an all-reduce) before it flows on
    q, k, v = (t.redistribute(mesh, act) for t in (q, k, v))

    def pick(t, heads):
        """t's heads (dim 2) in the order given, a zero head for None (a
        product with t, so that a rank of zero heads still gives t a
        gradient, of zeros, and joins its reduction)."""
        zero = t[:, :, :1] * 0
        return torch.cat([zero if h is None else t[:, :, h:h + 1]
                          for h in heads], dim=2)

    def local(q, k, v):
        o = _attend(pick(q, qh), pick(k, kv), pick(v, kv), **kw)
        o = o[:, :, i0:i0 + len(real)]
        return F.pad(o, (0, 0, h0, H - h0 - len(real)))

    run = local_map(local, out_placements=part,
                    in_placements=(act, act, act),
                    in_grad_placements=(part, part, part), device_mesh=mesh)
    o = run(q, k, v)
    o = constrain(o.reshape(*o.shape[:2], H * hd), BATCH, None, TP)
    return o @ wo


def _grouped_kv(kvh) -> list:
    """The local heads' kv heads ``kvh`` as K3's grouped layout: each kv
    head once where ``kvh`` runs in equal groups of G (whole kv groups, or
    a share of one), local head i reading entry i // G, so that attention
    reads a kv head once and its backward sums the group; else ``kvh``
    itself, one kv head a query head."""
    g = next((i for i, h in enumerate(kvh) if h != kvh[0]), len(kvh))
    if len(kvh) % g or any(h != kvh[i - i % g] for i, h in enumerate(kvh)):
        g = 1
    return list(kvh[::g])


def _ffn_sublayer(p, x, cfg, spec) -> Tuple[torch.Tensor, torch.Tensor]:
    if spec.moe:
        return moe_forward(p["moe"], x, cfg)                      # groups = batch
    return (gated_mlp(x, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"],
                      cfg.mlp_act),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _one_block(spec, p, x, cfg, rope, cache_slice=None, cur_pos=None):
    """Apply mixer + ffn.  If cache_slice is given we are decoding (S == 1)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        if cache_slice is None:
            h = _attn_sublayer(p["attn"], h, cfg, spec, rope)
        else:
            h, new_cache = _attn_decode(p["attn"], h, cfg, spec, rope,
                                        cache_slice, cur_pos)
    else:
        if cache_slice is None:
            h = mamba_forward(p["mamba"], h, cfg)
        else:
            h, new_cache = mamba_decode_step(p["mamba"], h, cache_slice, cfg)
    x = x + h
    if "norm2" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        h, aux = _ffn_sublayer(p, h, cfg, spec)
        x = x + h
    return x, aux, new_cache


def _repeat(tree, r: int):
    """Repeat ``r`` of a stacked parameter (or cache) dict."""
    if isinstance(tree, dict):
        return {k: _repeat(v, r) for k, v in tree.items()}
    return tree[r]


def _stack(trees: List[Dict]) -> Dict:
    """Stack per-repeat dicts along a new leading (R,) axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _unstack(tree, R: int) -> List:
    """The R per-repeat dicts of a stacked parameter dict, by ``unbind``
    (whose backward stacks the R gradients once, where indexing each repeat
    would write a zero-filled (R, ...) gradient per repeat)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, R) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(R)]
    return list(torch.unbind(tree, 0))


def _repeat_body(pattern, cfg, rope, h, aux, *per_position):
    """One repeat of the pattern: (hidden, aux) in, (hidden, aux) out."""
    for spec, p in zip(pattern, per_position):
        h = constrain(h, BATCH, None, None)
        h, a, _ = _one_block(spec, p, h, cfg, rope)
        aux = aux + a
    return constrain(h, BATCH, None, None), aux


def blocks_forward(block_params: List[Dict], x: torch.Tensor, cfg, rope
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop over repeats; returns (hidden, total_aux_loss).  With
    ``cfg.remat`` under autograd, each repeat is checkpointed."""
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    R = cfg.n_repeats
    per_repeat = list(zip(*(_unstack(p, R) for p in block_params)))
    remat = cfg.remat and torch.is_grad_enabled()
    for params_r in per_repeat:
        if remat:
            h, aux = checkpoint(_repeat_body, cfg.pattern, cfg, rope, h, aux,
                                *params_r, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = _repeat_body(cfg.pattern, cfg, rope, h, aux, *params_r)
    return h, aux


# --------------------------------------------------------------------------
# decode (+ cache plumbing)
# --------------------------------------------------------------------------

def attn_cache_len(cfg, spec, max_len: int) -> int:
    if spec.window is not None:
        return min(spec.window, max_len)
    return max_len


def init_block_cache(cfg, spec, B: int, max_len: int, dtype,
                     device=None) -> Optional[Dict]:
    """Cache dict for ONE pattern position (without the repeat axis)."""
    if spec.kind == "attn":
        L = attn_cache_len(cfg, spec, max_len)
        Kv, hd = cfg.n_kv_heads, cfg.head_dim
        return dict(k=torch.zeros((B, L, Kv, hd), dtype=dtype, device=device),
                    v=torch.zeros((B, L, Kv, hd), dtype=dtype, device=device),
                    pos=torch.full((L,), -1, dtype=torch.int32, device=device))
    return dict(conv=torch.zeros((B, cfg.ssm_conv - 1, cfg.d_inner),
                                 dtype=dtype, device=device),
                ssm=torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                                dtype=torch.float32, device=device))


def _attn_decode(p, x, cfg, spec, rope, cache, cur_pos):
    """One decode position.  ``cur_pos`` is an int or a 0-d integer tensor
    (no host read): the new k / v go into slot ``cur_pos % L`` by a select
    over the cache, which writes the same values an indexed store would."""
    q, k, v = _qkv(p, x, cfg, 1)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    L = cache["k"].shape[1]
    at = torch.arange(L, device=x.device) == cur_pos % L         # the slot
    kc = torch.where(at[None, :, None, None], k.to(cache["k"].dtype),
                     cache["k"])
    vc = torch.where(at[None, :, None, None], v.to(cache["v"].dtype),
                     cache["v"])
    posc = torch.where(at, cur_pos, cache["pos"]).to(cache["pos"].dtype)
    o = _decode_attn_with_slots(q, kc, vc, posc, cur_pos, spec.window)
    out = merge_last(o) @ p["wo"]
    return out, dict(k=kc, v=vc, pos=posc)


def _decode_attn_with_slots(q, k_cache, v_cache, slot_pos, cur_pos, window):
    B, _, H, hd = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    qg = split_dim(q[:, 0], 1, Kv, G)                            # (B,Kv,G,hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) / math.sqrt(hd)
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos)
    if window is not None:
        valid &= slot_pos > cur_pos - window
    s = s.masked_fill(~valid[None, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _cache_rows(t, L: int):
    """``t`` (B, keep, Kv, hd) as the first rows of a zero (B, L, Kv, hd)
    cache (a sharded ``t`` stays sharded)."""
    pad = L - t.shape[1]
    return F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def blocks_prefill(block_params: List[Dict], x: torch.Tensor, cfg, rope,
                   max_len: int) -> Tuple[torch.Tensor, List[Dict]]:
    """Forward over the prompt AND build the decode caches (leading (R,) axis)."""
    B, S, _ = x.shape
    h = x
    per_repeat: List[List[Dict]] = [[] for _ in cfg.pattern]
    for r in range(cfg.n_repeats):
        for i, (spec, p_all) in enumerate(zip(cfg.pattern, block_params)):
            p = _repeat(p_all, r)
            h = constrain(h, BATCH, None, None)
            hn = rms_norm(h, p["norm1"], cfg.norm_eps)
            if spec.kind == "attn":
                out, (k, v) = _attn_sublayer(p["attn"], hn, cfg, spec, rope,
                                             return_kv=True)
                L = attn_cache_len(cfg, spec, max_len)
                keep = min(S, L)
                # windowed layers keep the tail (window | S for our shapes)
                kc, vc = (_cache_rows(t[:, S - keep:], L) for t in (k, v))
                ar = torch.arange(L, device=k.device)
                pos = torch.where(ar < keep, ar + (S - keep),
                                  torch.full_like(ar, -1))
                cache = dict(k=kc, v=vc, pos=pos.to(torch.int32))
            else:
                out, cache = mamba_prefill(p["mamba"], hn, cfg)
            h = h + out
            if "norm2" in p:
                hn = rms_norm(h, p["norm2"], cfg.norm_eps)
                out, _ = _ffn_sublayer(p, hn, cfg, spec)
                h = h + out
            per_repeat[i].append(cache)
    return h, [_stack(c) for c in per_repeat]


def blocks_decode(block_params: List[Dict], caches: List[Dict],
                  x: torch.Tensor, cfg, rope, cur_pos
                  ) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step through all layers.  caches[p] has a leading (R,) axis;
    ``cur_pos`` is an int or a 0-d integer tensor."""
    h = x
    per_repeat: List[List[Dict]] = [[] for _ in cfg.pattern]
    for r in range(cfg.n_repeats):
        for i, (spec, p, c) in enumerate(zip(cfg.pattern, block_params,
                                             caches)):
            h, _, nc = _one_block(spec, _repeat(p, r), h, cfg, rope,
                                  cache_slice=_repeat(c, r), cur_pos=cur_pos)
            per_repeat[i].append(nc)
    return h, [_stack(c) for c in per_repeat]
