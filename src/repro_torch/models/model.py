"""LM model wrapper: params init, forward, chunked loss, prefill/decode.

The port of the reference's ``models/model.py``.  Parameters are a plain
dict of tensors with the reference's tree and names:
``{"embed", "blocks": [per-pattern-position dict with a leading (R,) axis],
"final_norm", "head"}``, so weights carry over path by path
(``repro_torch.interop.params_from_reference``).

:func:`loss_fn` is the reference's sequence-chunked cross-entropy: it never
materializes (B, S, V), and with ``cfg.remat`` under autograd each chunk's
logits are recomputed in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` around its chunk body does.

Sharded execution: with DTensor parameters and batch inside
:class:`repro_torch.parallel.act.activation_mesh`, the embedded input and
each loss chunk's logits are constrained where the reference constrains
them; the embedding lookup takes the layout the reference's partitioner
gives it (:func:`repro_torch.parallel.act.embed_rows`: each model rank
looks up its own rows of the table, zeros for the others' rows, then one
all-reduce; or the table's rows move; or its whole rows are gathered over
'model'), and the per-position loss runs shard by shard
(:func:`repro_torch.parallel.act.per_shard`); where the vocabulary is
sharded, each rank reduces its own block and three all-reduces of (B, c)
complete the log-sum-exp and the label's logit, as the reference's
partitioner does (the logits are never gathered).  The head's d_model
(FSDP) shard is gathered once for all the forward's chunks and once in
each chunk's recompute (:class:`_GatheredHead`), as the reference's
compiled scan gathers it: 9 times a step with 8 chunks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.parallel.act import (BATCH, TP, constrain, embed_rows,
                                      gathered_product, is_sharded,
                                      per_shard, redistribute, reduce_over,
                                      reduced_grad, shard_start)

from .layers import init_linear, mrope_positions, rms_norm, rope_angles
from .transformer import (block_param_shapes, blocks_decode, blocks_forward,
                          blocks_prefill, init_block_cache)

__all__ = ["param_shapes", "init_params", "forward_hidden", "loss_fn",
           "prefill", "decode_step", "init_cache", "make_rope", "dtype_of"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``param_dtype`` / ``compute_dtype``."""
    return _DTYPES[name]


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Nested dict of shape tuples (leading repeat axis on block params)."""
    R = cfg.n_repeats

    def mark(tree):
        if isinstance(tree, dict):
            return {k: mark(v) for k, v in tree.items()}
        return (R, *tree)

    out: Dict[str, Any] = dict(
        embed=(cfg.vocab_size, cfg.d_model),
        blocks=[mark(block_param_shapes(cfg, spec)) for spec in cfg.pattern],
        final_norm=(cfg.d_model,))
    if not cfg.tie_embeddings:
        out["head"] = (cfg.d_model, cfg.vocab_size)
    return out


_BIAS_NAMES = {"bq", "bk", "bv", "conv_b", "dt_bias"}


def init_params(cfg: ArchConfig, seed: int = 0,
                device: Union[str, torch.device, None] = DEFAULT_DEVICE
                ) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``: truncated normal / sqrt(fan_in) for every weight,
    then the reference's special initialisation (``_fix_special_init``)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def build(tree, name=""):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, name) for v in tree]
        return _special_init(name, tree, dtype, gen, dev)

    return build(param_shapes(cfg))


def _special_init(name: str, shape, dtype, gen, dev) -> torch.Tensor:
    """One leaf: the reference's ``_fix_special_init`` applied to a draw —
    norms 1, biases 0, ``A_log = log(1..N)`` and ``D = 1`` in f32, the
    embedding rescaled to std 0.02; every other weight the draw itself."""
    if name.startswith("norm") or name == "final_norm":
        return torch.ones(shape, dtype=dtype, device=dev)
    if name in _BIAS_NAMES:
        return torch.zeros(shape, dtype=dtype, device=dev)
    if name == "A_log":   # mamba: A = -exp(A_log); A_log = log(1..N)
        N = shape[-1]
        base = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                      device=dev))
        return base.expand(shape).contiguous()
    if name == "D":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    d = init_linear(shape, dtype, gen, dev)
    if name == "embed":
        std = torch.clamp(d.float().std(correction=0), min=1e-6)
        d = (d.float() / std * 0.02).to(dtype)
    return d


# --------------------------------------------------------------------------
# rope helper
# --------------------------------------------------------------------------

def make_rope(cfg: ArchConfig, B: int, S: int, offset: int = 0, device=None):
    if not cfg.causal:
        return None                      # encoder-only: frontend supplies pos info
    if cfg.mrope_sections is not None:
        pos = mrope_positions(B, S, 0, device=device) + offset
        return rope_angles(pos, cfg.head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    if isinstance(offset, torch.Tensor) and offset.dim() > 0:
        pos = offset[:, None] + torch.arange(S, device=device)[None, :]
    else:
        pos = torch.arange(S, device=device)[None, :].repeat(B, 1) + offset
    return rope_angles(pos, cfg.head_dim, cfg.rope_theta)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _take_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def _lookup(table, tokens, dims):
    """The embedding rows of ``tokens`` (dims: their labels).  On a mesh
    whose model axis shards the table's rows, the lookup runs in the layout
    the reference's partitioner gives it
    (:func:`repro_torch.parallel.act.embed_rows`: the tokens gathered and
    each rank's own rows looked up, the table's rows moved, or its whole
    rows gathered over 'model'), and the result is constrained to the
    batch; elsewhere the table is gathered whole first (DTensor has no
    sharding rule for an indexed gather on a sharded table)."""
    if is_sharded(table):
        got = embed_rows(table, tokens, _take_rows)
        if got is not None:
            return constrain(got, BATCH, *([None] * (got.dim() - 1)))
    return per_shard(_take_rows, (table, tokens), (("v", "d"), dims),
                     (dims + ("d",),), frozenset(dims))


def _embed_in(params, batch, cfg):
    dtype = dtype_of(cfg.compute_dtype)
    if "embeds" in batch:                     # stub frontends (vlm/audio)
        return constrain(batch["embeds"].to(dtype), BATCH, None, None)
    x = _lookup(params["embed"], batch["tokens"], ("b", "s"))
    return constrain(x.to(dtype), BATCH, None, None)


def forward_hidden(params, batch, cfg):
    """Final hidden states (before the final norm) and the MoE aux loss."""
    x = _embed_in(params, batch, cfg)
    B, S, _ = x.shape
    rope = make_rope(cfg, B, S, device=x.device)
    return blocks_forward(list(params["blocks"]), x, cfg, rope)


def _head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _head_logits(h, hw):
    """``(h @ hw).float()``; on a mesh shard by shard, the head's d_model
    (FSDP) shard gathered first (:func:`~repro_torch.parallel.act.
    gathered_product`)."""
    return gathered_product(h, hw).float()


def _logits(params, h, cfg):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head_logits(h, _head_weight(params, cfg))


def _token_nll(logits, ls):
    """Per position: (-log p(label), label present).  logits (B, c, V) f32;
    ls (B, c), -1 = no label."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, ls.clamp(min=0).long()[..., None])[..., 0]
    valid = ls >= 0
    return torch.where(valid, lse - tgt, torch.zeros_like(lse)), valid


def _label_logit(logits, ls, *, first: int = 0):
    """Each position's logit of its label where the label lies in this
    block of the vocabulary (columns ``first`` on), else 0."""
    V = logits.shape[-1]
    idx = ls.long() - first
    own = (idx >= 0) & (idx < V)
    got = torch.gather(logits, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
    return torch.where(own, got, torch.zeros_like(got))


def _sharded_token_nll(logits, ls):
    """:func:`_token_nll` of logits whose vocabulary is sharded, as the
    reference's partitioner runs it: each rank's block gives its max, its
    sum of exponentials and its label logits, and an all-reduce of each
    (B, c) completes them; the logits are never gathered."""
    m = constrain(logits.detach().amax(-1), BATCH, None)
    z = constrain(torch.exp(logits - m[..., None]).sum(-1), BATCH, None)
    tgt = per_shard(_label_logit, (logits, ls), (("b", "c", "v"),
                                                 ("b", "c")),
                    (("b", "c"),), frozenset({"b", "c"}),
                    summed=frozenset({"v"}), first=shard_start(logits, -1))
    lse = m + torch.log(z)
    valid = ls >= 0
    nll = torch.where(valid, lse - constrain(tgt, BATCH, None),
                      torch.zeros_like(lse))
    return nll, valid


def _vocab_sharded(logits) -> bool:
    from torch.distributed.tensor import Shard

    return is_sharded(logits) and Shard(logits.dim() - 1) in \
        logits.placements


def _d_gathered(w):
    """The DTensor head weight ``w`` (D, V) with its d_model (FSDP) shard
    gathered, its other placements kept."""
    from torch.distributed.tensor import Replicate, Shard

    return redistribute(w, w.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 0 else p
        for p in w.placements])


class _GatheredHead(torch.autograd.Function):
    """The head weight with its d_model shard gathered: ``held["w"]``, the
    weight the forward gathered once before its chunks, where ``held``
    has it, else gathered here (a chunk's recompute in the backward, after
    the forward has dropped it); the gradient is reduced back onto the
    shard, once a chunk, as the reference reduces it."""

    @staticmethod
    def forward(ctx, w, held):
        ctx.source = tuple(w.placements)
        whole = held.get("w")
        return (_d_gathered(w) if whole is None else whole).detach()

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, grad.device_mesh, ctx.source), None


def _chunk_nll(hs, ls, hw, held=None):
    """One loss chunk: (sum of the valid positions' -log p(label) in f32,
    count of valid positions).  hs (B, c, D); ls (B, c), -1 = no label;
    ``held``: see :class:`_GatheredHead` (a sharded head only).  On a mesh
    whose model axis shards the vocabulary, the head's input gradient (a
    partial sum over the axis, in hs's dtype) is all-reduced here, a chunk
    at a time, as the reference's partitioner reduces it inside its loss
    scan (a bf16 all-reduce of (B, c, D) a chunk in its partitioned HLO of
    qwen2-7b ``train_4k``)."""
    hs = reduced_grad(hs)
    if held is not None:
        hw = _GatheredHead.apply(hw, held)
    logits = constrain(_head_logits(hs, hw), BATCH, None, TP)
    if _vocab_sharded(logits):
        nll, valid = _sharded_token_nll(logits, ls)
    else:
        nll, valid = per_shard(_token_nll, (logits, ls),
                               (("b", "c", "v"), ("b", "c")),
                               (("b", "c"), ("b", "c")),
                               frozenset({"b", "c"}))
    return nll.sum(), valid.sum(dtype=torch.int32)


def loss_fn(params, batch, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence-chunked softmax cross-entropy (never materializes (B, S, V)).

    ``batch``: ``tokens`` (B, S) or stub-frontend ``embeds`` (B, S, D), and
    ``labels`` (B, S) with -1 for no label.  S is padded to a multiple of
    ``min(cfg.loss_chunk, S)`` with -1 labels; each chunk's logits are
    ``(h @ head).float()``; the per-position loss is ``logsumexp`` minus the
    target logit; the sum runs chunk by chunk in f32 and is divided by
    ``max(count, 1)``.  Returns ``(loss + router_aux_coef * aux,
    dict(loss=, aux=, tokens=))``."""
    h, aux = forward_hidden(params, batch, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    labels = batch["labels"]
    B, S, D = h.shape
    c = min(cfg.loss_chunk, S)
    pad = (-S) % c
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    hw = _head_weight(params, cfg)
    held = None
    if is_sharded(hw):
        # gathered once for the forward's chunks, dropped after them: each
        # chunk's recompute gathers it again
        with torch.no_grad():
            held = dict(w=_d_gathered(hw))
    remat = cfg.remat and torch.is_grad_enabled()
    # the chunks' partial sums add up as they are (on a mesh, a sum with a
    # replicated zero would complete each chunk's one axis at a time), and
    # each total is completed once, in one all-reduce over every axis
    tot = cnt = None
    for c0 in range(0, S + pad, c):
        args = (h[:, c0:c0 + c], labels[:, c0:c0 + c], hw, held)
        if remat:
            s, n = checkpoint(_chunk_nll, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            s, n = _chunk_nll(*args)
        tot = s if tot is None else tot + s
        cnt = n if cnt is None else cnt + n
    if held is not None:
        held.clear()
    tot, cnt = reduce_over(tot), reduce_over(cnt)
    loss = tot / torch.clamp(cnt, min=1)
    total = loss + cfg.router_aux_coef * aux
    return total, dict(loss=loss, aux=aux, tokens=cnt)


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, B: int, max_len: int,
               device=None) -> List[Dict]:
    dtype = dtype_of(cfg.compute_dtype)
    R = cfg.n_repeats
    caches = []
    for spec in cfg.pattern:
        c = init_block_cache(cfg, spec, B, max_len, dtype, device)
        caches.append({k: v.expand(R, *v.shape).clone() for k, v in c.items()})
    return caches


def prefill(params, batch, cfg, max_len: int):
    """Returns (last-position logits (B, V) f32, caches).  Encoder-only:
    (all logits (B, S, V), None)."""
    x = _embed_in(params, batch, cfg)
    B, S, _ = x.shape
    rope = make_rope(cfg, B, S, device=x.device)
    if not cfg.causal:
        h, _ = blocks_forward(list(params["blocks"]), x, cfg, rope)
        return _logits(params, h, cfg), None
    h, caches = blocks_prefill(list(params["blocks"]), x, cfg, rope, max_len)
    return _logits(params, h[:, -1:], cfg)[:, 0], caches


def decode_step(params, token, caches, cur_pos, cfg):
    """token: (B,) int (or (B, D) embeds for stub frontends); cur_pos: the
    position being decoded, an int or a 0-d integer tensor on the model's
    device (read on the device, never on the host).  Returns (logits (B, V)
    f32, new caches)."""
    dtype = dtype_of(cfg.compute_dtype)
    if token.dim() == 2:                   # stub frontend embeds
        x = token.to(dtype)[:, None, :]
    else:
        x = _lookup(params["embed"], token, ("b",)).to(dtype)[:, None, :]
    B = x.shape[0]
    rope = make_rope(cfg, B, 1, offset=cur_pos, device=x.device)
    h, new_caches = blocks_decode(list(params["blocks"]), caches, x, cfg,
                                  rope, cur_pos)
    return _logits(params, h, cfg)[:, 0], new_caches
