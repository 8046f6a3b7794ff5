"""Logical sharding rules -> partition specs for params, optimizer, batches,
caches; and their placement on a device mesh.

The port of the reference's ``parallel/sharding.py``.

Mesh axes:
  single-pod : ('data', 'model')            = (16, 16)
  multi-pod  : ('pod', 'data', 'model')     = (2, 16, 16)

Policy (the reference's baseline):

* batch          -> ('pod', 'data')   (pure DP across pods, FSDP within)
* TP (``'model'``) -> heads / d_ff / vocab / experts
* FSDP (``'data'``) -> the d_model axis of every weight matrix (ZeRO-3
  style; DTensor gathers each weight where an op needs it whole)
* long-context decode (batch < data axis) -> KV-cache sequence dim on
  ``'data'`` (sequence parallelism for the cache)

``param_pspecs`` is the single source of truth for which parameter axes are
``'model'``-sharded: the workload lowering (:mod:`repro_torch.core.
workloads`) divides each parameter's gradient bytes by its tensor-parallel
shard factor and counts the ``'model'``-sharded matmul pairs that emit TP
collectives.  It passes a duck-typed mesh: the rules read only its axis
names and sizes (:func:`.act.mesh_axes`, which also reads a
``DeviceMesh``), so no devices are needed to evaluate them.  A spec is a
:class:`P`, the port's stand-in for ``jax.sharding.PartitionSpec``.

Execution: :func:`to_shardings` turns a tree of specs into
:class:`NamedSharding` leaves (a ``DeviceMesh`` and the DTensor placements
of the spec, :func:`.act.placements_for`), and :func:`device_put` places a
tree of tensors by such a tree, the counterpart of ``jax.device_put(tree,
shardings)``: every rank holds the same full tensor and keeps its own
shard, with no exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M

from .act import (BATCH, TP, _axis_size, _div, activation_mesh,  # noqa: F401
                  batch_axes, constrain, pick_tp_dim, placements_for)

__all__ = ["P", "batch_axes", "param_pspecs", "opt_pspecs", "batch_pspecs",
           "cache_pspecs", "to_shardings", "pick_tp_dim", "activation_mesh",
           "constrain", "BATCH", "TP", "NamedSharding", "device_put",
           "reshard", "serving_batch_axes"]


class P(tuple):
    """A partition spec: one entry per array axis, each ``None``
    (replicated), a mesh-axis name, or a tuple of names (a one-name tuple
    stands for the name, as ``jax.sharding.PartitionSpec`` has it)."""

    def __new__(cls, *entries: Any) -> "P":
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))


def _param_rule(name: str, shape: Tuple[int, ...], cfg: ArchConfig, mesh: Any,
                fsdp: str = "data") -> P:
    """Name+rank based partition spec (leading dim may be the repeat axis)."""
    f = fsdp if _div(cfg.d_model, mesh, fsdp) else None

    def guard(spec: P, sh) -> P:
        # drop any axis assignment whose dim is not divisible
        out = []
        for dim, ax in zip(sh, tuple(spec) + (None,) * (len(sh) - len(spec))):
            if ax is None:
                out.append(None)
            else:
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = int(np.prod([_axis_size(mesh, a) for a in axes]))
                out.append(ax if dim % size == 0 else None)
        return P(*out)

    if name == "embed":
        return guard(P("model", f), shape)
    if name == "head":
        return guard(P(f, "model"), shape)
    if name in ("final_norm",):
        return P()
    # block params: leading repeat axis
    body = shape[1:]
    if name in ("wq", "wk", "wv", "in_proj"):          # (D, out)
        return guard(P(None, f, "model"), shape)
    if name in ("wo", "out_proj"):                     # (in, D)
        return guard(P(None, "model", f), shape)
    ep = _div(cfg.n_experts, mesh, "model") if cfg.n_experts else False
    if name in ("wg", "wu"):
        if len(body) == 2:                              # dense mlp (D, F)
            return guard(P(None, f, "model"), shape)
        if ep:                                          # moe (E, D, F): EP
            return guard(P(None, "model", f, None), shape)
        return guard(P(None, None, f, "model"), shape)  # few experts: TP on F
    if name == "wd":
        if len(body) == 2:                              # dense mlp (F, D)
            return guard(P(None, "model", f), shape)
        if ep:
            return guard(P(None, "model", None, f), shape)
        return guard(P(None, None, "model", f), shape)
    if name == "router":                                # (D, E)
        return guard(P(None, f, None), shape)
    if name in ("conv_w",):                             # (K, Di)
        return guard(P(None, None, "model"), shape)
    if name in ("conv_b", "dt_bias", "D"):              # (Di,)
        return guard(P(None, "model"), shape)
    if name in ("x_proj", "A_log"):                     # (Di, *)
        return guard(P(None, "model", None), shape)
    if name == "dt_proj":                               # (dt_rank, Di)
        return guard(P(None, None, "model"), shape)
    if name in ("bq", "bk", "bv"):                      # (H*hd,)
        return guard(P(None, "model"), shape)
    if name.startswith("norm"):
        return P()
    return P()                                          # safe default: replicate


def param_pspecs(cfg: ArchConfig, mesh: Any) -> Dict[str, Any]:
    """Partition-spec tree matching ``models.model.param_shapes(cfg)``.

    Args:
      cfg: the architecture; expert/TP divisibility guards read its widths.
      mesh: any object with ``.axis_names`` and ``.shape`` (name -> size),
        which is all the rules consult.

    Returns a tree with the same structure as ``param_shapes(cfg)`` (dicts
    and the list of pattern-position blocks) whose leaves are :class:`P`;
    zip-walking the two trees pairs every parameter shape with its spec.
    The shape tree's leaves are plain tuples of ints, so the walk descends
    dicts and lists only.
    """
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return _param_rule(name, tuple(tree), cfg, mesh)

    return walk(M.param_shapes(cfg))


def opt_pspecs(cfg: ArchConfig, mesh: Any) -> Dict[str, Any]:
    ps = param_pspecs(cfg, mesh)
    return dict(m=ps, v=ps, step=P())


# --------------------------------------------------------------------------
# batches / caches
# --------------------------------------------------------------------------

def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh: Any
                 ) -> Dict[str, P]:
    ba = batch_axes(mesh)
    bsz = int(np.prod([_axis_size(mesh, a) for a in ba]))
    b = ba if shape.global_batch % bsz == 0 else None
    if b is None and shape.global_batch % _axis_size(mesh, "data") == 0:
        b = ("data",)
    spec: Dict[str, P] = {}
    if cfg.frontend != "none":
        spec["embeds"] = P(b, None, None)
    else:
        spec["tokens"] = P(b, None)
    if shape.kind == "train":
        spec["labels"] = P(b, None)
    return spec


def serving_batch_axes(mesh: Any, B: int):
    """The mesh axes of a serving batch of ``B`` (the token, the logits):
    ('pod', 'data') where they divide it, else 'data' alone, else none --
    the reference's dry run's rule for its serving out-shardings."""
    ba = batch_axes(mesh)
    if B % int(np.prod([_axis_size(mesh, a) for a in ba])) == 0:
        return ba
    if B % _axis_size(mesh, "data") == 0:
        return ("data",)
    return None


def cache_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh: Any) -> List[Dict]:
    """Per-pattern-position cache partition specs (leading repeat axis)."""
    from repro_torch.models.transformer import attn_cache_len

    ba = batch_axes(mesh)
    bsz = int(np.prod([_axis_size(mesh, a) for a in ba]))
    shard_batch = shape.global_batch % bsz == 0
    b = ba if shard_batch else None
    # long-context, tiny batch: sequence-parallel cache
    seq_ax = None if shard_batch else "data"
    out = []
    for spec in cfg.pattern:
        if spec.kind == "attn":
            L = attn_cache_len(cfg, spec, shape.seq_len)
            kv_ok = cfg.n_kv_heads % _axis_size(mesh, "model") == 0
            hd_ok = cfg.head_dim % _axis_size(mesh, "model") == 0
            heads = "model" if kv_ok else None
            hd = "model" if (not kv_ok and hd_ok) else None
            sax = seq_ax if (seq_ax and L % _axis_size(mesh, "data") == 0) \
                else None
            out.append(dict(k=P(None, b, sax, heads, hd),
                            v=P(None, b, sax, heads, hd),
                            pos=P(None, sax)))
        else:
            di_ok = cfg.d_inner % _axis_size(mesh, "model") == 0
            di = "model" if di_ok else None
            out.append(dict(conv=P(None, b, None, di),
                            ssm=P(None, b, di, None)))
    return out


# --------------------------------------------------------------------------
# placement on a device mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the counterpart of
    ``jax.sharding.NamedSharding``.  ``placements`` are the spec's DTensor
    placements, one per mesh dim (:func:`.act.placements_for`)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(tuple(self.spec), self.mesh)


def to_shardings(pspecs, mesh: Any):
    """A tree of :class:`P` -> the same tree of :class:`NamedSharding`."""
    def walk(t):
        if isinstance(t, P):
            return NamedSharding(mesh, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        raise TypeError(f"to_shardings: leaf {t!r} is not a P")
    return walk(pspecs)


def device_put(tree, shardings):
    """Place every tensor of ``tree`` as a DTensor by the matching
    :class:`NamedSharding` of ``shardings`` (same structure).  Each rank
    passes the same full tensors (drawn from one seed) and keeps a copy of
    its shard: no data moves between ranks.  A 0-d tensor is replicated.
    Tensors must already be on the mesh's device type."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    flat, tdef = T.flatten(tree)
    shard_leaves = T.flatten(shardings)[0]
    if len(flat) != len(shard_leaves):
        raise ValueError(f"device_put: {len(flat)} tensors but "
                         f"{len(shard_leaves)} shardings")

    def put(t, s):
        local = distribute_tensor(t, s.mesh, s.placements,
                                  src_data_rank=None).to_local()
        # a copy where the shard is the caller's tensor or a view of a
        # larger one (which the caller then could not free); a shard in
        # storage of its own is kept, so that a whole leaf is not copied
        # again where its mesh axes have one rank
        store = local.untyped_storage()
        if store._cdata == t.untyped_storage()._cdata or \
                store.nbytes() > local.numel() * local.element_size():
            local = local.clone()
        return DTensor.from_local(local, s.mesh, s.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    return T.unflatten(tdef, [put(t, s) for t, s in zip(flat, shard_leaves)])


def reshard(tree, pspecs, mesh: Any):
    """Each tensor of ``tree`` at the placements of the matching :class:`P`
    of ``pspecs`` (same structure) on ``mesh``: a DTensor redistributed
    there (the counterpart of a jitted step's out-shardings), a plain
    tensor -- the same on every rank -- placed, which moves nothing."""
    from torch.distributed.tensor import distribute_tensor

    from .act import is_sharded, redistribute

    flat, tdef = T.flatten(tree)
    specs = T.flatten(to_shardings(pspecs, mesh))[0]
    if len(flat) != len(specs):
        raise ValueError(f"reshard: {len(flat)} tensors but {len(specs)} "
                         "specs")
    out = []
    for t, s in zip(flat, specs):
        if not is_sharded(t):
            out.append(distribute_tensor(t, s.mesh, s.placements,
                                         src_data_rank=None))
        elif tuple(t.placements) != s.placements:
            out.append(redistribute(t, s.mesh, s.placements))
        else:
            out.append(t)
    return T.unflatten(tdef, out)
