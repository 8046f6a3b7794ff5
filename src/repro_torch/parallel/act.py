"""Activation sharding constraints (mesh-context based).

The port of the reference's ``parallel/act.py``.  Model code calls
``constrain(x, *logical_axes)``; inside an :class:`activation_mesh` whose
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` it redistributes a
DTensor ``x`` to the placements the cleaned spec gives (the counterpart of
``jax.lax.with_sharding_constraint``).  Outside the context, or on a plain
tensor, it returns ``x`` itself, so single-device runs are unaffected.

A mesh here is either a ``DeviceMesh`` (its ``mesh_dim_names`` and sizes)
or any object with ``axis_names`` and a name -> size ``shape`` mapping, the
duck-typed mesh the rules accept (:func:`mesh_axes` reads both).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["activation_mesh", "constrain", "BATCH", "TP",
           "batch_axes", "pick_tp_dim", "mesh_axes", "clean_spec",
           "placements_for", "per_shard", "split_dim", "split_last",
           "merge_last", "is_sharded", "model_axis_size", "padded_heads",
           "contract_shards", "embed_rows", "shard_start",
           "gathered_product", "slice_to", "redistribute", "reduce_over",
           "reduced_grad", "permute", "axis_groups", "gather_dim",
           "embed_layout"]

# logical activation axes used by model code (resolved against the live mesh)
BATCH = ("pod", "data")
TP = "model"

_ACT_MESH: Optional[Any] = None


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, in mesh-dim order, of a ``DeviceMesh`` or of a
    duck-typed mesh (``axis_names`` and a ``shape`` mapping)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


class activation_mesh:
    """Context: model-internal ``constrain`` calls target this mesh.
    No-op (constraints vanish) when not entered."""

    def __init__(self, mesh: Optional[Any]):
        self.mesh = mesh

    def __enter__(self):
        global _ACT_MESH
        self._old = _ACT_MESH
        _ACT_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACT_MESH
        _ACT_MESH = self._old
        return False


def clean_spec(shape: Tuple[int, ...], spec: tuple, mesh: Any) -> tuple:
    """The reference's cleaning of a constraint: per dim, drop the axes
    absent from the mesh; keep the rest only if their product divides the
    dim and exceeds 1 (a lone axis as its name, several as a tuple)."""
    axes_of = mesh_axes(mesh)
    clean = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            clean.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in axes_of)
        size = int(np.prod([axes_of[a] for a in axes])) if axes else 1
        if axes and dim % size == 0 and size > 1:
            clean.append(axes if len(axes) > 1 else axes[0])
        else:
            # absent, non-dividing or size-1 axes: replicate (the
            # reference does not try a prefix of ('pod', 'data') either)
            clean.append(None)
    return tuple(clean)


def placements_for(spec: tuple, mesh: Any) -> tuple:
    """DTensor placements, one per mesh dim, of a partition spec (one entry
    per tensor dim).

    A spec maps tensor dims to mesh axes; placements go the other way, one
    per mesh dim: ``Shard(d)`` where tensor dim d names that axis, else
    ``Replicate()``.  A dim sharded over several axes, e.g. ``('pod',
    'data')``, takes one ``Shard(d)`` per axis; DTensor splits it in
    mesh-dim order (the first mesh dim outermost), which is the partition
    spec's major-to-minor order only when the entry lists its axes in
    mesh-dim order, so any other order is refused.  Axes absent from the
    mesh are dropped."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if a in order]
        if [order.index(a) for a in axes] != sorted(order.index(a)
                                                   for a in axes):
            raise ValueError(f"spec entry {entry!r} does not list its axes in "
                             f"mesh-dim order {tuple(order)}")
        for a in axes:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims in {spec}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in order)


def constrain(x, *spec):
    """Redistribute the DTensor ``x`` to ``spec`` (cleaned against the
    context mesh, as the reference cleans it); ``x`` itself outside an
    :class:`activation_mesh`, for ``None`` and for a plain tensor.  A
    float8 DTensor moves as the bytes of its uint8 view (gloo carries no
    float8 type), its gradient likewise."""
    mesh = _ACT_MESH
    if mesh is None or x is None or not is_sharded(x):
        return x
    want = placements_for(clean_spec(tuple(x.shape), spec, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    if x.dtype in _FLOAT8:
        return _RedistributeBytes.apply(x, mesh, want)
    return redistribute(x, mesh, want)


def slice_to(x, *spec):
    """:func:`constrain` where it only slices ``x``: every mesh dim whose
    placement it changes is replicated in ``x``, so each rank keeps a slice
    of its own and nothing moves; else ``x`` as it is."""
    from torch.distributed.tensor import Replicate

    mesh = _ACT_MESH
    if mesh is None or x is None or not is_sharded(x):
        return x
    want = placements_for(clean_spec(tuple(x.shape), spec, mesh), mesh)
    if all(p == w or p == Replicate() for p, w in zip(x.placements, want)):
        return constrain(x, *spec)
    return x


_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2, torch.float8_e4m3fnuz,
           torch.float8_e5m2fnuz)


def _redistribute_bytes(x, mesh, placements):
    """``x.redistribute(mesh, placements)`` done on the uint8 view of a
    float8 DTensor's local shard, viewed back: the same bytes move.  A
    ``Partial`` sum cannot move as bytes, and is refused."""
    from torch.distributed.tensor import DTensor, Partial

    if any(isinstance(p, Partial) for p in (*x.placements, *placements)):
        raise ValueError(f"constrain: a float8 DTensor moves as bytes and "
                         f"cannot be reduced ({x.placements} -> "
                         f"{placements})")
    b = DTensor.from_local(x.to_local().view(torch.uint8), x.device_mesh,
                           x.placements, shape=x.shape, stride=x.stride())
    b = _redistribute_grouped(b, mesh, placements)
    return DTensor.from_local(b.to_local().view(x.dtype), mesh, placements,
                              shape=b.shape, stride=b.stride())


class _RedistributeBytes(torch.autograd.Function):
    """:func:`_redistribute_bytes` forward, and its inverse on the float8
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.source = (x.device_mesh, tuple(x.placements))
        return _redistribute_bytes(x, mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return _redistribute_bytes(grad, *ctx.source), None, None


def redistribute(x, mesh, placements):
    """``x.redistribute(mesh, placements)``, with each change that the
    reference's partitioner makes over several mesh axes at once made as
    one collective over the flattened mesh of those axes, in mesh order
    (GSPMD's replica groups; DTensor runs one collective a mesh dim):

    * mesh dims that go from ``Partial`` to ``Replicate``: one all-reduce;
    * mesh dims that go from ``Shard(d)`` to ``Replicate``, all of d's
      shards and evenly: one all-gather;
    * mesh dims that go from ``Partial`` to ``Shard(d)``, where nothing
      else shards d, evenly: one reduce-scatter.

    Where two mesh dims (of more than one rank) take part in one of these
    or in a slice (``Replicate`` to ``Shard(d)``), or a slice comes before
    a collective, each rank first keeps its slices, then the sums run, all
    in one all-reduce, then the reduce-scatters and the gathers, and
    DTensor's own redistribute makes whatever is left; elsewhere it is
    DTensor's own throughout.  The gradient is redistributed the same way
    to what DTensor's backward gives it: to the source's placements, a
    sum's gradient kept as it arrives (an identity), a gather's
    reduce-scattered and a slice's gathered over the same flattened
    group."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    if not _grouped_steps(tuple(x.placements), placements, tuple(x.shape),
                          mesh):
        return x.redistribute(mesh, placements)
    return _GroupedRedistribute.apply(x, mesh, placements)


def reduce_over(x, *axes):
    """The DTensor ``x`` with its ``Partial`` sums over the mesh axes
    ``axes`` (every axis if none is named) completed, in one all-reduce
    over them, its other placements kept; ``x`` itself where it is not
    sharded or not partial there.  A sum that DTensor would otherwise
    complete inside the next op that needs it whole (a square, a
    division) runs one all-reduce a mesh dim there."""
    from torch.distributed.tensor import Replicate

    if not is_sharded(x):
        return x
    names = list(mesh_axes(x.device_mesh))
    axes = axes or tuple(names)
    want = tuple(Replicate() if a in axes and p.is_partial() else p
                 for a, p in zip(names, x.placements))
    return redistribute(x, x.device_mesh, want)


class _ReducedGrad(torch.autograd.Function):
    """The identity, whose gradient's ``Partial`` sums are completed where
    it arrives (:func:`reduce_over`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_over(grad)


def reduced_grad(x):
    """``x``, for one product's use: the partial sums of that use's input
    gradient are completed in an all-reduce of their own, before they meet
    the other uses' gradients, as the reference's partitioner reduces each
    product's partial result at the product (q, k and v's projections of
    one input: three all-reduces, where adding the partial gradients first
    would need one).  ``x`` itself off a mesh."""
    return _ReducedGrad.apply(x) if is_sharded(x) else x


def _shard_dim(p) -> Optional[int]:
    """The tensor dim of a plain ``Shard`` placement, else None."""
    from torch.distributed.tensor import Shard

    return p.dim if isinstance(p, Shard) and p == Shard(p.dim) else None


def _grouped_steps(src: tuple, dst: tuple, shape: tuple, mesh) -> list:
    """The steps :func:`redistribute` runs itself to take placements
    ``src`` towards ``dst``, in order: (kind, tensor dim, mesh dims), kind
    ``slice`` (replicated mesh dims that shard a dim nothing shards yet: each
    rank keeps its slice, first, so that what follows moves less), ``sum``
    (every ``Partial`` that goes to ``Replicate``: one all-reduce),
    ``scatter`` or ``gather``; [] (DTensor's own redistribute) where no
    sum, scatter or gather spans two mesh dims of more than one rank, and
    no slice comes before a collective."""
    n = len(src)
    sizes = [mesh.size(i) for i in range(n)]
    real = lambda dims: [i for i in dims if sizes[i] > 1]   # noqa: E731
    even = lambda d, dims: shape[d] % int(np.prod(          # noqa: E731
        [sizes[i] for i in dims])) == 0
    sums = [i for i in range(n) if src[i].is_partial()
            and dst[i].is_replicate()]
    slices, groups = [], []
    for d in range(len(shape)):
        shards = [i for i in range(n) if not src[i].is_partial()
                  and getattr(src[i], "dim", None) == d]
        gather = [i for i in shards if dst[i].is_replicate()]
        if gather and gather == shards and all(
                _shard_dim(src[i]) == d for i in gather):
            groups.append(("gather", d, gather))
        targets = [i for i in range(n) if _shard_dim(dst[i]) == d]
        if targets and not shards and all(src[i].is_partial()
                                          for i in targets):
            groups.append(("scatter", d, targets))
        cut = [i for i in targets if src[i].is_replicate()]
        if cut and not shards and even(d, cut):
            slices.append(("slice", d, cut))
    wide = lambda dims: len(real(dims)) > 1                 # noqa: E731
    groups = [(k, d, dims) for k, d, dims in groups
              if wide(dims) and even(d, dims)]
    ops = {src[i].reduce_op for i in sums} | {
        src[i].reduce_op for k, _, dims in groups if k == "scatter"
        for i in dims}
    cut = {i for _, _, dims in slices for i in real(dims)}
    moves = any(src[i] != dst[i] and i not in cut for i in range(n))
    if len(ops) > 1 or not (groups or wide(sums) or cut and moves or any(
            wide(dims) for _, _, dims in slices)):
        return []
    return slices + ([("sum", None, sums)] if sums else []) + groups


def _flat_group(mesh, dims: list):
    """The functional collectives' group of ``mesh``'s dims ``dims``: the
    mesh dim itself, or the mesh of several flattened in mesh order (made
    once, on real tensors: a fake trace runs this under a fake mode).  Dims
    that are not adjacent (('pod', 'model') beside 'data') are joined by a
    mesh of ``mesh``'s own ranks with those dims last, whose last dim is
    the group (the same ranks, in the same order, as DeviceMesh's
    flattening of them)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils._python_dispatch import _disable_current_modes

    if len(dims) == 1:
        return (mesh, dims[0])
    names = tuple(mesh.mesh_dim_names[i] for i in dims)
    if list(dims) == list(range(dims[0], dims[0] + len(dims))):
        with _disable_current_modes():
            return (mesh[names]._flatten(), 0)
    made = mesh.__dict__.setdefault("_repro_joined_groups", {})
    if names not in made:
        rest = [i for i in range(mesh.ndim) if i not in dims]
        with _disable_current_modes():
            layout = mesh.mesh.permute(*rest, *dims)
            joined = DeviceMesh(
                mesh.device_type,
                layout.reshape(*layout.shape[:len(rest)], -1),
                mesh_dim_names=tuple(mesh.mesh_dim_names[i] for i in rest)
                + ("_".join(names),))
        made[names] = (joined, len(rest))
    return made[names]


def _redistribute_grouped(x, mesh, placements):
    """:func:`redistribute` of the DTensor ``x`` outside autograd."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = tuple(placements)
    src = tuple(x.placements)
    steps = _grouped_steps(src, placements, tuple(x.shape), mesh)
    if not steps:
        return x.redistribute(mesh, placements)
    t, cur = x.to_local(), list(src)
    for kind, d, dims in steps:
        live = [i for i in dims if mesh.size(i) > 1]
        n = int(np.prod([mesh.size(i) for i in live]))
        if kind == "slice":
            for i in live:              # mesh order: the first outermost
                t = t.chunk(mesh.size(i), dim=d)[
                    mesh.get_local_rank(i)].contiguous()
        elif live:
            group = _flat_group(mesh, live)
            op = src[dims[0]].reduce_op if kind != "gather" else None
            if kind == "sum":
                t = funcol.all_reduce(t.contiguous(), op, group)
            elif kind == "scatter":
                if d:
                    t = torch.cat(t.chunk(n, dim=d), dim=0)
                t = _reduce_scatter_single(t.contiguous(), op, group)
            else:
                t = _all_gather_single(t.contiguous(), group)
                if d:
                    t = torch.cat(t.chunk(n, dim=0), dim=d)
        for i in dims:
            cur[i] = Shard(d) if kind in ("scatter", "slice") else Replicate()
    if isinstance(t, funcol.AsyncCollectiveTensor):
        t = t.wait()
    y = DTensor.from_local(t, mesh, cur, shape=x.shape, stride=x.stride())
    if tuple(cur) != placements:
        y = y.redistribute(mesh, placements)
    return y


def _all_gather_single(t, group):
    """The functional all-gather on dim 0 by the name this torch gives it
    (``all_gather_single`` from torch 2.12, ``all_gather_tensor`` before),
    looked up at the call, so that a staged replacement is the one run."""
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None)
    if gather is None:
        return funcol.all_gather_tensor(t, 0, group)
    return gather(t, 0, group)


def _reduce_scatter_single(t, op: str, group):
    """The functional reduce-scatter on dim 0, named as
    :func:`_all_gather_single` names its gather."""
    import torch.distributed._functional_collectives as funcol

    scatter = getattr(funcol, "reduce_scatter_single", None)
    if scatter is None:
        return funcol.reduce_scatter_tensor(t, op, 0, group)
    return scatter(t, op, 0, group)


def axis_groups(mesh, axis: str, inner: int) -> tuple:
    """The ranks of ``mesh``'s axis ``axis`` (n of them) split into n /
    ``inner`` groups of ``inner`` consecutive ranks, as two process groups
    for each rank, each a (mesh, dim) pair the functional collectives take:
    (the ranks at this rank's place in every group, in group order; the
    ranks of this rank's group, in order).  They are the dims of a mesh
    made once from ``mesh``'s own layout with ``axis`` split in two
    (outside any fake mode; every rank makes it at the same point, as any
    process group), so that the host staging and ``dryrun.Accounting``
    see them as groups of ``mesh``'s ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils._python_dispatch import _disable_current_modes

    made = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if (axis, inner) not in made:
        names = list(mesh.mesh_dim_names)
        i = names.index(axis)
        with _disable_current_modes():
            layout = mesh.mesh.clone()
            shape = list(layout.shape)
            shape[i:i + 1] = [shape[i] // inner, inner]
            split = DeviceMesh(mesh.device_type, layout.reshape(shape),
                               mesh_dim_names=tuple(
                                   names[:i] + [f"{axis}_groups",
                                                f"{axis}_in_group"]
                                   + names[i + 1:]))
        made[(axis, inner)] = ((split, i), (split, i + 1))
    return made[(axis, inner)]


def gather_dim(t, group, dim: int):
    """``t`` from every rank of ``group`` (a (mesh, dim) pair), joined along
    ``dim`` in the group's rank order: one all-gather."""
    import torch.distributed._functional_collectives as funcol

    n = group[0].size(group[1])
    got = _all_gather_single(t.contiguous(), group)
    if isinstance(got, funcol.AsyncCollectiveTensor):
        got = got.wait()
    return torch.cat(got.chunk(n, dim=0), dim=dim) if dim else got


class _GroupedRedistribute(torch.autograd.Function):
    """:func:`redistribute`: forward :func:`_redistribute_grouped`, and the
    gradient to the source's placements the same way, a ``Partial``
    source kept where the gradient is not one (DTensor's own backward
    skips that step too: the reduction would follow anyway)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.source = tuple(x.placements)
        return _redistribute_grouped(x, mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate

        want = tuple(Replicate() if s.is_partial() and not g.is_partial()
                     else s for s, g in zip(ctx.source, grad.placements))
        return (_redistribute_grouped(grad, grad.device_mesh, want), None,
                None)


def batch_axes(mesh: Any):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _axis_size(mesh: Any, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def _div(n: int, mesh: Any, axis: str) -> bool:
    return n % _axis_size(mesh, axis) == 0


def pick_tp_dim(mesh: Any, *dims: int) -> int:
    """Index (into dims) of the first dim divisible by the model axis, else -1."""
    for i, d in enumerate(dims):
        if d and _div(d, mesh, "model"):
            return i
    return -1


def split_dim(x, dim: int, *sizes):
    """``x`` with dim ``dim`` split into ``sizes``; for a DTensor whose
    ``dim`` is sharded on a mesh dim that ``sizes[0]`` does not divide
    (heads that do not divide the model axis), that shard is gathered
    first: DTensor cannot split an uneven shard in a view."""
    dim = dim % x.dim()
    if is_sharded(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh = x.device_mesh
        want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                     and sizes[0] % mesh.size(i) else p
                     for i, p in enumerate(x.placements))
        if want != tuple(x.placements):
            x = redistribute(x, mesh, want)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def split_last(x, *sizes):
    """``x.reshape(*x.shape[:-1], *sizes)`` (:func:`split_dim` of the last
    dim)."""
    return split_dim(x, -1, *sizes)


def merge_last(x):
    """``x.reshape(*x.shape[:-2], -1)``, the inverse of :func:`split_last`.

    Where a DTensor's dim -2 (the heads) does not divide a mesh dim, this
    is where an uneven shard is gathered in the backward: the gradient that
    reaches the flatten (from a product that contracts the merged dim,
    sharded on it) cannot be unflattened by DTensor's view there.  The
    flatten then runs shard by shard (:func:`per_shard`), whose backward
    first brings the gradient to the forward's placements (a shard on the
    merged dim is gathered), then unflattens it locally.  Elsewhere a shard
    on the last dim (head_dim, as decode attention leaves it beside a cache
    sharded on head_dim) is gathered first: merged into the heads it would
    be a strided shard, which the product after it cannot take."""
    if not is_sharded(x):
        return x.reshape(*x.shape[:-2], -1)
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    if any(x.shape[-2] % n for n in mesh.shape):
        lead = tuple(f"x{i}" for i in range(x.dim() - 2))
        return per_shard(_merge_local, (x,), (lead + ("h", "d"),),
                         (lead + ("hd",),), frozenset(lead))
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == x.dim() - 1
                 else p for p in x.placements)
    if want != tuple(x.placements):
        x = redistribute(x, mesh, want)
    return x.reshape(*x.shape[:-2], -1)


def _merge_local(t):
    return t.reshape(*t.shape[:-2], -1)


def model_axis_size(t) -> int:
    """The size of the model axis a DTensor ``t`` is placed on (1 for a
    plain tensor or a mesh without one)."""
    if not is_sharded(t):
        return 1
    return mesh_axes(t.device_mesh).get(TP, 1)


def padded_heads(H: int, Kv: int, model: int, rank: int) -> List[tuple]:
    """The heads rank ``rank`` of a ``model``-wide axis computes when the
    ``H`` query heads (``Kv`` kv groups of G = H / Kv) do not all divide it,
    in the reference partitioner's padded layout: (query head, kv head) per
    local head, ``None`` for a zero (padding) head.

    * H divides the axis: a contiguous share of H / model heads (the kv
      groups split inside);
    * else, Kv > 1: the kv groups are padded to a multiple of the axis and
      each rank takes whole groups, all G heads of each; a rank past the
      last group computes zero groups (qwen2-7b's 28 / 4 at 16: ranks 0-3
      one group of 7 heads each, ranks 4-15 7 zero heads, as the
      reference's per-device FLOP count shows);
    * else (one kv head): the query heads padded to a multiple of the axis,
      a contiguous share each (gemma-2b's 8 at 16: one head a rank)."""
    G = H // Kv
    if H % model == 0:
        n = H // model
        return [(j, j // G) for j in range(rank * n, (rank + 1) * n)]
    if Kv > 1:
        c = -(-Kv // model)
        return [(g * G + i, g) if g < Kv else (None, 0)
                for g in range(rank * c, (rank + 1) * c) for i in range(G)]
    n = -(-H // model)
    return [(j, 0) if j < H else (None, 0)
            for j in range(rank * n, (rank + 1) * n)]


def contract_shards(fn, a, w):
    """``fn(a, w)``, a product contracting ``a``'s last dim with ``w``'s
    first, run shard by shard where both are sharded alike on it (and
    ``a`` perhaps on its batch dim): each rank multiplies its own shards,
    a partial sum over the contraction's mesh dims, and its input gradient
    is its own shard's only (the gradient of the partial sum is whole on
    every rank).  DTensor's own choice for the backward gathers ``w`` and
    computes every shard's input gradient on each rank.  Anything else,
    and plain tensors, go to ``fn`` directly."""
    if not (is_sharded(a) and is_sharded(w)):
        return fn(a, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    last = a.dim() - 1
    out, w_grad = [], []
    for pa, pw in zip(a.placements, w.placements):
        if isinstance(pa, Shard) and pa.dim == last and pw == Shard(0):
            out.append(Partial())
            w_grad.append(Shard(0))
        elif isinstance(pa, Shard) and pa.dim == 0 and pw == Replicate():
            out.append(Shard(0))
            w_grad.append(Partial())
        elif pa == Replicate() and pw == Replicate():
            out.append(Replicate())
            w_grad.append(Replicate())
        else:
            return fn(a, w)
    run = local_map(fn, out_placements=out,
                    in_placements=(list(a.placements), list(w.placements)),
                    in_grad_placements=(list(a.placements), w_grad),
                    device_mesh=a.device_mesh)
    return run(a, w)


def _all_to_all(t, out_splits, in_splits, group):
    """The functional all-to-all of ``t``'s dim-0 rows (looked up at the
    call, so that a staged replacement is the one run), waited."""
    import torch.distributed._functional_collectives as funcol

    got = funcol.all_to_all_single(t, out_splits, in_splits, group)
    return got.wait() if isinstance(got, funcol.AsyncCollectiveTensor) \
        else got


def permute(t, pairs: dict, rank: int, size: int, group):
    """A collective-permute of ``t`` (on every rank of ``group``, ``size``
    ranks; this one ``rank``): sent from each source rank of ``pairs`` to
    its target, as one all-to-all.  A rank that sends nothing sends ``t``
    to itself, so that every rank passes the operand, as each device of
    XLA's collective-permute does.  What this rank got from its source, or
    None."""
    dst = pairs.get(rank, rank)
    src = next((s for s, d in pairs.items() if d == rank), None)
    n = t.shape[0]
    takes = [n if s == src or (s == rank and dst == rank) else 0
             for s in range(size)]
    got = _all_to_all(t.contiguous(), takes,
                      [n if d == dst else 0 for d in range(size)], group)
    if src is None:
        return None
    return got[n:] if dst == rank and rank < src else got[:n]


def _swap_pairs(n: int) -> dict:
    """The pairs of a permute over two flattened mesh dims of ``n`` ranks
    each that swaps a rank's two coordinates."""
    return {a * n + b: b * n + a for a in range(n) for b in range(n)
            if a != b}


class _TableToColumns(torch.autograd.Function):
    """A (V, D) table with its rows on the model axis and D on the data axis
    (as many ranks), to whole rows and D on the model axis, as the
    reference's partitioner moves it: each rank's block goes to the rank
    whose data and model coordinates are its own swapped (one permute over
    both axes: rank (d, m) then holds row block d and D block m), and the
    row blocks are all-gathered over 'data'.  The gradient, a partial sum
    over the axes that shard the tokens, is completed in one all-reduce
    over them, each rank keeps its row block, and the blocks go back by the
    same permute."""

    @staticmethod
    def forward(ctx, table, d: int, m: int):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = table.device_mesh
        n = mesh.size(m)
        lo, hi = sorted((d, m))
        group = _flat_group(mesh, [lo, hi])
        rank = mesh.get_local_rank(lo) * n + mesh.get_local_rank(hi)
        ctx.layout = (tuple(table.placements), table.shape, table.stride(),
                      d, group, rank, n)
        t = table.to_local()
        got = permute(t, _swap_pairs(n), rank, n * n, group)
        swapped = [Shard(0) if i == d else Shard(1) if i == m else p
                   for i, p in enumerate(table.placements)]
        out = DTensor.from_local(t if got is None else got, mesh, swapped,
                                 shape=table.shape, stride=table.stride())
        whole = [Replicate() if i == d else p for i, p in enumerate(swapped)]
        return _redistribute_grouped(out, mesh, whole)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        placements, shape, stride, d, group, rank, n = ctx.layout
        mesh = grad.device_mesh
        g = reduce_over(grad).to_local()
        rows = g.shape[0] // n
        own = g[mesh.get_local_rank(d) * rows:][:rows]
        got = permute(own, _swap_pairs(n), rank, n * n, group)
        return (DTensor.from_local(own if got is None else got, mesh,
                                   placements, shape=shape, stride=stride),
                None, None)


def _table_columns(table, m: int):
    """The DTensor ``table`` (V, D), its rows on mesh dim ``m`` (the model
    axis), with its rows whole and D on that dim: :class:`_TableToColumns`
    where D lies on the data axis alone and that axis is as wide as the
    model axis, else D's shard gathered and the model axis's shard moved
    from the rows to D (an all-to-all; DTensor's own path from one to the
    other gathers the whole table)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = table.device_mesh
    names = list(mesh_axes(mesh))
    cols = [Shard(1) if i == m else Replicate() for i in range(mesh.ndim)]
    d = names.index("data") if "data" in names else None
    rest = [p for i, p in enumerate(table.placements) if i not in (d, m)]
    if d is not None and table.placements[d] == Shard(1) and \
            mesh.size(d) == mesh.size(m) > 1 and \
            all(p == Replicate() for p in rest) and \
            not table.shape[0] % mesh.size(m) and \
            not table.shape[1] % mesh.size(m):
        return _TableToColumns.apply(table, d, m)
    rows = [Shard(0) if i == m else Replicate() for i in range(mesh.ndim)]
    return redistribute(redistribute(table, mesh, rows), mesh, cols)


def _batch_dims(x) -> set:
    """The mesh dims (of more than one rank) that shard the DTensor ``x``'s
    dim 0."""
    from torch.distributed.tensor import Shard

    return {i for i, p in enumerate(x.placements)
            if p == Shard(0) and x.device_mesh.size(i) > 1}


class _GatheredRows(torch.autograd.Function):
    """A table's row block (V / M, D / data) all-gathered over 'model' to
    whole rows (V, D / data), as the reference's partitioner gathers them
    for its row-gather layout.  The gradient (V, D / data), a partial sum
    over the ranks whose tokens it holds (``summed``: 'model', and 'pod'
    where the table is whole on it), is completed in one all-reduce over
    them, and each rank keeps its own row block (``own``), as the
    reference's HLO reduces it (not a reduce-scatter)."""

    @staticmethod
    def forward(ctx, block, group, summed, own: int):
        ctx.layout = (summed, own, block.shape[0])
        return gather_dim(block, group, 0)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed._functional_collectives as funcol

        summed, own, rows = ctx.layout
        g = funcol.all_reduce(grad.contiguous(), "sum", summed)
        if isinstance(g, funcol.AsyncCollectiveTensor):
            g = g.wait()
        return g[own * rows:(own + 1) * rows], None, None, None


class _Gathered(torch.autograd.Function):
    """``t`` all-gathered from the ranks of ``group`` along ``dim``, whose
    gradient, the same on every rank of the group, is this rank's own
    slice (``own``) of it: nothing moves back."""

    @staticmethod
    def forward(ctx, t, group, dim: int, own: int):
        ctx.block = (dim, own, t.shape[dim])
        return gather_dim(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, own, n = ctx.block
        return grad.narrow(dim, own * n, n), None, None, None


def _rows_lookup(table, tokens, take, d: int, m: int, spread: bool):
    """``take(table, tokens)`` in the reference partitioner's row-gather
    layout, on a mesh whose data and model axes (mesh dims ``d``, ``m``)
    are equally wide: the table's row blocks all-gathered over 'model'
    (whole rows, D still on 'data'); the tokens permuted over ('data',
    'model') to the rank whose two coordinates are its own swapped (rank
    (d, m) then holds the tokens of batch block m); each rank looks them up
    in its D block; the result all-gathered over 'model' (over ('pod',
    'model') where the batch lies on ('pod', 'data')): the whole batch, D
    on 'data'.  Where the batch lies on 'pod' too (``spread``), its D is
    then gathered over 'data' as well, as XLA does (it reports an
    "involuntary full rematerialization"), and the caller's constraint
    slices the batch.  The gradient: each rank's share of the table's,
    from its own tokens and D block, all-reduced over the result's group;
    the caller's constraint moves the result's own gradient (two
    all-to-alls over 'data', or one all-gather over ('pod', 'data'))."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = table.device_mesh
    n = mesh.size(m)
    dims, at = [m], mesh.get_local_rank(m)
    if spread:
        p = list(mesh_axes(mesh)).index("pod")
        dims, at = [p, m], at + mesh.get_local_rank(p) * n
    group = _flat_group(mesh, dims)
    whole = _GatheredRows.apply(table.to_local(), (mesh, m), group,
                                mesh.get_local_rank(m))
    own_ids = tokens.to_local()
    ids = permute(own_ids, _swap_pairs(n), mesh.get_local_rank(d) * n
                  + mesh.get_local_rank(m), n * n, _flat_group(mesh, [d, m]))
    ids = own_ids if ids is None else ids
    got = _Gathered.apply(take(whole, ids), group, 0, at)
    last = got.dim() - 1
    if spread:
        got = _Gathered.apply(got, (mesh, d), last, mesh.get_local_rank(d))
    out = [Shard(last) if i == d and not spread else Replicate()
           for i in range(mesh.ndim)]
    shape = (*tokens.shape, table.shape[1])
    return DTensor.from_local(got, mesh, out, shape=torch.Size(shape),
                              stride=tuple(int(np.prod(shape[i + 1:]))
                                           for i in range(len(shape))))


def _in_row_band(rows: int, d_model: int, tokens_batch: int, n: int,
                 pod: int) -> bool:
    """Whether ``rows`` lies in the band where the reference's partitioner
    gathers an embedding table's whole rows (:func:`embed_layout`), on a
    mesh whose data and model axes are both ``n`` wide, the batch's
    ``tokens_batch`` tokens on 'data' (``pod`` 1) or on ('pod', 'data')."""
    V, D, T = rows, d_model, tokens_batch
    if pod == 1:
        return T * D - 2 * n * n * T <= V * D < T * D + 2 * n * T
    return T <= V and (V * pod * (n + 1) < T * n * (pod + 1)
                       or V * D < T * D + 2 * n * T)


def _rows_placed(table, tokens, d: Optional[int], m: int,
                 spread: bool) -> bool:
    """Whether ``table`` and ``tokens`` lie as the row-gather layout was
    read: the table's rows on 'model', D on 'data' and nothing else
    sharded; the tokens' batch on 'data' (and on 'pod' where ``spread``)
    and nothing else; each dim dividing evenly."""
    from torch.distributed.tensor import Replicate, Shard

    if d is None:
        return False
    mesh = table.device_mesh
    names = list(mesh_axes(mesh))
    batch = {d} | ({names.index("pod")} if spread else set())
    n = mesh.size(m)
    B = int(np.prod([mesh.size(i) for i in batch]))
    live = [i for i in range(mesh.ndim) if mesh.size(i) > 1]
    return all(table.placements[i] == (Shard(0) if i == m else Shard(1)
                                       if i == d else Replicate())
               for i in live) and \
        all(tokens.placements[i] == (Shard(0) if i in batch else Replicate())
            for i in live) and \
        table.shape[0] % n == 0 and table.shape[1] % n == 0 and \
        tokens.shape[0] % B == 0


def embed_layout(rows: int, d_model: int, tokens_rank: int,
                 tokens_batch: int, data: int, model: int,
                 spread: bool) -> str:
    """The layout the reference's partitioner gives the lookup of an
    embedding table of ``rows`` x ``d_model``, its rows sharded over the
    model axis (``model`` ranks) and D over the data axis (``data``), for
    ``tokens_rank`` tokens a rank out of a batch of ``tokens_batch``;
    ``spread``: the batch lies on a mesh axis that holds no shard of the
    table's D (('pod', 'data') beside D on 'data').  One of

    * ``"table"``: the table's rows move (whole rows, D on 'model');
    * ``"tokens"``: the tokens are gathered and each rank looks up its own
      rows, a partial sum over 'model';
    * ``"rows"``: the table's whole rows are all-gathered over 'model' (D
      still on 'data') and the result over 'model' (:func:`_rows_lookup`).

    Read from XLA's lowering of the reference's lookup alone
    (``tools/embedding_layouts.py``: its 428-point grid and 2,638 more
    points, every one agreeing) on 2 x 2 to 16 x 16, 16 x 8, 8 x 16, 4 x
    8, and 2 to 8 pods of 2 x 2 to 16 x 16, D 256 to 7,168, 384 to 8,192
    tokens a rank.  The table moves where it has fewer rows
    than a rank has tokens, or, where ``spread``, than the batch has.  XLA
    gathers whole rows only where the data and model axes are equally wide
    (n ranks each; never on 16 x 8 or 8 x 16), in a band about the batch's
    T tokens (:func:`_in_row_band`), for V rows and D columns:

    * batch on 'data': T (1 - 2 n^2 / D) <= V < T (1 + 2 n / D); at D
      4,096, 16 x 16 from 14 to 16.125 times a rank's tokens, 8 x 8 from
      7.75 to 8.03, 2 x 2 from 1.996 to 2.002;
    * batch on ('pod', 'data'), p pods: T <= V < T max(n (p + 1) / (p (n +
      1)), 1 + 2 n / D): 2 x 16 x 16 below 1.4118 T, 2 x 8 x 8 4 / 3 T, 2
      x 4 x 4 1.2 T, 3 x 8 x 8 1.185 T, 4 x 8 x 8 1.111 T; where p >= n
      (2 x 2 x 2, 4 x 4 x 4, 8 x 8 x 8) below T (1 + 2 n / D) only.

    In elements a rank, with R = V D / n the gathered rows and A = T D / n
    the result gathered over 'model', the edges on 'data' read A - 2 n T
    <= R < A + 2 T; no one comparison of the layouts' collective sizes
    gives both, nor the bands over ('pod', 'data'), so they are stated as
    read (tests/test_torch_lowering_faults.py holds both sides of every
    edge).  Meshes of several pods whose data and model axes differ (2 x 8
    x 4, 2 x 4 x 8) were not read: the rule there is the table or the
    tokens, as before."""
    if rows < (tokens_batch if spread else tokens_rank):
        return "table"
    pod = tokens_batch // (tokens_rank * data) if spread else 1
    if data == model > 1 and _in_row_band(rows, d_model, tokens_batch,
                                          model, pod):
        return "rows"
    return "tokens"


def embed_rows(table, tokens, take):
    """``take(table, tokens)`` (the table's rows at the tokens) where the
    DTensor ``table`` (V, D) is sharded on its rows over the model axis, in
    the layout the reference's partitioner gives it (:func:`embed_layout`):

    * ``"tokens"``: the tokens are gathered whole (a few bytes), and each
      rank looks up, in its own block of the table (its rows, and its
      columns where FSDP shards D), the tokens whose rows it owns, zeros
      for the rest.  The result is a partial sum over the model axis,
      sharded on D where the table is; the caller's constraint reduces it
      and moves the D shard onto the batch (an all-to-all).  The table is
      never gathered;
    * ``"table"``: the table's rows move instead (:func:`_table_columns`:
      whole rows, D on the model axis; each rank looks up its own tokens in
      its own columns and the caller's constraint gathers D);
    * ``"rows"``: the table's whole rows are gathered over 'model', D
      still on 'data' (:func:`_rows_lookup`).

    falcon-mamba at 16 x 16 (65,024 rows, 65,536 tokens a rank) and kimi-k2
    at 2 x 16 x 16 (the batch on ('pod', 'data'), D on 'data' alone) move
    the table, kimi-k2 at 16 x 16 (163,840 rows) the tokens.  Returns None
    where the table's rows are not on the model axis (the caller gathers
    it)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    names = list(mesh_axes(mesh))
    if TP not in names or table.placements[names.index(TP)] != Shard(0) or \
            not is_sharded(tokens) or any(
                p not in (Replicate(), Shard(0), Shard(1))
                for p in table.placements):
        return None
    m = names.index(TP)
    d_dims = {i for i, p in enumerate(table.placements)
              if p == Shard(1) and mesh.size(i) > 1}
    spread = mesh.size(m) > 1 and not _batch_dims(tokens) <= d_dims
    d = names.index("data") if "data" in names else None
    layout = embed_layout(
        table.shape[0], table.shape[1], tokens.to_local().numel(),
        tokens.numel(), mesh.size(d) if d is not None else 1, mesh.size(m),
        spread)
    if layout == "rows" and _rows_placed(table, tokens, d, m, spread):
        return _rows_lookup(table, tokens, take, d, m, spread)
    if layout == "table" and table.shape[1] % mesh.size(m) == 0:
        whole = _table_columns(table, m)
        lead = tuple(f"x{i}" for i in range(tokens.dim()))
        return per_shard(take, (whole, tokens),
                         (("v", "d"), lead), (lead + ("d",),),
                         frozenset(lead + ("d",)))
    rows = table.shape[0] // mesh.size(m)
    lo = mesh.get_local_rank(TP) * rows
    whole = [Replicate()] * mesh.ndim
    last = tokens.dim()
    out = [Partial() if i == m else (Shard(last) if p == Shard(1)
                                     else Replicate())
           for i, p in enumerate(table.placements)]

    def local(t, ids):
        ids = ids.long() - lo
        own = (ids >= 0) & (ids < rows)
        got = take(t, ids.clamp(0, rows - 1))
        return got * own[..., None].to(got.dtype)

    run = local_map(local, out_placements=out,
                    in_placements=(list(table.placements), whole),
                    in_grad_placements=(list(table.placements), whole),
                    device_mesh=mesh)
    return run(table, redistribute(tokens, mesh, whole))


def is_sharded(x) -> bool:
    """True for a DTensor (a tensor placed on a device mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def per_shard(fn, args: tuple, dims: tuple, outs: tuple, free: frozenset,
              grad_partial: Optional[Dict[int, str]] = None,
              summed: frozenset = frozenset(), **kwargs):
    """``fn(*args, **kwargs)`` run shard by shard where ``args`` hold
    DTensors, through ``torch.distributed.tensor.experimental.local_map``.

    ``dims`` names each argument's tensor dims (a tuple of labels per
    argument, ``None`` for an argument passed as it is), ``outs`` each
    output's.  A mesh dim stays sharded only on a label in ``free`` (the
    dims ``fn`` treats independently: batch, heads, channels) or in
    ``summed`` (the dims ``fn`` sums its results over): the one such label
    some argument is sharded on there, where it divides every argument
    carrying it evenly; those arguments are sharded on it (a replicated one
    keeps its slice, no exchange).  Every other mesh dim is redistributed
    to ``Replicate`` first (a shard on a kernel dim is gathered, a
    ``Partial`` reduced).  An output without a ``summed`` label that the
    mesh dim keeps is a ``Partial`` sum over that mesh dim: each shard
    computes its own share of it.  ``grad_partial`` maps an argument's
    index to a mesh axis over which ``fn`` computes a different share of
    that argument's gradient on each rank: its gradient is ``Partial``
    there.  So a kernel's own dims reach it
    whole and each shard computes exactly its slice of the result.  An argument
    replicated over a mesh dim whose shards compute different slices (a
    norm's weight beside a batch-sharded input) gets its gradient as a
    ``Partial`` sum over that dim.  With no DTensor among ``args``, ``fn``
    runs on them directly."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = next((a for a in args if is_sharded(a)), None)
    if lead is None:
        return fn(*args, **kwargs)
    mesh = lead.device_mesh
    tensors = [(a, d) for a, d in zip(args, dims)
               if d is not None and is_sharded(a)]
    kept = free | summed
    # per mesh dim, the one kept label some argument is sharded on there
    label_of: Dict[int, str] = {}
    for i in range(mesh.ndim):
        labels = {d[a.placements[i].dim] for a, d in tensors
                  if isinstance(a.placements[i], Shard)} & kept
        if len(labels) == 1:
            label_of[i] = labels.pop()
    # keep a label only where every argument carrying it divides evenly
    for label in set(label_of.values()):
        n = int(np.prod([mesh.size(i) for i, lb in label_of.items()
                         if lb == label]))
        if any(label in d and a.shape[d.index(label)] % n
               for a, d in tensors):
            label_of = {i: lb for i, lb in label_of.items() if lb != label}

    def target(d):
        # a list: local_map reads a tuple as one entry per output
        return [Shard(d.index(label_of[i]))
                if i in label_of and label_of[i] in d else Replicate()
                for i in range(mesh.ndim)]

    def out_target(d):
        return [Partial() if i in label_of and label_of[i] in summed
                and label_of[i] not in d else p
                for i, p in enumerate(target(d))]

    placed = []
    for a, d in zip(args, dims):
        if d is not None and is_sharded(a):
            want = tuple(target(d))
            if tuple(a.placements) != want:
                a = redistribute(a, mesh, want)
        placed.append(a)
    names = list(mesh_axes(mesh))

    def grad_target(d, idx):
        g = [Partial() if i in label_of and label_of[i] not in d else p
             for i, p in enumerate(target(d))]
        axis = (grad_partial or {}).get(idx)
        if axis in names:
            g[names.index(axis)] = Partial()
        return g

    sharded = [d is not None and is_sharded(a) for a, d in zip(placed, dims)]
    in_placements = tuple(target(d) if sh else None
                          for d, sh in zip(dims, sharded))
    in_grads = tuple(grad_target(d, i) if sh else None
                     for i, (d, sh) in enumerate(zip(dims, sharded)))
    out_placements = tuple(out_target(d) for d in outs)
    run = local_map(lambda *xs: fn(*xs, **kwargs),
                    out_placements=(out_placements if len(outs) > 1
                                    else out_placements[0]),
                    in_placements=in_placements,
                    in_grad_placements=in_grads, device_mesh=mesh)
    return run(*placed)


def shard_start(x, dim: int) -> int:
    """Where this rank's shard of the DTensor ``x``'s dim ``dim`` begins
    in the whole dim (0 for a plain tensor or a dim no mesh dim shards).
    Shards are even; several mesh dims on one tensor dim split it in
    mesh-dim order, the first outermost."""
    if not is_sharded(x):
        return 0
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    idx, n = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim % x.dim():
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    return idx * (x.shape[dim] // n)


def _project(h, w):
    return h @ w.to(h.dtype)


class _RowGradProduct(torch.autograd.Function):
    """``h @ w`` whose weight gradient is computed for w's rows [lo, hi)
    alone (zeros elsewhere); the output and the input gradient are
    whole."""

    @staticmethod
    def forward(ctx, h, w, lo: int, hi: int):
        ctx.save_for_backward(h, w)
        ctx.rows = (lo, hi)
        return h @ w

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        lo, hi = ctx.rows
        dh = g @ w.T if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.zeros_like(w)
            dw[lo:hi] = (h[..., lo:hi].reshape(-1, hi - lo).T
                         @ g.reshape(-1, g.shape[-1]))
        return dh, dw, None, None


def _project_rows(h, w, *, lo: int, hi: int):
    """:func:`_project` whose weight gradient covers rows [lo, hi) only."""
    return _RowGradProduct.apply(h, w.to(h.dtype), lo, hi)


def gathered_product(h, w):
    """``h @ w.to(h.dtype)`` for a (D, N) weight; on a mesh shard by shard,
    as the reference's partitioner runs a head or a router: ``h``'s leading
    shards and ``w``'s N shard each compute their block, ``w``'s d_model
    (FSDP) shard is gathered first and ``h``'s D is whole (DTensor's own
    choice for the product gathers the activations instead, contracts D
    into a partial sum, or splits N over the model axis).  Where the model
    axis shards neither operand, its ranks would each compute the same
    whole weight gradient: each computes its own share of D's rows instead
    (a partial sum over the axis), as the reference's per-device count
    shows."""
    lead = tuple(f"x{i}" for i in range(h.dim() - 1))
    fn, split = _project, None
    M = model_axis_size(w)
    if M > 1:
        from torch.distributed.tensor import Replicate

        mesh = w.device_mesh
        if w.placements[list(mesh_axes(mesh)).index(TP)] == Replicate():
            rows = -(-w.shape[0] // M)
            lo = min(w.shape[0], mesh.get_local_rank(TP) * rows)
            fn = functools.partial(_project_rows, lo=lo,
                                   hi=min(w.shape[0], lo + rows))
            split = {1: TP}
    return per_shard(fn, (h, w), (lead + ("d",), ("d", "v")),
                     (lead + ("v",),), frozenset(lead + ("v",)),
                     grad_partial=split)
