"""Dry run: trace every (arch x shape x mesh) cell of the sharded step over a
fake world, and account for what one device of it does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out experiments/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --device cpu

The port of the reference's ``launch/dryrun.py``, which lowers and compiles
each cell through XLA for 256 or 512 placeholder devices and reads the
post-partitioning HLO.  Here a cell is the port's own sharded step --
``train.steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` -- run eagerly on DTensors over a fake process group
of 256 (16 x 16) or 512 (2 x 16 x 16) ranks (``torch.distributed``'s
``fake`` backend: collectives move nothing) with every tensor a fake tensor
(``FakeTensorMode``: shapes and dtypes, no data, no memory).  State comes
from :mod:`.specs` (never ``init_params``, whose host draws need data),
placed by ``sharding.param_pspecs`` / ``opt_pspecs`` / ``batch_pspecs``,
and ``cache_pspecs`` for serving; serving outputs are redistributed to the
reference's out-shardings.  Without ``device="cpu"`` the fake tensors lie on
``cuda``, so the trace is the card's program: the layers route them to K3,
K4 and K5, whose ``torch.library`` ops have fake implementations (and K3 a
FLOP formula).  A cell allocates no device memory.

:class:`Accounting` (a ``TorchDispatchMode`` above the fake mode) sees the
ops one rank runs at their local shapes -- each DTensor op is seen as the
local op it runs, ``per_shard``'s local functions once -- and totals, for
rank 0:

* FLOPs by the reference's convention (matrix products and convolutions
  only: ``torch.utils.flop_counter``'s formulas, which K3's op joins);
* collective bytes by the reference's kinds, read at the dispatcher as
  ``CommDebugMode`` reads them: an all-gather counts its gathered output,
  every other collective its operand (DTensor's all-to-all on a CPU mesh,
  an all-gather and a chunk there, counts as the all-to-all it stands in
  for); each collective's row names the mesh axes its group spans, so a
  change over ('pod', 'data') made as one collective shows as one row
  ``@pod+data`` (:func:`collective_axes`);
* HBM bytes: the inputs plus outputs of every local op that is not a view.
  The eager program on the card runs each op as its own kernel, which
  reads its inputs and writes its outputs, so this is what it moves, and
  ``bytes_per_device`` equals ``bytes_per_device_unfused_ub``;
* memory: ``argument_bytes`` the local shards of parameters, optimizer
  state and batch (and caches, token and position for decode),
  ``temp_bytes`` the most bytes of the device's tensors made during the
  step and live at once, ``peak_bytes`` their sum.

``xla_cost_flops`` and ``xla_cost_bytes`` are ``None``: they are XLA's own
cost analysis, which has no counterpart here.  ``compile_seconds`` holds
the trace's seconds.  The roofline is computed at the card's constants
(:data:`.hlo_analysis.HW_H100`: 989.4 TFLOP/s dense bf16, 3.35 TB/s, 18
NVLink links of 25 GB/s), not the reference's TPU constants.  A 16-wide
model axis spans two 8-card NVLink nodes, so its collectives would in
part cross the slower link between nodes: the collective term is a lower
bound there.  The trace rows (op, local shapes, FLOPs, bytes, issuing
functions) of every matrix product and collective are what ``save_hlo`` keeps in the
reference: enough to explain a count.

Per-device FLOPs can exceed the reference's where heads do not divide the
model axis: each rank computes attention for all heads of its batch shard
(``parallel.act.split_dim`` gathers them), where GSPMD pads the heads to
the axis.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import tree as T
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeSpec,
                                      cells_for, get_config, list_configs)
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.hlo_analysis import _COLLECTIVES, HW_H100, roofline_terms
from repro_torch.launch.specs import cache_specs, input_specs, train_state_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel import sharding as sh
from repro_torch.train import steps as train_steps

__all__ = ["Accounting", "fake_world", "lower_cell", "trace_step",
           "collective_axes",
           "accounted_train_step", "matmul_probe", "mlp_probe",
           "check_hand_counts", "cell_list", "cell_tag", "main"]

#: a collective op -> (the reference's kind, where its payload is: "out"
#: for the op's output, else the index of the argument)
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather",
                                                           "out"),
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                          0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "_dtensor::shard_dim_alltoall": ("all-to-all", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::_allgather_base_": ("all-gather", 0),           # the output
    "c10d::allgather_": ("all-gather", 0),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::alltoall_": ("all-to-all", 1),
}
#: ops of those namespaces that move no payload
_NOT_COLLECTIVES = {"_c10d_functional::wait_tensor", "c10d::barrier",
                    "c10d::monitored_barrier_"}
#: ops that allocate without writing
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes at its element size: one a float8 element."""
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_arg(args):
    """A collective op's process group among its arguments: the functional
    ops' group name (their last string argument), or a group itself."""
    for a in reversed(args):
        if isinstance(a, str) or hasattr(a, "group_name"):
            return a
    return None


def collective_axes(rows) -> Dict[str, Dict[str, float]]:
    """The trace rows' collectives by the mesh axes their groups span
    (``pod+data``; ``""`` where a row names none): count and bytes."""
    out: Dict[str, Dict[str, float]] = {}
    for op, _, flops, nbytes, _ in rows:
        if flops:
            continue
        axes = op.rsplit(" @", 1)[1] if " @" in op else ""
        got = out.setdefault(axes, dict(count=0, bytes=0.0))
        got["count"] += 1
        got["bytes"] += nbytes
    return out


def _wrappers() -> tuple:
    """The tensor subclasses that wrap local tensors (DTensor, and the
    functional collectives' async result): their ops are left to them, so
    that the local ops they run come back here."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor

    return (DTensor, AsyncCollectiveTensor)


#: the modules of DTensor's sharding propagation, which runs each op once
#: more on fake global tensors (made in the second) to learn its output's
#: shape
_PROPAGATION = ("_sharding_prop.py", "_op_schema.py")
#: frames above an op's dispatch in which to look for them
_PROPAGATION_DEPTH = 16


def _check_propagation_modules() -> None:
    """Raise unless this torch's ``torch.distributed.tensor`` holds a module
    :data:`_PROPAGATION` names: without one, :func:`_propagating` would
    never see the propagation, and every DTensor op would count its global
    op (256 times the local one on a 16 x 16 mesh)."""
    import torch.distributed.tensor as dt

    here = Path(dt.__file__).parent
    if not any((here / name).is_file() for name in _PROPAGATION):
        raise RuntimeError(
            f"dryrun: torch {torch.__version__} has none of {_PROPAGATION} "
            f"in {here}; the accounting cannot tell DTensor's sharding "
            "propagation from the ops a rank runs")


def _propagating() -> bool:
    """True for an op that DTensor's sharding propagation runs on global
    shapes (under the fake mode of a fake trace it reaches this mode; on
    real tensors it runs under a fake mode of its own): no rank runs it."""
    frame = sys._getframe(2)
    for _ in range(_PROPAGATION_DEPTH):
        if frame is None:
            return False
        if frame.f_code.co_filename.endswith(_PROPAGATION):
            return True
        frame = frame.f_back
    return False


def _issuers() -> tuple:
    """The qualified names of the port's functions on the caller's stack
    outside this module, innermost first."""
    out, frame = [], sys._getframe(1)
    while frame is not None:
        name = frame.f_code.co_filename
        if "repro_torch" in name and name != __file__:
            out.append(frame.f_code.co_qualname)
        frame = frame.f_back
    return tuple(out)


class Accounting(TorchDispatchMode):
    """Per-device totals of the ops run while it is entered (see the module
    docstring): ``flops``, ``hbm_bytes``, ``collective_bytes`` and
    ``collective_counts`` by kind, and ``temp_bytes``, the most bytes of
    tensors on ``device_type`` made by those ops and alive at once; a row
    (op, local shapes, FLOPs, bytes, functions) for each matrix product
    and collective (``rows``; a collective's functions are the qualified
    names of the port's functions on the stack that issued it, innermost
    first, a product's none), and the bytes by op (``bytes_by_op``).

    Given the ``mesh`` the step runs on, each collective's row names the
    mesh axes its group spans (``op @pod+data``; :func:`collective_axes`
    reads it back), and ``flattened_counts`` counts by kind those over
    several axes at once (:func:`repro_torch.parallel.act.redistribute`),
    and ``counts_by_part`` counts them in each part of a train step
    (``repro_torch.train.steps.part_running``: forward, backward,
    optimizer) by kind and the axes their group spans (``all-reduce
    @data``).

    Works on fake and on real tensors alike.  Only collectives of tensors
    on ``device_type`` count; those staged through the host
    (:func:`repro_torch.launch.mesh.stage_collectives_through_host`) count
    as the collective they stand in for (told by
    :func:`~repro_torch.launch.mesh.observe_staged`), not as the host
    exchanges inside them."""

    def __init__(self, device_type: str, mesh=None):
        super().__init__()
        _check_propagation_modules()
        self.device_type = device_type
        # each rank's coordinates on the mesh (read on real tensors, outside
        # the fake mode a trace makes this in), for the axes a collective's
        # group spans
        self._coords = None
        if mesh is not None:
            from torch.utils._python_dispatch import _disable_current_modes

            with _disable_current_modes():
                layout = np.asarray(mesh.mesh.tolist())
            self._coords = {int(r): idx for idx, r in np.ndenumerate(layout)}
            self._names = tuple(mesh.mesh_dim_names)
            self._sizes = dict(zip(self._names, layout.shape))
        self._axes_of: Dict[str, tuple] = {}
        self.flattened_counts = {k: 0 for k in _COLLECTIVES}
        self.counts_by_part: Dict[str, Dict[str, int]] = {}
        self.flops = 0
        self.hbm_bytes = 0
        self.collective_bytes = {k: 0 for k in _COLLECTIVES}
        self.collective_counts = {k: 0 for k in _COLLECTIVES}
        self.bytes_by_op: Dict[str, int] = {}
        self.rows: List[tuple] = []
        self.live = 0
        self.temp_bytes = 0
        self._storages: Dict[int, list] = {}     # key -> [tensors, bytes]
        self._skip = _wrappers()
        self._observing = None
        self._patched: List[tuple] = []
        self._quiet = 0
        self._paused = 0

    # -- collectives the host staging stands in for ----------------------
    def __enter__(self):
        self._observing = mesh_mod.observe_staged(self._staged,
                                                  self.device_type)
        self._observing.__enter__()
        self._patch_all_to_all()
        self._own_lowering()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for module, name, original in self._patched:
                setattr(module, name, original)
            self._patched = []
            self._observing.__exit__(*exc)

    def _own_lowering(self) -> None:
        """While entered, DTensor's own merging of consecutive per-mesh-dim
        collectives into one over a flattened mesh (a pass that torch
        2.13's DTensor has and 2.11's lacks, and which runs only once some
        code has flattened those dims) is off: what is counted is the port's
        lowering, the same on either torch and from the first op."""
        import torch.distributed.tensor._redistribute as rd

        flag = "_DISABLE_REDISTRIBUTE_TRANSFORM_OPTIMIZATION"
        if hasattr(rd, flag):
            self._patched.append((rd, flag, getattr(rd, flag)))
            setattr(rd, flag, True)

    @contextlib.contextmanager
    def paused(self):
        """For the block, count nothing: a check's own reads (gathering a
        gradient whole to compare it) inside a counted step."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _staged(self, kind: str, nbytes: int, shape, group=None) -> None:
        if not self._paused:
            self._collective(kind, nbytes, "staged " + kind, [shape], group)

    # -- DTensor's all-to-all on a CPU mesh --------------------------------
    def _patch_all_to_all(self) -> None:
        """While entered, count DTensor's shard-to-shard all-to-all on a
        CPU mesh (which it runs as an all-gather of the whole dim and a
        chunk: gloo has no all-to-all) as the all-to-all it stands in for,
        its operand's bytes, as the card's program counts it; the
        all-gather inside is not counted."""
        import torch.distributed.tensor._collective_utils as cu
        import torch.distributed.tensor.placement_types as pt

        for module in (cu, pt):
            original = module.shard_dim_alltoall
            self._patched.append((module, "shard_dim_alltoall", original))
            module.shard_dim_alltoall = self._all_to_all(original)

    def _all_to_all(self, original):
        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu" or self._quiet or self._paused:
                return original(input, gather_dim, shard_dim, mesh, mesh_dim)
            if input.device.type == self.device_type:
                self._collective("all-to-all", _nbytes(input),
                                 "all-to-all (gathered on a CPU mesh)",
                                 [tuple(input.shape)],
                                 mesh.get_group(mesh_dim))
            self._quiet += 1
            try:
                return original(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._quiet -= 1
        return shard_dim_alltoall

    def _collective(self, kind: str, nbytes: int, op: str, shapes,
                    group=None) -> None:
        self.collective_bytes[kind] += nbytes
        self.collective_counts[kind] += 1
        axes, label = self._axes(group)
        if len(axes) > 1:
            self.flattened_counts[kind] += 1
        part = train_steps.part_running
        if part is not None:
            key = f"{kind} @{label}" if axes else kind
            got = self.counts_by_part.setdefault(part, {})
            got[key] = got.get(key, 0) + 1
        if axes:
            op = f"{op} @{label}"
        self.rows.append((op, shapes, 0, nbytes, _issuers()))

    def _axes(self, group) -> tuple:
        """The mesh axes (of more than one rank) along which the ranks of
        ``group`` (a process group or its name) differ, and the group's
        label: those axes joined by ``+``, and the group's size in
        brackets where it holds fewer ranks than the axes span (a subgroup
        of an axis, :func:`repro_torch.parallel.act.axis_groups`:
        ``model[2]``); ((), "") without a mesh."""
        if self._coords is None or group is None:
            return (), ""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        pg = _resolve_process_group(group) if isinstance(group, str) else group
        name = pg.group_name
        if name not in self._axes_of:
            ranks = dist.get_process_group_ranks(pg)
            at = np.array([self._coords[r] for r in ranks])
            axes = tuple(a for i, a in enumerate(self._names)
                         if len(set(at[:, i].tolist())) > 1)
            whole = int(np.prod([self._sizes[a] for a in axes] or [1]))
            label = "+".join(axes) + (f"[{len(ranks)}]"
                                      if len(ranks) < whole else "")
            self._axes_of[name] = (axes, label)
        return self._axes_of[name]

    # -- every op ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._skip) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _propagating() and not self._paused:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _COLLECTIVE_OPS:
            if not self._quiet and all(t.device.type == self.device_type
                                       for t in ins):
                kind, where = _COLLECTIVE_OPS[name]
                payload = outs if where == "out" else _tensors(args[where])
                self._collective(kind, sum(map(_nbytes, payload)), name,
                                 [tuple(t.shape) for t in ins],
                                 _group_arg(args))
            return
        if name in _NOT_COLLECTIVES:
            return
        from torch.utils.flop_counter import flop_registry

        flops = 0
        counter = flop_registry.get(func.overloadpacket)
        if counter is not None:
            flops = int(counter(*args, **kwargs, out_val=out))
            self.flops += flops
        if not outs:                    # metadata: a device, a size
            return
        in_keys = {t.untyped_storage()._cdata for t in ins}
        view = (not func._schema.is_mutable and all(
            t.untyped_storage()._cdata in in_keys for t in outs))
        if not view and name not in _NO_TRAFFIC:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.hbm_bytes += moved
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + moved
            if flops:
                self.rows.append((name, [tuple(t.shape) for t in ins], flops,
                                  moved, ()))
        for t in outs:
            self._track(t, in_keys)

    # -- live bytes --------------------------------------------------------
    def _track(self, t: torch.Tensor, in_keys) -> None:
        if t.device.type != self.device_type:
            return
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            if key in in_keys:          # a view or an in-place result of an
                return                  # input this mode did not make
            entry = self._storages[key] = [0, storage.nbytes()]
            self.live += entry[1]
            self.temp_bytes = max(self.temp_bytes, self.live)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]

    def summary(self) -> Dict[str, Any]:
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    collective_bytes=dict(self.collective_bytes),
                    collective_counts=dict(self.collective_counts),
                    flattened_counts=dict(self.flattened_counts),
                    counts_by_part={k: dict(v) for k, v in
                                    self.counts_by_part.items()},
                    temp_bytes=self.temp_bytes)


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0) for the duration; an initialised fake group of the same size is
    used as it is, any other initialised group refused."""
    import torch.distributed as dist

    if dist.is_initialized():
        backend, size = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or size != world_size:
            raise RuntimeError(f"dryrun: a {backend} process group of "
                               f"{size} ranks is initialised; this trace "
                               f"needs a fake one of {world_size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _forget_meshes() -> None:
    """Clear DTensor's sharding-propagation caches (the Python one, and the
    C++ dispatch's where the torch has one), whose output specs hold the
    meshes of the world just destroyed: a later world's DTensor would be
    handed an equal mesh from them, whose (flattened) groups are gone."""
    from torch.distributed.tensor import DTensor

    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
        .cache_clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()


def _device_mesh(shape: Dict[str, int], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def _fake_like(tree, device):
    """Each meta tensor of ``tree`` as an empty tensor on ``device`` (fake
    under the caller's ``FakeTensorMode``)."""
    return T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device=device), tree)


def _local_bytes(tree) -> int:
    from repro_torch.parallel.act import is_sharded

    return sum(_nbytes(t.to_local() if is_sharded(t) else t)
               for t in _tensors(tree))


def _put(tree, spec_tree, mesh):
    return sh.device_put(tree, sh.to_shardings(spec_tree, mesh))


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """The reference's analytic MODEL_FLOPS: 6 N_active D for a train step,
    2 N_active D forward only."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * cfg.active_param_count() * tokens


def trace_step(cfg: ArchConfig, shape: ShapeSpec, mesh_shape: Dict[str, int],
               device: str = "cuda") -> Tuple[Dict[str, Any], List[tuple]]:
    """Trace one step of ``shape.kind`` for ``cfg`` on a fake mesh of
    ``mesh_shape`` (axis name -> size) on ``device``'s type, and return
    (the per-device figures of rank 0, the trace rows).

    The fake world must be absent (one is made for the call) or a fake
    group of the mesh's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = torch.device(device)
    world = int(np.prod(list(mesh_shape.values())))
    opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    with fake_world(world):
        mesh = _device_mesh(mesh_shape, dev.type)   # real: it reads ranks
        with FakeTensorMode(allow_non_fake_inputs=True):
            result, rows = _trace(cfg, shape, mesh, dev, opt_cfg)
    if dev.type == "cuda":
        after = torch.cuda.memory_allocated()
        if after != before:
            raise AssertionError(f"dryrun: the trace allocated "
                                 f"{after - before} bytes on the card")
    return result, rows


def _step_and_args(cfg, shape, mesh, dev, opt_cfg):
    """The step of ``shape.kind``, its arguments as fake tensors placed by
    the rules, and the specs its outputs are resharded to (the reference's
    out-shardings; None for the train step, which updates in place)."""
    from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                         make_train_step)

    p_specs, _ = train_state_specs(cfg, opt_cfg)
    params = _put(_fake_like(p_specs, dev), sh.param_pspecs(cfg, mesh), mesh)
    ins = _fake_like(input_specs(cfg, shape), dev)
    bspec = sh.serving_batch_axes(mesh, shape.global_batch)
    if shape.kind == "train":
        batch = _put(ins, sh.batch_pspecs(cfg, shape, mesh), mesh)
        return (make_train_step(cfg, opt_cfg),
                (params, adamw_init(params, opt_cfg), batch), None)
    caches = sh.cache_pspecs(cfg, shape, mesh)
    if shape.kind == "prefill":
        batch = _put(ins, sh.batch_pspecs(cfg, shape, mesh), mesh)
        out_specs = ((sh.P(bspec, None), caches) if cfg.causal
                     else (sh.P(bspec, None, None), None))
        return (make_prefill_step(cfg, max_len=shape.seq_len),
                (params, batch), out_specs)
    tok = ins["token"]
    token = _put(tok, sh.P(bspec, *([None] * (tok.dim() - 1))), mesh)
    cache = _put(_fake_like(cache_specs(cfg, shape), dev), caches, mesh)
    return (make_decode_step(cfg), (params, token, cache, ins["cur_pos"]),
            (sh.P(bspec, None), caches))


def _trace(cfg, shape, mesh, dev, opt_cfg):
    """:func:`trace_step`'s body, under the fake mode."""
    step, args, out_specs = _step_and_args(cfg, shape, mesh, dev, opt_cfg)
    argument_bytes = _local_bytes(args)
    acc = Accounting(dev.type, mesh)
    t0 = time.perf_counter()
    with acc, sh.activation_mesh(mesh):
        out = step(*args)
        if out_specs is not None:
            out = tuple(o if s is None else sh.reshard(o, s, mesh)
                        for o, s in zip(out, out_specs))
    trace_s = time.perf_counter() - t0
    output_bytes = _local_bytes(out)
    del args, out
    coll = dict(acc.collective_bytes)
    chips = mesh.size()
    flops_dev = float(acc.flops)
    bytes_dev = float(acc.hbm_bytes)
    coll_dev = float(sum(coll.values()))
    mf = model_flops(cfg, shape)
    result = dict(
        compile_seconds=trace_s,
        memory=dict(argument_bytes=argument_bytes, output_bytes=output_bytes,
                    temp_bytes=acc.temp_bytes,
                    peak_bytes=argument_bytes + acc.temp_bytes),
        cost=dict(flops_per_device=flops_dev, bytes_per_device=bytes_dev,
                  bytes_per_device_unfused_ub=bytes_dev,
                  xla_cost_flops=None, xla_cost_bytes=None),
        collectives=dict(bytes_by_kind={k: float(v) for k, v in coll.items()},
                         count_by_kind={k: float(v) for k, v in
                                        acc.collective_counts.items()},
                         total_bytes_per_device=coll_dev),
        collectives_by_part={k: dict(v)
                             for k, v in acc.counts_by_part.items()},
        roofline=roofline_terms(flops_dev, bytes_dev, coll_dev, hw=HW_H100),
        model_flops=mf,
        useful_flops_ratio=mf / max(chips * flops_dev, 1.0),
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        device=dev.type, hw=dict(HW_H100), chips=chips,
        bytes_by_op=dict(sorted(acc.bytes_by_op.items(),
                                key=lambda kv: -kv[1])))
    return result, acc.rows


# --------------------------------------------------------------------------
# the accounting on real ranks, and the hand counts it is held to
# --------------------------------------------------------------------------

def accounted_train_step(rank: int, world: int, cfg: ArchConfig, opt_cfg,
                         B: int, S: int, mesh_shape, device: str
                         ) -> Dict[str, Any]:
    """A job for ``parallel.ranks.run_jobs``: one train step of ``cfg`` on
    a real ('data', 'model') mesh of ``mesh_shape``, state from seed 0
    placed by the rules, the data pipeline's batch 0 of (B, S), counted by
    :class:`Accounting`.  Returns its totals: what this rank runs, which
    :func:`trace_step` of the same step on a fake world predicts."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model import init_params
    from repro_torch.parallel.ranks import train_batch
    from repro_torch.train.steps import make_train_step

    import gc

    del rank, world
    gc.collect()                # an earlier job's cycles off the card
    dev = torch.device(device)
    mesh = mesh_mod.make_local_mesh(*mesh_shape, device=dev.type)
    params = _put(init_params(cfg, seed=0, device=dev),
                  sh.param_pspecs(cfg, mesh), mesh)
    opt = adamw_init(params, opt_cfg)
    batch = _put(train_batch(cfg, B, S, dev),
                 sh.batch_pspecs(cfg, ShapeSpec("t", S, B, "train"), mesh),
                 mesh)
    acc = Accounting(dev.type, mesh)
    with acc, sh.activation_mesh(mesh):
        make_train_step(cfg, opt_cfg)(params, opt, batch)
    return acc.summary()


#: the matmul probe: (4096 x 3584) @ (3584 x 18944) in bf16, rows on
#: 'data' and columns on 'model' of a 16 x 16 mesh; each rank multiplies
#: (256 x 3584) by (3584 x 1184)
MATMUL_PROBE_FLOPS = 2 * 256 * 3584 * 1184          # 2,172,649,472
#: the MLP probe: x (B, S, D) f32 replicated, w1 (D, F) on columns, w2
#: (F, D) on rows of a 1 x 4 mesh
MLP_PROBE = dict(B=2, S=8, D=16, F=32)


def matmul_probe(device: str):
    """The matmul probe traced over a fake world of 256 on ``device``'s
    type: (its :class:`Accounting`, the product's placements)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(256):
        mesh = _device_mesh({"data": 16, "model": 16}, device)
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = distribute_tensor(
                torch.empty(4096, 3584, dtype=torch.bfloat16, device=device),
                mesh, [Shard(0), Replicate()], src_data_rank=None)
            w = distribute_tensor(
                torch.empty(3584, 18944, dtype=torch.bfloat16,
                            device=device),
                mesh, [Replicate(), Shard(1)], src_data_rank=None)
            with Accounting(torch.device(device).type) as acc:
                y = x @ w
            placements = tuple(y.placements)
    return acc, placements


def mlp_probe(device: str):
    """The MLP probe's forward, its output brought to replicated, traced
    over a fake world of 4 on ``device``'s type: (its :class:`Accounting`,
    the output's placements)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    B, S, D, F = (MLP_PROBE[k] for k in "BSDF")
    with fake_world(4):
        mesh = _device_mesh({"data": 1, "model": 4}, device)
        with FakeTensorMode(allow_non_fake_inputs=True):
            def put(shape, placements):
                return distribute_tensor(torch.empty(shape, device=device),
                                         mesh, placements,
                                         src_data_rank=None)

            x = put((B, S, D), [Replicate(), Replicate()])
            w1 = put((D, F), [Replicate(), Shard(1)])
            w2 = put((F, D), [Replicate(), Shard(0)])
            with Accounting(torch.device(device).type) as acc:
                y = ((x @ w1) @ w2).redistribute(mesh, [Replicate()] * 2)
            placements = tuple(y.placements)
    return acc, placements


def check_hand_counts(device: str) -> Dict[str, Any]:
    """Both probes on ``device``'s type against their hand counts: the
    matmul's local product, 2,172,649,472 FLOPs and no collective; the
    MLP's one all-reduce of B S D f32 elements and its two local products.
    Raises on any difference (a torch whose DTensor propagation the
    accounting no longer skips counts the global product, 256 times
    more); returns the counts."""
    acc, _ = matmul_probe(device)
    mlp, _ = mlp_probe(device)
    B, S, D, F = (MLP_PROBE[k] for k in "BSDF")
    got = dict(matmul_flops=acc.flops,
               matmul_collectives=sum(acc.collective_counts.values()),
               mlp_collective_counts={k: v for k, v in
                                      mlp.collective_counts.items() if v},
               mlp_all_reduce_bytes=mlp.collective_bytes["all-reduce"],
               mlp_flops=mlp.flops)
    want = dict(matmul_flops=MATMUL_PROBE_FLOPS, matmul_collectives=0,
                mlp_collective_counts={"all-reduce": 1},
                mlp_all_reduce_bytes=B * S * D * 4,
                mlp_flops=2 * (2 * B * S * D * (F // 4)))
    if got != want:
        raise AssertionError(f"dryrun: the accounting's hand counts on "
                             f"{device}: got {got}, want {want}")
    return got


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_tag(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{_mesh_name(multi_pod)}"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               save_hlo: bool = False, overrides: Optional[dict] = None,
               device: Optional[str] = None
               ) -> Tuple[Dict[str, Any], List[tuple]]:
    """The reference's ``lower_cell``: one (arch x shape x mesh) cell traced
    on the production mesh (``launch.mesh.make_production_mesh``), with
    ``overrides`` applied to the config by ``dataclasses.replace``.
    Returns (result with the reference's keys, the trace rows); with
    ``save_hlo`` the result also counts the rows (``trace_rows``).
    ``device`` defaults to the card (raising where there is none)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    logical = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    result, rows = trace_step(cfg, SHAPES[shape_name], dict(logical.shape),
                              device=str(dev))
    head = dict(arch=arch, shape=shape_name, mesh=_mesh_name(multi_pod),
                chips=result.pop("chips"))
    result = dict(head, **result)
    if save_hlo:
        result["trace_rows"] = len(rows)
    return result, rows


def cell_list(all_cells: bool = True, arch: Optional[str] = None,
              shape: Optional[str] = None, multi_pod: bool = False,
              both_meshes: bool = False) -> List[Tuple[str, str, bool]]:
    """The reference's cells: every config but ``lm100m`` (or ``arch``)
    times ``cells_for`` (or ``shape``) times the meshes."""
    archs = ([a for a in list_configs() if a != "lm100m"]
             if (all_cells or not arch) else [arch])
    cells = []
    for a in archs:
        shapes = ([s.name for s in cells_for(get_config(a))]
                  if (all_cells or not shape) else [shape])
        for s in shapes:
            for mp in ([False, True] if both_meshes else [multi_pod]):
                cells.append((a, s, mp))
    return cells


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card's program) or cpu (the "
                         "plain path)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cells = cell_list(args.all, args.arch, args.shape, args.multi_pod,
                      args.both_meshes)
    failures = 0
    # one fake world per mesh, made once for its cells
    for mp in sorted({c[2] for c in cells}):
        logical = mesh_mod.make_production_mesh(multi_pod=mp)
        with fake_world(int(np.prod(list(logical.shape.values())))):
            for arch, s, _ in [c for c in cells if c[2] == mp]:
                failures += _run_cell(out, arch, s, mp, device)
    print(f"done: {len(cells) - failures}/{len(cells)} cells passed")
    return failures


def _run_cell(out: Path, arch: str, s: str, mp: bool, device: str) -> int:
    tag = cell_tag(arch, s, mp)
    path = out / f"{tag}.json"
    if path.exists():
        print(f"[skip] {tag}")
        return 0
    print(f"[trace] {tag} ...", flush=True)
    try:
        t0 = time.time()
        result, _ = lower_cell(arch, s, mp, device=device)
        path.write_text(json.dumps(result, indent=1))
        r = result["roofline"]
        print(f"  ok in {time.time() - t0:.0f}s -- dominant={r['dominant']} "
              f"compute={r['compute_s']:.4f}s "
              f"coll={r['collective_s']:.4f}s", flush=True)
        return 0
    except Exception as e:                      # recorded, counted, and on
        (out / f"{tag}.FAILED").write_text(traceback.format_exc())
        print(f"  FAILED: {e}", flush=True)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
