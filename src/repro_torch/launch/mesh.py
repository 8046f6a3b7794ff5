"""Meshes, and the ranks that hold them.

The port of the reference's ``launch/mesh.py``.  The reference builds
meshes over the devices one JAX process sees (``jax.make_mesh``); in
PyTorch a mesh spans processes, one rank each, so this module also starts
them: :func:`run_ranks` is the counterpart of XLA's host device count
(``--xla_force_host_platform_device_count``), the tests' way to get N
devices on one host.

* :func:`make_production_mesh` -- the 16 x 16 pod or 2 x 16 x 16 pods as
  axis names and sizes (:class:`LogicalMesh`): what the sharding rules
  read.  It needs no devices: one card cannot hold a 256-device mesh.
* :func:`make_local_mesh` -- a ``DeviceMesh`` ('data', 'model') over the
  initialised process group.
* :func:`shard_batch` -- the reference's contract for the batched Lanczos
  operands; the identity within one process (every rank here is one
  device, so there is nothing local to split across).
* :func:`run_ranks` -- start N ranks (``torch.multiprocessing`` with
  ``spawn``), initialise their process group through a ``FileStore`` in a
  fresh temporary directory (no fixed port: parallel test workers each get
  their own), run a function importable from a module on each, and return
  what each rank returned.

The group is gloo, also for ranks that share one card (NCCL refuses two
ranks on one device).  gloo takes CUDA tensors in every ``torch.
distributed`` collective the sharded step and the expert exchange issue
(all-reduce, all-gather into a tensor, reduce-scatter, all-to-all: torch
2.11 on an H100), copying them through the host itself.  DTensor's own
collectives do not survive it: its functional all-gather and its
shard-to-shard all-to-all on CUDA tensors over gloo end the rank with a
segmentation fault (torch 2.11, H100), in the wait on gloo's CUDA work.
:func:`stage_collectives_through_host` stages DTensor's collectives of
CUDA tensors through the host explicitly: the local shard is copied to
page-locked host memory, exchanged by gloo's CPU path and waited at once,
and copied back; :func:`staged_bytes` counts the bytes copied and the
seconds of the copies and of the exchanges.  It is a device of
that rig, not of the sharded step: :func:`run_ranks` installs it where
its caller asks (``stage_through_host=True``), and the staged bytes are
the rig's host copies, not the step's collective volume (a staged
all-to-all is an all-gather and a chunk).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "shard_batch",
           "LogicalMesh", "run_ranks", "stage_collectives_through_host",
           "staged_bytes", "reset_staged_bytes", "observe_staged"]


class LogicalMesh:
    """Axis names and sizes, no devices: ``axis_names`` and a name -> size
    ``shape``, the duck-typed mesh the sharding rules read."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError("LogicalMesh: one size per axis name")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16x16 pod (256 devices), or 2 pods = 512 devices with a 'pod' axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_local_mesh(*shape: int, device: str = DEFAULT_DEVICE):
    """A ``DeviceMesh`` over the initialised process group of as many ranks
    as its size: ``(data, model)``, or ``(pod, data, model)`` given three
    sizes (each 1 where not given); ``device`` is its device type
    (``"cuda"`` by default, which raises without a card; ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) > 3:
        raise ValueError(f"make_local_mesh: (data, model) or (pod, data, "
                         f"model), got {shape}")
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    sizes = tuple(shape) + (1,) * (len(axes) - len(shape))
    return init_device_mesh(resolve_device(device).type, sizes,
                            mesh_dim_names=axes)


def shard_batch(*arrays):
    """The reference's contract: shard the leading (batch) axis of each
    array across the local devices, never changing a result, and return
    the arrays in order (a single array unwrapped).  One process drives one
    device here, so there are no local devices to split across and this is
    the identity, as the reference's is on one device."""
    return arrays if len(arrays) > 1 else arrays[0]


# --------------------------------------------------------------------------
# host staging of DTensor's collectives (CUDA tensors over gloo)
# --------------------------------------------------------------------------

_STAGED = dict(bytes=0, calls=0, to_host_s=0.0, exchange_s=0.0,
               to_device_s=0.0)
#: device types whose DTensor collectives are staged, and the functions
#: replaced (module, name, original)
_STAGE_DEVICES: set = set()
_REPLACED: list = []
_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT",
               "avg": "SUM"}


#: the one observer of the staged collectives (:func:`observe_staged`)
_OBSERVER: list = [None]


@contextlib.contextmanager
def observe_staged(fn: Callable, device_type: str):
    """For the block, tell ``fn(kind, payload_bytes, shape, group)`` of
    each collective a staged function stands in for: kind as
    ``launch.hlo_analysis`` names it, the payload by its convention (an
    all-gather's gathered output, any other collective's operand), and its
    process group.  The
    host exchanges inside are the rig's, not the step's, and lie on the
    host: an observer of ``device_type``'s collectives tells them apart by
    device, so CPU tensors staged through the host are refused.  One
    observer at a time."""
    if device_type in _STAGE_DEVICES and device_type == "cpu":
        raise RuntimeError("observe_staged: CPU collectives are staged "
                           "through the host in this process; their "
                           "exchanges cannot be told from the step's")
    if _OBSERVER[0] is not None:
        raise RuntimeError("observe_staged: an observer is installed")
    _OBSERVER[0] = fn
    try:
        yield
    finally:
        _OBSERVER[0] = None


def _observe(kind: str, t: torch.Tensor, pg, factor: int = 1) -> None:
    """Tell the observer of one collective of ``kind`` over the process
    group ``pg`` whose payload is ``factor`` times ``t``'s bytes."""
    if _OBSERVER[0] is not None:
        _OBSERVER[0](kind, factor * t.numel() * t.element_size(),
                     tuple(t.shape), pg)


def staged_bytes() -> Dict[str, float]:
    """Bytes copied between the card and the host by the staged
    collectives since the last reset (both directions), their number, and
    the host clock's seconds in the copies to the host, the exchanges and
    the copies back."""
    return dict(_STAGED)


def reset_staged_bytes() -> None:
    _STAGED.update(bytes=0, calls=0, to_host_s=0.0, exchange_s=0.0,
                   to_device_s=0.0)


def _count(*tensors) -> None:
    _STAGED["calls"] += 1
    _STAGED["bytes"] += sum(t.numel() * t.element_size() for t in tensors)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: page-locked when ``t`` is on a card, so that
    the copy runs at the DMA rate."""
    t0 = time.perf_counter()
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
    else:
        host = t.to("cpu", copy=True)
    _STAGED["to_host_s"] += time.perf_counter() - t0
    return host


def _host_empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype,
                       pin_memory=like.device.type == "cuda")


def _exchange(collective, *args, **kwargs) -> None:
    t0 = time.perf_counter()
    collective(*args, **kwargs)
    _STAGED["exchange_s"] += time.perf_counter() - t0


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    t0 = time.perf_counter()
    out = host.to(device)
    _STAGED["to_device_s"] += time.perf_counter() - t0
    return out


def _group(group, tag: str = ""):
    """The ProcessGroup a functional collective's ``group`` argument names
    (a mesh and dim, a name, or a group)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.distributed_c10d import _resolve_process_group

    if isinstance(group, tuple) and isinstance(group[0], DeviceMesh):
        return group[0].get_group(group[1])
    if isinstance(group, DeviceMesh):
        return group.get_group()
    if isinstance(group, dist.ProcessGroup):
        return group
    if isinstance(group, str):
        return _resolve_process_group(group)
    # rank lists: the functional collectives' own resolution (its name
    # differs across torch versions)
    resolve = getattr(funcol, "_resolve_group", None) or getattr(
        funcol, "_resolve_group_name")
    g = resolve(group, tag)
    return _resolve_process_group(g) if isinstance(g, str) else g


def _reduce_op(name: str):
    import torch.distributed as dist

    return getattr(dist.ReduceOp, _REDUCE_OPS[str(name).lower()])


def _gather_through_host(self, gather_dim: int, pg) -> torch.Tensor:
    import torch.distributed as dist

    n = pg.size()
    host = _to_host(self.contiguous())
    out = _host_empty((n * host.shape[0], *host.shape[1:]), self)
    _exchange(dist.all_gather_into_tensor, out, host, group=pg)
    _count(host, out)
    out = _to_device(out, self.device)
    if gather_dim:                # on the card: the host has one thread
        out = torch.cat(out.chunk(n, dim=0), dim=gather_dim)
    return out


def _all_gather(original):
    def all_gather(self, gather_dim, group, tag=""):
        if self.device.type not in _STAGE_DEVICES:
            return original(self, gather_dim, group, tag)
        pg = _group(group, tag)
        _observe("all-gather", self, pg, pg.size())
        return _gather_through_host(self, gather_dim, pg)
    return all_gather


def _reduce_scatter(original):
    def reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
        if self.device.type not in _STAGE_DEVICES:
            return original(self, reduceOp, scatter_dim, group, tag)
        import torch.distributed as dist

        pg = _group(group, tag)
        n = pg.size()
        _observe("reduce-scatter", self, pg)
        host = _to_host(torch.cat(self.chunk(n, dim=scatter_dim), dim=0))
        out = _host_empty((host.shape[0] // n, *host.shape[1:]), self)
        _exchange(dist.reduce_scatter_tensor, out, host,
                  op=_reduce_op(reduceOp), group=pg)
        _count(host, out)
        out = _to_device(out, self.device)
        if str(reduceOp).lower() == "avg":
            out = out / n
        return out
    return reduce_scatter


def _all_reduce(original):
    def all_reduce(self, reduceOp, group, tag=""):
        if self.device.type not in _STAGE_DEVICES:
            return original(self, reduceOp, group, tag)
        import torch.distributed as dist

        pg = _group(group, tag)
        _observe("all-reduce", self, pg)
        # a copy even on the host: the functional all-reduce leaves its
        # input as it was
        host = _to_host(self.detach())
        _exchange(dist.all_reduce, host, op=_reduce_op(reduceOp), group=pg)
        _count(host, host)
        out = _to_device(host, self.device)
        if str(reduceOp).lower() == "avg":
            out = out / pg.size()
        return out
    return all_reduce


def _all_to_all_single(original):
    def all_to_all_single(self, output_split_sizes, input_split_sizes, group,
                          tag=""):
        if self.device.type not in _STAGE_DEVICES:
            return original(self, output_split_sizes, input_split_sizes,
                            group, tag)
        import torch.distributed as dist

        pg = _group(group, tag)
        _observe("all-to-all", self, pg)
        host = _to_host(self.contiguous())
        rows = sum(output_split_sizes) if output_split_sizes else len(host)
        out = _host_empty((rows, *host.shape[1:]), self)
        _exchange(dist.all_to_all_single, out, host,
                  output_split_sizes=output_split_sizes,
                  input_split_sizes=input_split_sizes, group=pg)
        _count(host, out)
        return _to_device(out, self.device)
    return all_to_all_single


def _shard_dim_alltoall(original):
    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        """As DTensor runs it on a CPU mesh: an all-gather along
        ``gather_dim``, then this rank's chunk along ``shard_dim``."""
        if input.device.type not in _STAGE_DEVICES:
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        _observe("all-to-all", input, mesh.get_group(mesh_dim))
        whole = _gather_through_host(input, gather_dim,
                                     mesh.get_group(mesh_dim))
        n = mesh.size(mesh_dim)
        return whole.chunk(n, dim=shard_dim)[
            mesh.get_local_rank(mesh_dim)].contiguous()
    return shard_dim_alltoall


#: the torch release whose DTensor gathers and reduce-scatters through
#: ``all_gather_single`` / ``reduce_scatter_single`` (torch 2.11 calls the
#: ``_tensor`` names only and has no ``_single`` ones; 2.13 calls both)
_SINGLE_SINCE = (2, 12)


def _torch_version() -> tuple:
    return tuple(int(p) for p in torch.__version__.split("+")[0].split(".")[:2])


def stage_collectives_through_host(devices=("cuda",)) -> None:
    """Run DTensor's collectives on tensors of ``devices`` through the host:
    the functional all-gather, reduce-scatter, all-reduce, all-to-all and
    DTensor's shard-to-shard all-to-all, as DTensor and
    :mod:`repro_torch.parallel.act` call them (the module attributes
    of ``torch.distributed._functional_collectives`` and of DTensor's
    placements are replaced, for those devices only).  Each copies the
    local tensor to the host, runs the ``torch.distributed`` collective on
    gloo's CPU path, waits, and copies the result back: no work of gloo's
    CUDA path is left for DTensor to wait on (:data:`staged_bytes` counts
    the copies).  Idempotent; other devices keep the functions as they
    were.  Raises, replacing nothing, if this torch lacks one of the names
    its version's DTensor calls."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt

    if _REPLACED:
        _STAGE_DEVICES.update(devices)
        return
    staged = [(funcol, "all_gather_tensor", _all_gather),
              (funcol, "reduce_scatter_tensor", _reduce_scatter),
              (funcol, "all_reduce", _all_reduce),
              (funcol, "all_to_all_single", _all_to_all_single),
              (cu, "shard_dim_alltoall", _shard_dim_alltoall),
              (pt, "shard_dim_alltoall", _shard_dim_alltoall)]
    if _torch_version() >= _SINGLE_SINCE:
        # DTensor's gathers and reduce-scatters call these names instead
        staged += [(funcol, "all_gather_single", _all_gather),
                   (funcol, "reduce_scatter_single", _reduce_scatter)]
    for module, name, _ in staged:
        if not hasattr(module, name):
            raise RuntimeError(f"stage_collectives_through_host: "
                               f"{module.__name__}.{name} is not in torch "
                               f"{torch.__version__}")
    _STAGE_DEVICES.update(devices)
    for module, name, wrap in staged:
        original = getattr(module, name)
        _REPLACED.append((module, name, original))
        setattr(module, name, wrap(original))


# --------------------------------------------------------------------------
# ranks
# --------------------------------------------------------------------------

def _rank_main(rank: int, world: int, store_path: str, out_dir: str,
               fn: Callable, args: tuple, device: str,
               stage_through_host: bool) -> None:
    """One rank: one thread for torch, the process group, ``fn``, the
    result pickled to ``out_dir/<rank>.pkl`` (an exception's traceback
    instead, re-raised by :func:`run_ranks`)."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()            # a crash in a collective shows where
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    if stage_through_host:
        stage_collectives_through_host((torch.device(device).type,))
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        result: Dict[str, Any] = dict(ok=fn(rank, world, *args))
    except BaseException:                           # reported, then re-raised
        result = dict(error=traceback.format_exc())
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if "error" in result:
        raise RuntimeError(f"rank {rank} failed")
    dist.barrier()
    dist.destroy_process_group()


def _peer_gone(error: str) -> bool:
    """Whether a rank's traceback is gloo's report that a peer left."""
    return any(m in error for m in ("Connection closed by peer",
                                    "Connection reset by peer",
                                    "Broken pipe"))


def run_ranks(fn: Callable, world: int, *args, device: str = DEFAULT_DEVICE,
              stage_through_host: bool = False) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` new processes joined in
    one gloo process group, and return their results in rank order.

    ``fn`` must be importable from a module (``spawn`` pickles it by
    name), and so must its arguments and results.  Each rank runs torch on
    one thread; with ``device="cuda"`` (the default) every rank uses the card
    (``cuda:0`` unless given), which gloo's collectives reach through the
    host.  ``stage_through_host`` installs
    :func:`stage_collectives_through_host` for ``device`` on every rank:
    ranks that share one card over gloo need it for DTensor.  Raises with
    the traceback of a rank that failed on its own, not because a peer
    left (those read only that gloo's connection closed), or else with
    the exit status of the rank that ended without a result (killed by a
    signal).  Raises before starting any rank where ``device`` is a card
    and there is none."""
    import torch.multiprocessing as mp

    resolve_device(device)

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        try:
            mp.start_processes(_rank_main,
                               args=(world, store, tmp, fn, args, device,
                                     stage_through_host),
                               nprocs=world, join=True, start_method="spawn")
        except Exception as exc:
            errors = {}
            for r in range(world):
                path = os.path.join(tmp, f"{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        res = pickle.load(f)
                    if "error" in res:
                        errors[r] = res["error"]
            # a rank whose peer has left fails in gloo's transport: the
            # cause is the rank that failed otherwise, or ended unreported
            own = [r for r, e in errors.items() if not _peer_gone(e)]
            first = getattr(exc, "error_index", None)
            if own:
                raise RuntimeError(f"rank {own[0]} of {world} failed:\n"
                                   + errors[own[0]]) from exc
            if first is not None and first not in errors:
                raise RuntimeError(f"rank {first} of {world} ended without "
                                   f"a result: {exc}") from exc
            if errors:
                r = min(errors)
                raise RuntimeError(f"rank {r} of {world} failed:\n"
                                   + errors[r]) from exc
            raise
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f)["ok"])
        return out
