"""Rank entry points for :func:`repro_torch.launch.mesh.run_ranks`.

Each function runs on every rank of an initialised process group and
returns what its caller compares: ``spawn`` pickles them by name, so they
live in the package.

* :func:`sharded_train_steps` -- the reference's sharded-execution check:
  parameters, optimizer state and batch placed on a (data, model) mesh by
  ``param_pspecs`` / ``opt_pspecs`` / ``batch_pspecs``, then train steps
  inside ``activation_mesh``; returns each step's metrics.
* :func:`embedding_rank` -- the embedding lookup alone and its backward on
  a mesh, each rank's shards held to the plain lookup and gradient.
* :func:`loss_grads_rank` -- the loss's gradient with respect to a few
  parameters only, on a mesh, from given whole parameters; returns them
  whole and the step's collectives.
* :func:`sharded_serving_steps` -- the prefill and decode steps on DTensor
  parameters and caches placed by the rules; returns the whole logits and
  caches.
* :func:`ep_moe_rank` -- :func:`repro_torch.parallel.ep_moe.ep_moe_forward`
  on a (data, model) mesh; returns the whole output and the routing.
* :func:`moe_forward_rank` -- the DTensor ``moe_forward`` with the groups
  on every rank, so that DTensor's all-to-alls carry the dispatch (float8
  under the float8 dispatch); returns the whole output, the routing and
  the staged collectives.
* :func:`local_shards` -- arrays placed by partition specs on a named
  mesh; returns this rank's shards.
* :func:`summed_shards_rank` -- ``act.per_shard`` with a summed label on
  a CPU mesh; returns the partial result and the input's gradient.
* :func:`with_host_staging` -- one of the above with DTensor's
  collectives staged through the host on this device type too
  (:func:`repro_torch.launch.mesh.stage_collectives_through_host`).
* :func:`run_jobs` -- several of the above in one launch.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["sharded_train_steps", "sharded_serving_steps", "ep_moe_rank",
           "moe_forward_rank", "moe_inputs", "summed_shards_rank",
           "grouped_redistribute_rank", "loss_grads_rank", "embedding_rank",
           "local_shards", "with_host_staging", "run_jobs", "train_batch",
           "whole_leaves"]


def train_batch(cfg, B: int, S: int, device, step: int = 0
                ) -> Dict[str, torch.Tensor]:
    """The data pipeline's synthetic batch ``step`` (seed 0) as tensors."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch

    dc = DataConfig(global_batch=B, seq_len=S, vocab_size=cfg.vocab_size)
    batch = synthetic_batch(dc, step, frontend=cfg.frontend,
                            d_model=cfg.d_model)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def whole_leaves(tree, limit: Optional[int] = None
                 ) -> Dict[int, np.ndarray]:
    """Each leaf of at most ``limit`` elements (every leaf if None), whole
    (a DTensor's ``full_tensor()``: pending partial sums reduced), as a
    float32 numpy copy (a replicated leaf's ``full_tensor()`` is its own
    storage, which a later step updates in place), by its index in
    ``repro_torch.tree`` order.  Every rank of a mesh must call it: the
    sharded leaves are gathered."""
    from repro_torch import tree as T

    from .act import is_sharded

    out = {}
    for i, t in enumerate(T.leaves(tree)):
        if limit is not None and t.numel() > limit:
            continue
        t = t.full_tensor() if is_sharded(t) else t
        out[i] = t.detach().float().cpu().numpy().copy()
    return out


def _count_launches():
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import mamba_scan as K4
    from repro_torch.kernels import rmsnorm as K5

    return dict(rmsnorm=K5.launches(), flash_attention=K3.launches(),
                flash_attention_backward=K3.backward_launches(),
                mamba_scan=K4.launches())


def _release(dev) -> None:
    """This process's cached, unused device memory back to the card, for
    the other ranks sharing it."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _in_turn(rank: int, world: int, dev, make: Callable[[], Any]) -> Any:
    """``make()`` on this rank, and its freed device memory handed back.
    Ranks that share one card take turns, a barrier apart, so that one
    rank's transient peak (whole parameters, and the copies DTensor makes
    of their shards) meets only the others' results, never their peaks:
    eight ranks drawing qwen2-7b's float32 parameters at once filled an
    80 GB card.  ``make`` must issue no collective."""
    import torch.distributed as dist

    if dev.type != "cuda":
        return make()
    out = None
    for r in range(world):
        if r == rank:
            out = make()
            gc.collect()
            _release(dev)
        dist.barrier()
    return out


def sharded_train_steps(rank: int, world: int, cfgs: List[Any], opt_cfg,
                        B: int, S: int, mesh_shape, device: str,
                        steps: int = 1, leaves: Optional[int] = 0,
                        account: bool = False,
                        states: bool = False) -> List[Dict]:
    """For each config: initial state from seed 0 (the same on every rank,
    as the single-device step it is held to draws it), placed by the rules
    on a ('data', 'model') or ('pod', 'data', 'model') mesh of
    ``mesh_shape``, then ``steps`` train steps on data steps 0, 1, ...
    With ``account``, step 0 runs counted by ``launch.dryrun.Accounting``
    (``accounting``: its totals, ``collectives``: each collective's row,
    op with the mesh axes its group spans and local shapes, and
    ``collective_issuers``: each one's issuing functions, in order).
    Returns per config the steps' metrics
    (floats), the seconds of each step, the K3 / K4 / K5 launches of this
    rank, and its peak device memory, allocated and reserved (CUDA); on
    rank 0 also, by :func:`whole_leaves`, for the leaves of at most
    ``leaves`` elements (0: none, None: every leaf), each step's gradients
    (``grads``, a list by step) and the parameters after the steps
    (``params_after``), and the device bytes allocated when the peak was
    reset (after placement: the arguments, and anything an earlier job of
    the process left); with ``states``, also each step's parameters and
    optimizer state after it, every leaf whole (``states``, a list by step
    of (params, opt) :func:`whole_leaves` pairs), from which one device
    can run the next step from the mesh's own state."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import mamba_scan as K4
    from repro_torch.kernels import rmsnorm as K5
    from repro_torch.launch.dryrun import Accounting
    from repro_torch.launch.mesh import (make_local_mesh, reset_staged_bytes,
                                         staged_bytes)
    from repro_torch.parallel import sharding as sh
    from repro_torch import tree as T
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.steps import make_train_step

    dev = torch.device(device)
    mesh = make_local_mesh(*mesh_shape, device=dev.type)
    out = []
    for cfg in cfgs:
        gc.collect()                # an earlier job's cycles off the card
        _release(dev)
        shape = ShapeSpec("t", S, B, "train")
        # whole parameters from the seed, then this rank's shards (copies,
        # so the whole tensors are freed, and their memory handed back to
        # the card for the other ranks sharing it); the AdamW state is
        # made beside the shards, at the placements opt_pspecs gives
        params = _in_turn(rank, world, dev, lambda: sh.device_put(
            init_params(cfg, seed=0, device=dev),
            sh.to_shardings(sh.param_pspecs(cfg, mesh), mesh)))
        opt = adamw_init(params, opt_cfg)
        want = sh.to_shardings(sh.opt_pspecs(cfg, mesh), mesh)
        for t, ns in zip(T.leaves(opt), T.leaves(want)):
            if t.dim() and tuple(t.placements) != ns.placements:
                raise AssertionError(f"{cfg.name}: optimizer state placed "
                                     f"{t.placements}, opt_pspecs "
                                     f"{ns.placements}")
        b_sh = sh.to_shardings(sh.batch_pspecs(cfg, shape, mesh), mesh)
        metrics, seconds, grads, after_steps = [], [], [], []
        acc = Accounting(dev.type, mesh) if account else None

        def keep(g):
            """The gradients' small leaves, gathered on every rank (not
            counted with the step's collectives)."""
            with acc.paused() if acc is not None else \
                    contextlib.nullcontext():
                grads.append(whole_leaves(g, leaves))
        step = make_train_step(cfg, opt_cfg,
                               on_grads=None if leaves == 0 else keep)
        reset_staged_bytes()
        for K in (K3, K4, K5):
            K.reset_launches()
        K3.reset_backward_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        at_reset = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                    else None)
        for i in range(steps):
            batch = sh.device_put(train_batch(cfg, B, S, dev, i), b_sh)
            t0 = time.perf_counter()
            with sh.activation_mesh(mesh), (
                    acc if acc is not None and i == 0
                    else contextlib.nullcontext()):
                params, opt, m = step(params, opt, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            if states:
                after_steps.append((whole_leaves(params),
                                    whole_leaves(opt)))
        local = sum(t.to_local().numel() for t in T.leaves(params))
        whole = sum(t.numel() for t in T.leaves(params))
        after = whole_leaves(params, leaves) if leaves != 0 else {}
        row = dict(arch=cfg.name, metrics=metrics, seconds=seconds,
                   local_param_elements=local, param_elements=whole,
                   host_staged=staged_bytes(), launches=_count_launches(),
                   peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None),
                   peak_reserved_bytes=(torch.cuda.max_memory_reserved(dev)
                                        if dev.type == "cuda" else None),
                   allocated_at_reset_bytes=at_reset)
        if acc is not None:
            row.update(accounting=acc.summary(), collectives=[
                (op, shapes) for op, shapes, flops, _, _ in acc.rows
                if not flops], collective_issuers=[
                fns for _, _, flops, _, fns in acc.rows if not flops])
        if rank == 0:
            row.update(grads=grads, params_after=after)
            if states:
                row.update(states=after_steps)
        out.append(row)
        del params, opt
    return out


def loss_grads_rank(rank: int, world: int, params: Dict[str, Any],
                    batch: Dict[str, torch.Tensor], cfg, mesh_shape,
                    names: List[str], device: str = "cpu") -> Dict[str, Any]:
    """``models.model.loss_fn``'s gradient with respect to the top-level
    parameters ``names`` alone (autograd forms no other gradient), on a
    ('data', 'model') mesh of ``mesh_shape``: the whole ``params`` and
    ``batch`` are the same on every rank, which keeps its shards, placed
    by the rules; the step is counted by ``launch.dryrun.Accounting``.
    Returns the loss, each named gradient whole (float32 numpy) and each
    collective's row (op with the mesh axes its group spans, local
    shapes, bytes, issuing functions)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import Accounting
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import loss_fn
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.steps import _replicating

    dev = torch.device(device)
    mesh = make_local_mesh(*mesh_shape, device=dev.type)
    B, S = batch["labels"].shape
    params = sh.device_put(params, sh.to_shardings(
        sh.param_pspecs(cfg, mesh), mesh))
    batch = sh.device_put(batch, sh.to_shardings(sh.batch_pspecs(
        cfg, ShapeSpec("t", S, B, "train"), mesh), mesh))
    leaves = [params[n].requires_grad_(True) for n in names]
    acc = Accounting(dev.type, mesh)
    with sh.activation_mesh(mesh), _replicating(True), acc:
        loss, _ = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return dict(loss=float(loss.full_tensor()),
                grads={n: g.full_tensor().float().cpu().numpy()
                       for n, g in zip(names, grads)},
                collectives=[(op, shapes, nbytes, fns) for op, shapes,
                             flops, nbytes, fns in acc.rows if not flops])


def _own(t, mesh, placements, whole: torch.Tensor) -> torch.Tensor:
    """The block of ``whole`` that this rank's shard of a DTensor of
    ``placements`` on ``mesh`` holds."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape, offset = compute_local_shape_and_global_offset(
        whole.shape, mesh, placements)
    return whole[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def embedding_rank(rank: int, world: int, cfg, B: int, S: int, mesh_shape,
                   device: str = "cpu") -> Dict[str, Any]:
    """``models.model._embed_in``'s lookup alone and its backward, on a
    ('data', 'model') or ('pod', 'data', 'model') mesh of ``mesh_shape``:
    the (V, D) table drawn normal with std 0.02 from ``torch`` seed 0 on
    the device, placed by ``param_pspecs``, ``train_batch``'s step-0
    tokens placed by ``batch_pspecs``, and the loss ``sum(x * c)`` with c
    (B, S, D) normal from seed 1, placed on the batch axes as the tokens
    are (as the reference's lookup is lowered with it, so that the
    result's gradient moves as there); the pass is counted by
    ``launch.dryrun.Accounting`` and timed.  Each rank holds its own shards to the
    plain lookup ``table[tokens]`` and the plain gradient (c's rows added
    into the table's, in float32) of the whole table it drew.  Returns
    the largest difference of its output shard (a lookup moves values
    exactly), its gradient shard's relative L2 error, the pass's seconds
    and each
    collective's row (op with the mesh axes its group spans, local
    shapes)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import Accounting
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import _embed_in, dtype_of
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.steps import _replicating

    dev = torch.device(device)
    mesh = make_local_mesh(*mesh_shape, device=dev.type)
    V, D = cfg.vocab_size, cfg.d_model
    gen = torch.Generator(device=dev)
    table = (torch.randn(V, D, generator=gen.manual_seed(0), device=dev)
             * 0.02).to(dtype_of(cfg.param_dtype))
    c = torch.randn(B, S, D, generator=gen.manual_seed(1), device=dev)
    tokens = train_batch(cfg, B, S, dev, 0)["tokens"]
    spec = sh.param_pspecs(cfg, mesh)["embed"]
    placed = sh.device_put({"embed": table}, sh.to_shardings(
        {"embed": spec}, mesh))["embed"].requires_grad_(True)
    t_spec = sh.batch_pspecs(cfg, ShapeSpec("t", S, B, "train"),
                             mesh)["tokens"]
    batch = sh.device_put({"tokens": tokens}, sh.to_shardings(
        {"tokens": t_spec}, mesh))
    c_placed = sh.device_put({"c": c}, sh.to_shardings(
        {"c": sh.P(*t_spec, None)}, mesh))["c"]
    acc = Accounting(dev.type, mesh)
    t0 = time.perf_counter()
    with sh.activation_mesh(mesh), _replicating(True), acc:
        x = _embed_in({"embed": placed}, batch, cfg)
        (grad,) = torch.autograd.grad((x.float() * c_placed).sum(), [placed])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    want_x = table[tokens.long()].to(x.dtype)
    want_g = torch.zeros(V, D, device=dev).index_add_(
        0, tokens.reshape(-1).long(), c.reshape(-1, D))
    got_x = x.to_local().detach().float()
    got_g = grad.to_local().float()
    own_g = _own(grad, mesh, grad.placements, want_g)
    return dict(
        out_max_abs=float((got_x - _own(x, mesh, x.placements, want_x)
                           .float()).abs().max()),
        grad_rel_l2=float((got_g - own_g).norm() / own_g.norm()),
        seconds=seconds,
        collectives=[(op, shapes) for op, shapes, flops, _, _ in acc.rows
                     if not flops])


def serving_tokens(cfg, B: int, steps: int) -> np.ndarray:
    """The decode steps' input tokens, (steps, B) int32 from numpy seed 1."""
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (steps, B)).astype(np.int32)


def sharded_serving_steps(rank: int, world: int, cfgs: List[Any], B: int,
                          S: int, mesh_shape, device: str,
                          decode_steps: int = 2) -> List[Dict]:
    """For each config (token input): parameters from seed 0 placed by
    ``param_pspecs`` on a ('data', 'model') mesh of ``mesh_shape``; a
    prefill (``make_prefill_step``, caches of ``S + decode_steps``
    positions) of the synthetic batch's (B, S) tokens placed by
    ``batch_pspecs``; its caches redistributed to ``cache_pspecs``; then
    ``decode_steps`` decode steps of :func:`serving_tokens` at positions
    S, S + 1, ..., each position a 0-d tensor.  Returns on rank 0 the
    whole logits of the prefill and of each decode step and the whole
    caches after the prefill and after the last step (float32 numpy, by
    leaf index)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import init_params
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    dev = torch.device(device)
    mesh = make_local_mesh(*mesh_shape, device=dev.type)
    out = []
    for cfg in cfgs:
        L = S + decode_steps
        params = sh.device_put(init_params(cfg, seed=0, device=dev),
                               sh.to_shardings(sh.param_pspecs(cfg, mesh),
                                               mesh))
        shape = ShapeSpec("serve", L, B, "prefill")
        batch = {"tokens": train_batch(cfg, B, S, dev)["tokens"]}
        batch = sh.device_put(batch, sh.to_shardings(
            sh.batch_pspecs(cfg, shape, mesh), mesh))
        cache_spec = sh.cache_pspecs(cfg, shape, mesh)
        with sh.activation_mesh(mesh):
            logits, caches = make_prefill_step(cfg, max_len=L)(params, batch)
            caches = sh.reshard(caches, cache_spec, mesh)
            steps = [logits.full_tensor()]
            after = [whole_leaves(caches)]
            decode = make_decode_step(cfg)
            for i, tok in enumerate(serving_tokens(cfg, B, decode_steps)):
                token = sh.device_put(torch.from_numpy(tok).to(dev),
                                      sh.NamedSharding(mesh, sh.P(
                                          sh.serving_batch_axes(mesh, B))))
                pos = torch.tensor(S + i, dtype=torch.int32, device=dev)
                logits, caches = decode(params, token, caches, pos)
                caches = sh.reshard(caches, cache_spec, mesh)
                steps.append(logits.full_tensor())
            after.append(whole_leaves(caches))
        row = dict(arch=cfg.name)
        if rank == 0:
            row.update(logits=[t.float().cpu().numpy() for t in steps],
                       caches=after)
        out.append(row)
    return out


def moe_inputs(cfg, G: int, S: int, seed: int, device, experts=None
               ) -> Dict[str, torch.Tensor]:
    """Random MoE-layer inputs in ``cfg.compute_dtype`` on ``device``: x
    (G, S, D) and the router (D, E) from ``seed``, and ``wg``, ``wu`` (e, D,
    F), ``wd`` (e, F, D) for the experts in ``experts`` (default all), each
    expert drawn from its own seed, so a rank draws its shard alone and
    gets the same numbers as a whole draw."""
    from repro_torch.models.model import dtype_of

    dt = dtype_of(cfg.compute_dtype)
    dev = torch.device(device)
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    experts = range(E) if experts is None else experts
    gen = torch.Generator(device=dev)

    def draw(shape, scale, s):
        gen.manual_seed(s)
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    out = dict(x=draw((G, S, D), 1.0, seed),
               router=draw((D, E), D ** -0.5, seed + 1))
    for i, (name, shape, fan) in enumerate((("wg", (D, F_), D),
                                            ("wu", (D, F_), D),
                                            ("wd", (F_, D), F_))):
        out[name] = torch.stack([draw(shape, fan ** -0.5,
                                      seed + 2 + 3 * e + i) for e in experts])
    return out


def _moe_rank_inputs(mesh, inputs: Dict[str, Any], cfg, dev):
    """This rank's MoE-layer inputs: x (G, S, D) and the router (D, E)
    whole, and the experts ``wg``, ``wu``, ``wd`` as DTensors sharded on
    'model'.  ``inputs`` holds either the whole ``router``, ``wg``, ``wu``,
    ``wd`` and ``x`` as numpy arrays (the rank keeps its shards), or
    ``seed``, ``G`` and ``S``: then the rank draws x, the router and only
    its own experts by :func:`moe_inputs`."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from .act import mesh_axes

    axes = mesh_axes(mesh)
    on_model = [Shard(0) if a == "model" else Replicate() for a in axes]
    if "seed" in inputs:
        m, per = mesh.get_local_rank("model"), cfg.n_experts // axes["model"]
        drawn = moe_inputs(cfg, inputs["G"], inputs["S"], inputs["seed"],
                           dev, range(m * per, (m + 1) * per))
        experts = {n: DTensor.from_local(drawn[n], mesh, on_model)
                   for n in ("wg", "wu", "wd")}
    else:
        drawn = {k: torch.from_numpy(inputs[k]).to(dev)
                 for k in ("router", "wg", "wu", "wd", "x")}
        experts = {n: distribute_tensor(drawn[n], mesh, on_model,
                                        src_data_rank=None)
                   for n in ("wg", "wu", "wd")}
    return drawn["x"], drawn["router"], experts


def _timed_on(dev: torch.device, fn):
    """``fn()`` and what it cost on ``dev``: its seconds (to the device's
    end) and, on a card, its peak device memory allocated and reserved."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = fn()
    if cuda:
        torch.cuda.synchronize(dev)
    return res, dict(
        seconds=time.perf_counter() - t0,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if cuda
        else None,
        peak_reserved_bytes=torch.cuda.max_memory_reserved(dev) if cuda
        else None)


def ep_moe_rank(rank: int, world: int, inputs: Dict[str, Any], cfg,
                mesh_shape, device: str) -> Dict[str, Any]:
    """``ep_moe_forward`` on a ('data', 'model') mesh of ``mesh_shape``,
    ``inputs`` as :func:`_moe_rank_inputs` takes them.  Returns the
    all-to-alls this rank issued and their bytes, the seconds of the
    forward, its peak device memory, allocated and reserved (CUDA), and on
    rank 0 the whole output (float32 numpy) and the whole dispatch
    table."""
    from repro_torch.launch.mesh import make_local_mesh

    from .ep_moe import ep_moe_forward, exchange_stats, reset_exchange_stats

    dev = torch.device(device)
    mesh = make_local_mesh(*mesh_shape, device=dev.type)
    x, router, experts = _moe_rank_inputs(mesh, inputs, cfg, dev)
    reset_exchange_stats()
    (y, dispatch), cost = _timed_on(dev, lambda: ep_moe_forward(
        mesh, dict(router=router, **experts), x, cfg, return_dispatch=True))
    y, dispatch = y.full_tensor(), dispatch.full_tensor()
    out = dict(**cost, **exchange_stats())
    if rank == 0:
        out.update(y=y.float().cpu().numpy(), dispatch=dispatch.cpu().numpy())
    return out


def moe_forward_rank(rank: int, world: int, inputs: Dict[str, Any], cfg,
                     mesh_shape, device: str,
                     dispatch_dtypes=("bfloat16",)) -> Dict[str, Any]:
    """The DTensor ``moe_forward`` on a ('data', 'model') or ('pod',
    'data', 'model') mesh of ``mesh_shape``, inside ``activation_mesh``:
    token groups spread over
    every rank (G sharded on both axes), the experts on 'model', so the
    slots cross the model axis at the EP constraint by DTensor's
    all-to-all (the dispatch, float8 with its scales under the float8
    dispatch); the combine scatters each rank's own slots and sums the
    result over the ranks.  ``inputs`` as
    :func:`_moe_rank_inputs` takes them.  Runs once for each
    ``moe_dispatch_dtype`` in ``dispatch_dtypes`` on the same inputs.
    Returns per dtype the seconds, the peak device memory (CUDA), the
    bytes the host staging copied (when it is installed), each staged
    collective a card rank's forward stands in for (kind, payload bytes,
    local shape, ranks in its group) and the forward's seconds by part
    (:func:`repro_torch.models.moe.timed_parts`: CUDA events on a card);
    on rank 0 also the whole output (float32 numpy) and the whole dispatch
    table that forward routed by."""
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.moe import capacity, moe_forward, timed_parts

    from .act import activation_mesh

    dev = torch.device(device)
    mesh = mesh_mod.make_local_mesh(*mesh_shape, device=dev.type)
    x, router, experts = _moe_rank_inputs(mesh, inputs, cfg, dev)
    n_axes = len(mesh.mesh_dim_names)
    x = distribute_tensor(x, mesh, [Shard(0)] * n_axes, src_data_rank=None)
    router = distribute_tensor(router, mesh, [Replicate()] * n_axes,
                               src_data_rank=None)
    params = dict(router=router, **experts)
    cuda = dev.type == "cuda"
    out: Dict[str, Any] = {}
    with activation_mesh(mesh):
        for dt in dispatch_dtypes:
            c = dataclasses.replace(cfg, moe_dispatch_dtype=dt)
            seen: List[tuple] = []
            observe = (mesh_mod.observe_staged(
                lambda kind, nbytes, shape, pg: seen.append(
                    (kind, nbytes, shape, pg.size())), dev.type)
                       if cuda else contextlib.nullcontext())
            mesh_mod.reset_staged_bytes()
            with observe, torch.no_grad(), timed_parts(dev) as parts:
                (y, _, dispatch), cost = _timed_on(dev, lambda: moe_forward(
                    params, x, c, return_dispatch=True))
            row = dict(**cost, staged=mesh_mod.staged_bytes(),
                       collectives=seen, parts=parts)
            y, dispatch = y.full_tensor(), dispatch.full_tensor()
            if rank == 0:
                row.update(y=y.float().cpu().numpy(),
                           dispatch=dispatch.cpu().numpy())
            del y, dispatch
            out[dt] = row
    out["capacity"] = capacity(x.shape[1], cfg.n_experts, cfg.experts_per_token,
                               cfg.capacity_factor)
    return out


def summed_shards_rank(rank: int, world: int, mesh_shape) -> Dict[str, Any]:
    """``act.per_shard`` with a summed label on a CPU ('data', 'model')
    mesh of ``mesh_shape``: x (4, 8) of small integers (sums exact), rows
    on 'data' and columns on 'model', summed over its columns with the
    columns' label summed.  Returns the result's placements and whole
    value, and the gradient of ``sum(w * y)`` (w = 1, 2, 3, 4 by row):
    its placements, this rank's local shape and whole value."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch import mesh as mesh_mod

    from .act import per_shard

    del rank, world
    mesh = mesh_mod.make_local_mesh(*mesh_shape, device="cpu")
    whole = (torch.arange(32, dtype=torch.float32).reshape(4, 8) % 7) - 3
    x = distribute_tensor(whole, mesh, [Shard(0), Shard(1)],
                          src_data_rank=None).requires_grad_(True)
    y = per_shard(lambda t: t.sum(-1), (x,), (("b", "n"),), (("b",),),
                  frozenset({"b"}), summed=frozenset({"n"}))
    w = torch.arange(1, 5, dtype=torch.float32)
    (y.full_tensor() * w).sum().backward()
    def kinds(t):
        return [(type(p).__name__, getattr(p, "dim", None))
                for p in t.placements]

    return dict(placements=kinds(y), y=y.full_tensor().detach().numpy(),
                grad_placements=kinds(x.grad), x_placements=kinds(x),
                grad_local_shape=tuple(x.grad.to_local().shape),
                x_local_shape=tuple(x.to_local().shape),
                grad=x.grad.full_tensor().numpy())


def grouped_redistribute_rank(rank: int, world: int, mesh_shape,
                              device: str = "cpu", count: bool = True
                              ) -> Dict[str, Any]:
    """``act.redistribute`` against DTensor's own ``redistribute`` on a
    ('data', 'model') mesh of ``mesh_shape`` on ``device`` (its
    collectives staged through the host where :func:`run_ranks` stages
    them), for the two changes it makes
    in one collective over both axes: a (4, 6) float64 sum ``Partial`` on
    both to ``Replicate`` (each rank's share of small integers: sums
    exact), and a (4, 6) tensor ``Shard(0)`` on both to ``Replicate``.
    Each result's backward runs on a ``Partial`` gradient (both axes) of
    its own small integers.  Returns, per case and path, this rank's
    result and gradient (local shards), the gradient's placements, and
    (with ``count``) the collectives ``dryrun.Accounting`` counts by kind
    in the forward and in the backward, with those over both axes at once
    (CPU collectives staged through the host cannot be counted)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod

    from .act import redistribute

    del world
    # a mesh of its own for DTensor's path: uncounted (outside Accounting,
    # which turns that off), torch 2.13's DTensor merges per-axis
    # collectives itself over a flattened mesh once one exists
    dev = torch.device(device)
    meshes = {path: mesh_mod.make_local_mesh(*mesh_shape, device=dev.type)
              for path in ("dtensor", "grouped")}
    whole = [Replicate(), Replicate()]
    both = [Partial(), Partial()]
    local = (torch.arange(24, dtype=torch.float64, device=dev).reshape(4, 6)
             * (rank + 1)) % 5
    cases = dict(sum=(local, both), gather=(
        local[:4 // meshes["grouped"].size()], [Shard(0), Shard(0)]))
    out: Dict[str, Any] = {}
    for name, (t, placements) in cases.items():
        for path, mesh in meshes.items():
            x = DTensor.from_local(t.clone(), mesh, placements,
                                   shape=(4, 6), stride=(6, 1)
                                   ).requires_grad_(True)
            g = DTensor.from_local(local % 3 + rank, mesh, both,
                                   shape=(4, 6), stride=(6, 1))
            fwd = D.Accounting(dev.type, mesh)
            with fwd if count else contextlib.nullcontext():
                y = (redistribute(x, mesh, whole) if path == "grouped"
                     else x.redistribute(mesh, whole))
            bwd = D.Accounting(dev.type, mesh)
            with bwd if count else contextlib.nullcontext():
                y.backward(g)
            out[name, path] = dict(
                y=y.to_local().detach().cpu().numpy(),
                placements=[type(p).__name__ for p in y.placements],
                grad=x.grad.to_local().cpu().numpy(),
                grad_placements=[(type(p).__name__, getattr(p, "dim", None))
                                 for p in x.grad.placements],
                forward={k: v for k, v in fwd.collective_counts.items() if v},
                backward={k: v for k, v in bwd.collective_counts.items()
                          if v},
                flattened={k: v for k, v in fwd.flattened_counts.items()
                           if v},
                rows=[r[0] for r in fwd.rows + bwd.rows if not r[2]])
    return out


def local_shards(rank: int, world: int, mesh_shape, axis_names,
                 arrays: List[np.ndarray], specs: List[tuple]
                 ) -> List[np.ndarray]:
    """Each array placed by its spec (``sharding.device_put``) on a CPU
    mesh of ``mesh_shape`` named ``axis_names``; this rank's shards."""
    from torch.distributed.device_mesh import init_device_mesh

    from . import sharding as sh

    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=tuple(axis_names))
    placed = sh.device_put([torch.from_numpy(a) for a in arrays],
                           [sh.NamedSharding(mesh, sh.P(*p)) for p in specs])
    return [t.to_local().numpy() for t in placed]


def run_jobs(rank: int, world: int, jobs: List[tuple]) -> List[Any]:
    """``fn(rank, world, *args)`` for each ``(fn, args)`` in ``jobs``, in
    order, on one process group: one launch for several checks."""
    return [fn(rank, world, *args) for fn, args in jobs]


def with_host_staging(rank: int, world: int, device_type: str, fn,
                      args: tuple) -> Any:
    """``fn(rank, world, *args)`` with DTensor's collectives on
    ``device_type`` tensors staged through the host (what ranks sharing
    one card over gloo run), and the staged bytes: a CPU check of the staging.  The
    staging stays installed in this process."""
    from repro_torch.launch.mesh import (reset_staged_bytes, staged_bytes,
                                         stage_collectives_through_host)

    stage_collectives_through_host((device_type,))
    reset_staged_bytes()
    return fn(rank, world, *args), staged_bytes()
