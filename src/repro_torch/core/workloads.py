"""ML-workload lowering: model config + parallelism spec -> executed step time
(PyTorch port of the reference module).

The paper's claim is that the spectral gap predicts interconnect performance;
:mod:`repro_torch.core.simulate` executes synthetic collectives, but a real
training job is a *mix* of collectives with byte counts fixed by the model
architecture and the parallelism layout.  This module lowers the model
configs into that mix:

1. :func:`parse_workload` parses ``"kimi_k2_1t@dp=64,tp=8,ep=16"`` into a
   :class:`WorkloadSpec` — an architecture from :mod:`repro_torch.configs`
   plus a (data, tensor, expert)-parallel layout over ``world = dp * tp``
   ranks.
2. :func:`plan_workload` emits the per-training-step :class:`CommPlan`: one
   :class:`CommPhase` per collective stream, with closed-form byte counts —

   * **DP gradient all-reduce** — sized by the parameter shapes
     (:func:`repro_torch.models.model.param_shapes`), divided by each
     parameter's tensor-parallel shard factor read from the sharding rules
     (:func:`repro_torch.parallel.sharding.param_pspecs`), and bucketized
     (:data:`BUCKET_BYTES`);
   * **TP all-gather / reduce-scatter per layer** — one pair per
     ``'model'``-sharded matmul pair found in the sharding rules (attention
     wq/wo, dense-MLP wg/wd, mamba in_proj/out_proj), moving the full
     activation ``tokens x d_model`` per direction (sequence-parallel
     lowering of the Megatron all-reduce), forward and backward;
   * **MoE all-to-all** — the padded ``(E, C, D)`` slot-tensor exchange of
     the reference's expert-parallel MoE (capacity ``C`` from
     :func:`repro_torch.models.moe.capacity`), dispatched in
     ``cfg.moe_dispatch_dtype`` and returned/back-propagated in the compute
     dtype, over expert-parallel groups of size ``ep`` carved from the data
     axis.

3. :func:`simulate_workload` compiles the plan onto ANY topology: logical
   ranks map to physical nodes via :func:`repro_torch.core.placement.
   place_ranks`, each phase lowers to a logical demand matrix on the host
   (ring rounds for all-reduce/all-gather/reduce-scatter, the full pair
   demand for all-to-all), :func:`repro_torch.core.simulate.
   _lower_demand_rounds` ECMP-routes it onto the padded gather-table slots
   (kernel K1's f64 form on the card), and the round engine drains them on
   ``device``.
4. :func:`hlo_crosscheck` re-emits the plan as a synthetic post-partitioning
   HLO module (:meth:`CommPlan.to_hlo`) and checks the per-kind byte totals
   against the independent :func:`repro_torch.launch.hlo_analysis.
   analyze_hlo` accounting.

The reference's ECMP loads are float32, the port's float64, so simulated
phase times agree with the reference's to about 1e-7 relative, not bit for
bit.  Units: bytes for payloads, seconds for times, tokens = sequence
positions.  Every time is a second of the *modeled* cluster
(:data:`~repro_torch.core.collectives.LINK_BW`,
:data:`~repro_torch.core.collectives.PER_HOP_LATENCY` and the compute
denominator :data:`repro_torch.launch.hlo_analysis.HW` ``["peak_flops"]``,
the reference's constants), never a time of the device the simulator runs
on.  Modeled: the three phase families above, compute time from the
6*N*T FLOP convention, DP/backward overlap (:data:`DP_OVERLAP_FRACTION`).
NOT modeled: embedding/loss collectives, router aux losses, pipeline
parallelism, HBM time.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.hlo_analysis import HW, analyze_hlo
from repro_torch.models import model as M
from repro_torch.models.moe import capacity
from repro_torch.parallel import sharding

from .collectives import LINK_BW, PER_HOP_LATENCY
from .graphs import Topology
from .placement import place_ranks
from .routing import DEFAULT_SOURCE_CHUNK, RoutingResult, analyze_routing
from .simulate import Schedule, _lower_demand_rounds, _unpack_topo, run_schedule

Device = Union[str, torch.device, None]

__all__ = [
    "WorkloadSpec", "WorkloadSpecError", "CommPhase", "CommPlan",
    "WorkloadResult", "parse_workload", "plan_workload", "simulate_workload",
    "hlo_crosscheck", "spectral_rank_correlation", "BUCKET_BYTES",
    "DP_OVERLAP_FRACTION",
]

#: DP gradient all-reduce bucket size (bytes) — the plan splits the gradient
#: into ceil(total/BUCKET_BYTES) equal all-reduces, the standard overlap
#: granularity of data-parallel trainers.
BUCKET_BYTES = float(1 << 27)

#: fraction of the compute step the DP gradient all-reduce can hide behind
#: (the backward pass is ~2/3 of a fwd+bwd step at the 6*N*T FLOP convention,
#: and gradient buckets stream out as backward produces them).
DP_OVERLAP_FRACTION = 2.0 / 3.0

_DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "float16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}

#: config dtype name -> HLO shape element type (hlo_analysis keys)
_HLO_DTYPE = {
    "float32": "f32", "bfloat16": "bf16", "float16": "f16",
    "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2",
}

#: phase collective -> HLO instruction mnemonic (analyze_hlo's accounting
#: keys: all-gather counts the gathered OUTPUT bytes, the rest sum operands)
_HLO_OP = {
    "all_reduce": "all-reduce", "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
}

_DEFAULT_SHAPE = "train_4k"


class WorkloadSpecError(ValueError):
    """Malformed or inconsistent workload spec string."""


# --------------------------------------------------------------------------
# spec parsing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One parsed training-job layout: architecture + parallelism degrees.

    ``arch`` is the canonical :mod:`repro_torch.configs` registry name;
    ``dp``/``tp``/``ep`` are the data-, tensor- and expert-parallel degrees
    (``world = dp * tp``; EP groups are size-``ep`` slices of the data axis);
    ``shape`` names the :data:`repro_torch.configs.base.SHAPES` training shape.
    """
    arch: str
    dp: int = 1
    tp: int = 1
    ep: int = 1
    shape: str = _DEFAULT_SHAPE

    @property
    def world(self) -> int:
        """Total rank count dp * tp (EP reuses data-axis ranks)."""
        return self.dp * self.tp

    @property
    def spec(self) -> str:
        """Canonical round-trippable spec string."""
        s = f"{self.arch}@dp={self.dp},tp={self.tp},ep={self.ep}"
        if self.shape != _DEFAULT_SHAPE:
            s += f",shape={self.shape}"
        return s


def _norm(name: str) -> str:
    return name.strip().lower().replace("-", "_").replace(".", "_")


def _resolve_arch(name: str) -> str:
    """Registry name from a normalized exact or unique-prefix match."""
    want = _norm(name)
    if not want:
        raise WorkloadSpecError("workload spec needs a model name before '@'")
    names = list_configs()
    exact = [c for c in names if _norm(c) == want]
    if exact:
        return exact[0]
    prefixed = [c for c in names if _norm(c).startswith(want)]
    if len(prefixed) == 1:
        return prefixed[0]
    if prefixed:
        raise WorkloadSpecError(
            f"ambiguous model name {name!r}: matches {prefixed}")
    raise WorkloadSpecError(
        f"unknown model {name!r}; registered configs: {names}")


def _positive_int(key: str, value: str) -> int:
    try:
        v = int(value)
    except ValueError:
        raise WorkloadSpecError(f"{key}= must be an integer, got {value!r}") \
            from None
    if v < 1:
        raise WorkloadSpecError(f"{key}= must be >= 1, got {v}")
    return v


def parse_workload(spec: Union[str, "WorkloadSpec"]) -> "WorkloadSpec":
    """Parse ``"kimi_k2_1t@dp=64,tp=8,ep=16"`` into a :class:`WorkloadSpec`.

    Grammar: ``<model>[@<key>=<value>,...]`` with keys ``dp``/``tp``/``ep``
    (positive ints, default 1) and ``shape`` (a ``kind="train"`` entry of
    :data:`repro_torch.configs.base.SHAPES`, default ``train_4k``).
    ``<model>`` is a registry name, matched case-insensitively with
    ``-``/``.``/``_`` interchangeable; a unique prefix (``kimi_k2_1t`` for
    ``kimi-k2-1t-a32b``) resolves too.

    Validated invariants (raising :class:`WorkloadSpecError`):
    ``global_batch % dp == 0``; ``ep > 1`` needs an MoE arch with
    ``dp % ep == 0`` and ``n_experts % ep == 0``.
    """
    if isinstance(spec, WorkloadSpec):
        return spec
    name, _, params = str(spec).partition("@")
    kv: Dict[str, Any] = dict(dp=1, tp=1, ep=1, shape=_DEFAULT_SHAPE)
    if params.strip():
        for part in params.split(","):
            key, sep, value = part.partition("=")
            key = key.strip().lower()
            if not sep or not value.strip():
                raise WorkloadSpecError(
                    f"bad workload parameter {part!r} (expect key=value)")
            if key in ("dp", "tp", "ep"):
                kv[key] = _positive_int(key, value.strip())
            elif key == "shape":
                kv["shape"] = value.strip()
            else:
                raise WorkloadSpecError(
                    f"unknown workload key {key!r} (known: dp, tp, ep, shape)")
    arch = _resolve_arch(name)
    cfg = get_config(arch)
    if kv["shape"] not in SHAPES:
        raise WorkloadSpecError(
            f"unknown shape {kv['shape']!r} (known: {sorted(SHAPES)})")
    shape = SHAPES[kv["shape"]]
    if shape.kind != "train":
        raise WorkloadSpecError(
            f"workload shapes must be training shapes, {shape.name!r} is "
            f"kind={shape.kind!r}")
    if shape.global_batch % kv["dp"]:
        raise WorkloadSpecError(
            f"dp={kv['dp']} must divide global_batch={shape.global_batch} "
            f"of shape {shape.name!r}")
    if kv["ep"] > 1:
        if cfg.n_experts == 0:
            raise WorkloadSpecError(
                f"{arch} has no experts; ep={kv['ep']} needs an MoE arch")
        if kv["dp"] % kv["ep"]:
            raise WorkloadSpecError(
                f"ep={kv['ep']} must divide dp={kv['dp']} (EP groups are "
                "slices of the data axis)")
        if cfg.n_experts % kv["ep"]:
            raise WorkloadSpecError(
                f"ep={kv['ep']} must divide n_experts={cfg.n_experts}")
    return WorkloadSpec(arch=arch, dp=kv["dp"], tp=kv["tp"], ep=kv["ep"],
                        shape=kv["shape"])


# --------------------------------------------------------------------------
# sharding-rule consultation
# --------------------------------------------------------------------------

class _LogicalMesh:
    """Duck-typed device mesh carrying only the two attributes
    :mod:`repro_torch.parallel.sharding` reads (``shape``, ``axis_names``)
    — so the workload planner consults the sharding rules without
    materializing dp*tp devices."""

    def __init__(self, dp: int, tp: int) -> None:
        self.axis_names = ("data", "model")
        self.shape = {"data": dp, "model": tp}


def _iter_param_specs(spec: WorkloadSpec) -> Iterator[Tuple[str, Tuple[int, ...], Any]]:
    """Yield (name, shape, partition spec) for every parameter leaf, pairing
    :func:`repro_torch.models.model.param_shapes` with the specs that
    :func:`repro_torch.parallel.sharding.param_pspecs` assigns on the logical
    (data=dp, model=tp) mesh.  Shape leaves are plain tuples of ints, so the
    walk descends dicts and lists only."""
    cfg = get_config(spec.arch)
    mesh = _LogicalMesh(spec.dp, spec.tp)
    shapes = M.param_shapes(cfg)
    pspecs = sharding.param_pspecs(cfg, mesh)

    def walk(sh, ps, name=""):
        if isinstance(sh, dict):
            for key in sh:
                yield from walk(sh[key], ps[key], key)
        elif isinstance(sh, list):  # pattern-position blocks
            for s, p in zip(sh, ps):
                yield from walk(s, p, name)
        else:
            yield name, tuple(sh), ps

    yield from walk(shapes, pspecs)


def _model_shard_factor(pspec: Any, tp: int) -> int:
    """Product of 'model' mesh-axis sizes a partition spec consumes (the
    tensor-parallel shard factor of that parameter)."""
    factor = 1
    for entry in tuple(pspec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in axes:
            if ax == "model":
                factor *= tp
    return factor


def _has_model_axis(pspec: Any) -> bool:
    return _model_shard_factor(pspec, 2) > 1


# --------------------------------------------------------------------------
# the communication plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommPhase:
    """One collective stream of a training step.

    ``bytes_per_rank`` is the logical payload per op in the HLO accounting
    convention (all-reduce / reduce-scatter / all-to-all: operand bytes;
    all-gather: gathered output bytes); ``ops_per_step`` repeats it;
    ``group_axis`` in {"dp", "tp", "ep"} picks the rank grouping (group size
    ``group_size``, ``n_groups`` concurrent groups).
    """
    name: str
    collective: str          # all_reduce | all_gather | reduce_scatter | all_to_all
    group_axis: str          # dp | tp | ep
    group_size: int
    n_groups: int
    bytes_per_rank: float
    ops_per_step: int
    dtype: str
    note: str = ""

    @property
    def total_bytes(self) -> float:
        """Logical payload bytes per rank over the whole step."""
        return self.bytes_per_rank * self.ops_per_step


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """The per-training-step communication plan of one workload.

    ``phases`` hold the closed-form byte counts; ``compute_seconds`` is the
    topology-independent FLOP term (6 * active params * tokens per rank at
    :data:`repro_torch.launch.hlo_analysis.HW` peak, the modeled
    cluster's).  Compile onto a topology with
    :func:`simulate_workload`; audit the byte accounting with
    :func:`hlo_crosscheck`.
    """
    spec: WorkloadSpec
    world: int
    tokens_per_step: int          # global tokens (batch * seq)
    tokens_per_rank: int          # per data shard
    param_bytes: float            # total parameter bytes (param_dtype)
    grad_bytes_per_rank: float    # DP all-reduce operand bytes per rank
    phases: Tuple[CommPhase, ...]
    flops_per_rank: float
    compute_seconds: float

    def phase(self, name: str) -> CommPhase:
        for p in self.phases:
            if p.name == name:
                return p
        raise KeyError(f"no phase {name!r} in plan (have: "
                       f"{[p.name for p in self.phases]})")

    def collective_byte_totals(self) -> Dict[str, float]:
        """Per-HLO-kind logical byte totals (the figures
        :func:`repro_torch.launch.hlo_analysis.analyze_hlo` recovers from
        :meth:`to_hlo`)."""
        out: Dict[str, float] = {}
        for p in self.phases:
            kind = _HLO_OP[p.collective]
            out[kind] = out.get(kind, 0.0) + p.total_bytes
        return out

    def to_hlo(self) -> str:
        """Synthetic post-partitioning HLO text with one collective per phase
        (repeated ops as a while loop with ``known_trip_count``), shaped so
        the independent parser of :mod:`repro_torch.launch.hlo_analysis`
        recovers
        exactly :meth:`collective_byte_totals`."""
        lines = [f"HloModule workload_{_norm(self.spec.arch)}", ""]
        entry: List[str] = []
        for i, p in enumerate(self.phases):
            dt = _HLO_DTYPE[p.dtype]
            numel = p.bytes_per_rank / _DTYPE_BYTES[p.dtype]
            trips = p.ops_per_step
            if abs(numel - round(numel)) > 1e-6:
                # bucketized phases can have fractional per-op element
                # counts; collapse to one instruction carrying the exact
                # phase total so the parsed bytes still match
                numel *= trips
                trips = 1
            numel = int(round(numel))
            shape = f"{dt}[{numel}]"
            op = _HLO_OP[p.collective]
            body = f"wl_body.{i}"
            cond = f"wl_cond.{i}"
            lines += [
                f"%{cond} (carg.{i}: {shape}) -> pred[] {{",
                f"  %clt.{i} = pred[] constant(false)",
                "}", "",
                f"%{body} (barg.{i}: {shape}) -> {shape} {{",
                f"  %arg.{i} = {shape} parameter(0)",
                f"  ROOT %coll.{i} = {shape} {op}(%arg.{i})",
                "}", "",
            ]
            entry.append(
                f"  %init.{i} = {shape} constant(0)")
            entry.append(
                f"  %while.{i} = {shape} while(%init.{i}), "
                f"condition=%{cond}, body=%{body}, backend_config="
                f'{{"known_trip_count":{{"n":"{trips}"}}}}')
        lines += ["ENTRY %main () -> f32[] {"] + entry + [
            "  ROOT %done = f32[] constant(0)", "}"]
        return "\n".join(lines)

    def report(self) -> str:
        """Compact text block for CLI reports."""
        s = self.spec
        lines = [
            f"workload        : {s.spec}",
            f"ranks           : {self.world} (dp={s.dp} x tp={s.tp}, "
            f"ep={s.ep})",
            f"tokens/step     : {self.tokens_per_step:,} "
            f"({self.tokens_per_rank:,} per data shard)",
            f"compute/rank    : {self.flops_per_rank / 1e12:.1f} TFLOP "
            f"-> {self.compute_seconds * 1e3:.2f} ms at HW peak",
        ]
        for p in self.phases:
            lines.append(
                f"  {p.name:<16}: {p.collective} x{p.ops_per_step} over "
                f"{p.group_axis} groups of {p.group_size}, "
                f"{p.bytes_per_rank / 1e6:.2f} MB/op ({p.dtype})")
        return "\n".join(lines)


@obs.traced("workloads/plan", phase="compile")
def plan_workload(spec: Union[str, WorkloadSpec]) -> CommPlan:
    """Lower one workload spec into its per-step :class:`CommPlan`.

    Byte counts come from the model configs (see the module docstring);
    every count is closed-form, so tests can pin them exactly:

    * DP all-reduce total == parameter bytes / TP shard factor (== parameter
      bytes when ``tp == 1``);
    * each TP all-gather/reduce-scatter op moves ``tokens_per_rank * d_model``
      activation elements;
    * each MoE all-to-all op moves the padded slot tensor
      ``groups_per_rank * E * capacity * d_model/tp`` elements.
    """
    ws = parse_workload(spec)
    cfg = get_config(ws.arch)
    shape = SHAPES[ws.shape]
    dp, tp, ep = ws.dp, ws.tp, ws.ep
    world = ws.world
    tokens = shape.global_batch * shape.seq_len
    tokens_rank = tokens // dp
    grad_bytes = _DTYPE_BYTES[cfg.param_dtype]
    comp_bytes = _DTYPE_BYTES[cfg.compute_dtype]

    # -- DP gradient all-reduce, sized through the live sharding rules ------
    param_elems = 0
    grad_elems_per_rank = 0.0
    tp_pairs_per_block: Dict[int, int] = {}
    for name, sh, ps in _iter_param_specs(ws):
        numel = int(np.prod(sh))
        param_elems += numel
        grad_elems_per_rank += numel / _model_shard_factor(ps, tp)
    # TP matmul pairs per pattern position: re-walk block-structured pspecs
    pspecs = sharding.param_pspecs(cfg, _LogicalMesh(dp, tp))
    for i, blk in enumerate(pspecs["blocks"]):
        pairs = 0
        if "attn" in blk and _has_model_axis(blk["attn"]["wq"]):
            pairs += 1
        if "mamba" in blk and _has_model_axis(blk["mamba"]["in_proj"]):
            pairs += 1
        if "mlp" in blk and _has_model_axis(blk["mlp"]["wg"]):
            pairs += 1
        tp_pairs_per_block[i] = pairs
    blocks_seen = len(pspecs["blocks"])
    assert blocks_seen == len(cfg.pattern)

    total_grad_bytes = grad_elems_per_rank * grad_bytes
    n_buckets = max(1, int(math.ceil(total_grad_bytes / BUCKET_BYTES)))
    phases: List[CommPhase] = []
    if dp > 1:
        phases.append(CommPhase(
            name="dp_allreduce", collective="all_reduce", group_axis="dp",
            group_size=dp, n_groups=tp,
            bytes_per_rank=total_grad_bytes / n_buckets,
            ops_per_step=n_buckets, dtype=cfg.param_dtype,
            note=f"gradient bucketized x{n_buckets} "
                 f"({BUCKET_BYTES / 1e6:.0f} MB buckets)"))

    # -- TP per-layer all-gather + reduce-scatter ---------------------------
    if tp > 1:
        n_pairs = sum(tp_pairs_per_block[i] * cfg.n_repeats
                      for i in range(len(cfg.pattern)))
        if n_pairs:
            act_bytes = float(tokens_rank) * cfg.d_model * comp_bytes
            # fwd + bwd: 2 sequence-parallel all-reduces per pair, each
            # lowered as one all-gather + one reduce-scatter of the full
            # activation
            ops = 2 * n_pairs
            phases.append(CommPhase(
                name="tp_allgather", collective="all_gather", group_axis="tp",
                group_size=tp, n_groups=dp, bytes_per_rank=act_bytes,
                ops_per_step=ops, dtype=cfg.compute_dtype,
                note=f"{n_pairs} model-sharded matmul pairs"))
            phases.append(CommPhase(
                name="tp_reducescatter", collective="reduce_scatter",
                group_axis="tp", group_size=tp, n_groups=dp,
                bytes_per_rank=act_bytes, ops_per_step=ops,
                dtype=cfg.compute_dtype,
                note=f"{n_pairs} model-sharded matmul pairs"))

    # -- MoE all-to-all over EP groups --------------------------------------
    moe_layers = sum(1 for s in cfg.pattern if s.moe) * cfg.n_repeats
    if ep > 1 and moe_layers:
        E, k = cfg.n_experts, cfg.experts_per_token
        C = capacity(shape.seq_len, E, k, cfg.capacity_factor)
        groups_per_rank = shape.global_batch // dp
        d_share = cfg.d_model // tp if cfg.d_model % tp == 0 else cfg.d_model
        slots = groups_per_rank * E * C
        phases.append(CommPhase(
            name="moe_dispatch", collective="all_to_all", group_axis="ep",
            group_size=ep, n_groups=(dp // ep) * tp,
            bytes_per_rank=float(slots) * d_share
                * _DTYPE_BYTES[cfg.moe_dispatch_dtype],
            ops_per_step=moe_layers, dtype=cfg.moe_dispatch_dtype,
            note=f"E={E} C={C} padded slots, fwd dispatch"))
        phases.append(CommPhase(
            name="moe_combine", collective="all_to_all", group_axis="ep",
            group_size=ep, n_groups=(dp // ep) * tp,
            bytes_per_rank=float(slots) * d_share * comp_bytes,
            ops_per_step=3 * moe_layers, dtype=cfg.compute_dtype,
            note="fwd return + bwd dispatch/return"))

    flops = 6.0 * cfg.active_param_count() * tokens / world
    return CommPlan(
        spec=ws, world=world, tokens_per_step=tokens,
        tokens_per_rank=tokens_rank,
        param_bytes=float(param_elems) * grad_bytes,
        grad_bytes_per_rank=total_grad_bytes,
        phases=tuple(phases), flops_per_rank=flops,
        compute_seconds=flops / HW["peak_flops"])


# --------------------------------------------------------------------------
# rank groups and logical demand
# --------------------------------------------------------------------------

def _phase_groups(plan: CommPlan, axis: str) -> List[np.ndarray]:
    """Rank-id groups for one group axis.  Rank layout: ``r = d * tp + t``
    (TP fastest-varying, so TP groups are contiguous rank blocks)."""
    dp, tp, ep = plan.spec.dp, plan.spec.tp, plan.spec.ep
    if axis == "tp":
        return [np.arange(d * tp, (d + 1) * tp) for d in range(dp)]
    if axis == "dp":
        return [np.arange(dp) * tp + t for t in range(tp)]
    if axis == "ep":
        return [(b * ep + np.arange(ep)) * tp + t
                for b in range(dp // ep) for t in range(tp)]
    raise ValueError(f"unknown group axis {axis!r}")


def _phase_demand(phase: CommPhase, groups: List[np.ndarray],
                  node_of: np.ndarray, n: int) -> Tuple[np.ndarray, int]:
    """(node-level logical demand matrix, round count) for one phase.

    Ring lowering for all-reduce (2(g-1) rounds of 1/g payload per edge),
    all-gather / reduce-scatter (g-1 rounds); full pair demand in a single
    round for all-to-all.  Demand between ranks co-located on one node is
    free (diagonal, dropped by the ECMP lowering).
    """
    D = np.zeros((n, n), dtype=np.float64)
    g = phase.group_size
    if phase.collective == "all_to_all":
        per_pair = phase.bytes_per_rank / g
        for grp in groups:
            nodes = node_of[grp]
            for a in nodes:
                D[a, nodes] += per_pair
        rounds = phase.ops_per_step
    else:
        per_edge = phase.bytes_per_rank / g
        for grp in groups:
            nodes = node_of[grp]
            D[nodes, np.roll(nodes, -1)] += per_edge
        per_op = 2 * (g - 1) if phase.collective == "all_reduce" else g - 1
        rounds = per_op * phase.ops_per_step
    np.fill_diagonal(D, 0.0)
    return D, rounds


# --------------------------------------------------------------------------
# executing a plan on a topology
# --------------------------------------------------------------------------

@dataclasses.dataclass
class WorkloadResult:
    """Executed step-time breakdown of one plan on one topology.

    ``phase_rows`` carry the measured per-phase link time (seconds);
    ``step_seconds`` composes them with the compute term: TP and MoE
    collectives sit on the critical path, the DP all-reduce overlaps with
    :data:`DP_OVERLAP_FRACTION` of compute and only its exposed remainder
    counts.  ``exposed_comm_fraction = (step - compute) / step``.
    """
    plan: CommPlan
    name: str                       # topology name
    n: int
    placement: str
    phase_rows: List[Dict[str, Any]]
    compute_seconds: float
    comm_seconds: float             # sum of all phase link times
    dp_seconds: float
    tp_seconds: float
    moe_seconds: float
    exposed_dp_seconds: float
    step_seconds: float
    exposed_comm_fraction: float
    dropped_frac: float             # demand to unreachable node pairs
    seconds: float                  # wall time (lowering + engine)

    def phase_seconds(self) -> Dict[str, float]:
        """phase name -> measured link seconds."""
        return {r["name"]: r["seconds"] for r in self.phase_rows}

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready summary."""
        return dict(
            workload=self.plan.spec.spec, topology=self.name, n=self.n,
            placement=self.placement, world=self.plan.world,
            compute_ms=round(self.compute_seconds * 1e3, 6),
            comm_ms=round(self.comm_seconds * 1e3, 6),
            dp_ms=round(self.dp_seconds * 1e3, 6),
            tp_ms=round(self.tp_seconds * 1e3, 6),
            moe_ms=round(self.moe_seconds * 1e3, 6),
            exposed_dp_ms=round(self.exposed_dp_seconds * 1e3, 6),
            step_ms=round(self.step_seconds * 1e3, 6),
            exposed_comm_fraction=round(self.exposed_comm_fraction, 6),
            dropped_frac=round(self.dropped_frac, 6),
            phases=[dict(r, seconds=round(r["seconds"], 9))
                    for r in self.phase_rows],
            seconds=round(self.seconds, 3))

    def report(self) -> str:
        """Compact text block for CLI reports."""
        lines = [
            f"workload        : {self.plan.spec.spec} on {self.name} "
            f"(n={self.n}, {self.plan.world} ranks, "
            f"placement={self.placement})",
            f"step time       : {self.step_seconds * 1e3:.3f} ms "
            f"(compute {self.compute_seconds * 1e3:.3f} + comm exposed "
            f"{(self.step_seconds - self.compute_seconds) * 1e3:.3f})",
            f"exposed comm    : {self.exposed_comm_fraction:.1%} of the step",
        ]
        for r in self.phase_rows:
            lines.append(
                f"  {r['name']:<16}: {r['seconds'] * 1e3:8.3f} ms "
                f"({r['collective']}, {r['rounds']} rounds)")
        if self.dropped_frac > 0:
            lines.append(f"dropped demand  : {self.dropped_frac:.2%} "
                         "(unreachable pairs)")
        return "\n".join(lines)


@obs.traced("workloads/simulate", phase="execute")
def simulate_workload(topo: Union[Topology, Tuple[np.ndarray, int]],
                      workload: Union[str, WorkloadSpec, CommPlan], *,
                      placement: str = "linear", seed: int = 0,
                      routing: Optional[RoutingResult] = None,
                      link_bw: float = LINK_BW,
                      hop_latency: float = PER_HOP_LATENCY,
                      overlap_fraction: float = DP_OVERLAP_FRACTION,
                      chunk: int = DEFAULT_SOURCE_CHUNK,
                      device: Device = DEFAULT_DEVICE) -> WorkloadResult:
    """Compile a communication plan onto a topology and execute it.

    Ranks map to nodes via :func:`repro_torch.core.placement.place_ranks`
    (``placement`` strategy, co-located traffic free); each phase's logical
    demand is built on the host, ECMP-lowered onto the padded gather-table
    slots on ``device`` and run through the round engine of
    :mod:`repro_torch.core.simulate` at the plan's real byte counts.

    Args:
        topo: a :class:`Topology` or ``(table, n)`` padded pair (the degraded
            entry point used by :func:`repro_torch.core.faults.fault_sweep`).
        workload: spec string, :class:`WorkloadSpec`, or prebuilt
            :class:`CommPlan`.
        placement: rank->node strategy (``linear`` / ``round_robin`` /
            ``random``; see :func:`repro_torch.core.placement.place_ranks`).
        seed: placement RNG seed (``random`` strategy only).
        routing: reuse an all-sources :class:`RoutingResult`.
        link_bw / hop_latency: engine constants (bytes/s, s/hop).
        overlap_fraction: fraction of compute the DP all-reduce hides behind.
        chunk: ECMP sources per batched call (memory knob).
        device: where routing, lowering and the engine run (default the
            card).

    Returns:
        :class:`WorkloadResult` with the per-phase and composed step times
        (seconds of the modeled cluster).
    """
    dev = resolve_device(device)
    t0 = time.time()
    plan = workload if isinstance(workload, CommPlan) else \
        plan_workload(workload)
    name, n, table = _unpack_topo(topo)
    if routing is None:
        routing = analyze_routing((table, n), chunk=chunk, device=dev)
    node_of = place_ranks(n, plan.world, strategy=placement, seed=seed)
    phase_rows: List[Dict[str, Any]] = []
    axis_seconds = {"dp": 0.0, "tp": 0.0, "ep": 0.0}
    dropped_total = 0.0
    demand_total = 0.0
    for phase in plan.phases:
        groups = _phase_groups(plan, phase.group_axis)
        D, rounds = _phase_demand(phase, groups, node_of, n)
        lowered, counts, hops, dropped = _lower_demand_rounds(
            table, routing, [(D, rounds, 1.0)], chunk, device=dev)
        sched = Schedule(
            name=name, collective=f"workload:{phase.name}", algorithm="ecmp",
            n=n, k=int(table.shape[1]), round_bytes=lowered, counts=counts,
            hops=hops, dropped_demand=dropped)
        res = run_schedule(sched, payloads=1.0, link_bw=link_bw,
                           hop_latency=hop_latency, device=dev)
        secs = float(res.time_seconds[0])
        axis_seconds[phase.group_axis] += secs
        dropped_total += dropped
        demand_total += rounds * float(D.sum())
        phase_rows.append(dict(
            name=phase.name, collective=phase.collective,
            group_axis=phase.group_axis, group_size=phase.group_size,
            ops=phase.ops_per_step, rounds=int(rounds),
            bytes_per_rank=phase.bytes_per_rank, dtype=phase.dtype,
            seconds=secs,
            max_link_bytes=float(lowered.max())))
    dp_s, tp_s, moe_s = (axis_seconds["dp"], axis_seconds["tp"],
                         axis_seconds["ep"])
    exposed_dp = max(0.0, dp_s - overlap_fraction * plan.compute_seconds)
    step = plan.compute_seconds + tp_s + moe_s + exposed_dp
    return WorkloadResult(
        plan=plan, name=name, n=n, placement=placement,
        phase_rows=phase_rows, compute_seconds=plan.compute_seconds,
        comm_seconds=dp_s + tp_s + moe_s, dp_seconds=dp_s, tp_seconds=tp_s,
        moe_seconds=moe_s, exposed_dp_seconds=exposed_dp, step_seconds=step,
        exposed_comm_fraction=(step - plan.compute_seconds) / step
            if step > 0 else 0.0,
        dropped_frac=dropped_total / demand_total if demand_total > 0 else 0.0,
        seconds=time.time() - t0)


# --------------------------------------------------------------------------
# byte-accounting cross-check against launch/hlo_analysis
# --------------------------------------------------------------------------

def hlo_crosscheck(plan: Union[str, WorkloadSpec, CommPlan],
                   rel_tol: float = 1e-9) -> Dict[str, Any]:
    """Audit the plan's byte accounting against the independent HLO parser.

    Emits the plan as synthetic HLO (:meth:`CommPlan.to_hlo`), runs
    :func:`repro_torch.launch.hlo_analysis.analyze_hlo` over the text, and compares
    the recovered per-kind collective bytes against
    :meth:`CommPlan.collective_byte_totals`.

    Returns a dict with ``ok`` plus per-kind
    ``{plan_bytes, hlo_bytes, ok}`` rows.
    """
    if not isinstance(plan, CommPlan):
        plan = plan_workload(plan)
    stats = analyze_hlo(plan.to_hlo())
    want = plan.collective_byte_totals()
    rows: Dict[str, Dict[str, Any]] = {}
    ok = True
    for kind in sorted(set(want) | {k for k, v in
                                    stats.collective_bytes.items() if v}):
        p = want.get(kind, 0.0)
        h = stats.collective_bytes.get(kind, 0.0)
        good = abs(p - h) <= rel_tol * max(1.0, abs(p))
        ok &= good
        rows[kind] = dict(plan_bytes=p, hlo_bytes=h, ok=good)
    return dict(ok=ok, kinds=rows)


# --------------------------------------------------------------------------
# spectral-prediction agreement
# --------------------------------------------------------------------------

def spectral_rank_correlation(rows: Sequence[Dict[str, Any]],
                              rho2_key: str = "rho2",
                              step_key: str = "step_ms") -> Optional[float]:
    """Spearman rank correlation between the spectral gap and SLOWNESS.

    Larger rho2 should mean a *smaller* step time, so the correlation between
    the rho2 ranking (descending) and the step-time ranking (ascending) is
    +1 when the spectral prediction orders the executed workload perfectly.
    Returns None with fewer than 2 rows.
    """
    pairs = [(float(r[rho2_key]), float(r[step_key])) for r in rows
             if r.get(rho2_key) is not None and r.get(step_key) is not None]
    if len(pairs) < 2:
        return None
    rho2 = np.array([p[0] for p in pairs])
    step = np.array([p[1] for p in pairs])

    def ranks(x: np.ndarray) -> np.ndarray:
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x))
        r[order] = np.arange(len(x), dtype=np.float64)
        # average ties so the statistic is exact for tied values
        for v in np.unique(x):
            m = x == v
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r

    a = ranks(-rho2)      # best gap first
    b = ranks(step)       # fastest step first
    a = a - a.mean()
    b = b - b.mean()
    denom = float(np.sqrt((a * a).sum() * (b * b).sum()))
    if denom == 0.0:
        return None
    return float((a * b).sum() / denom)
