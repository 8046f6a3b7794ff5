"""Roofline analysis of post-partitioning HLO text (the port's copy of the
reference's ``launch/hlo_analysis.py``; standard library only).

The terms are re-derived from the HLO text directly:

  * builds the computation call graph (while bodies x known_trip_count,
    conditionals, fusions) and propagates execution multipliers from ENTRY;
  * FLOPs: every ``dot`` op contributes 2 * prod(output) * prod(contracting)
    (contracting dims parsed from the op attributes) x its multiplier;
  * collective bytes: per-device payload of all-gather / all-reduce /
    reduce-scatter / all-to-all / collective-permute x multiplier;
  * HBM bytes: per-instruction operand+output accounting at fusion
    granularity (fusion internals excluded) — an upper bound that ignores
    on-chip reuse.

In the port, ``analyze_hlo`` is the independent auditor of the workload
lowering: :mod:`repro_torch.core.workloads` re-emits its closed-form
communication plan as a synthetic HLO module and requires this parser's
per-kind collective byte totals to match (``hlo_crosscheck``).

``HW`` holds the reference's constants of the *modeled* cluster's
accelerator — inputs of the simulation, like ``collectives.LINK_BW`` —
copied unchanged so the simulated step times match the reference's:
``HW["peak_flops"]`` is the workload plan's compute-time denominator.  They
describe no real device the port runs on, and no time computed from them is
a measurement.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["HW", "analyze_hlo", "roofline_terms", "HloStats"]

HW = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9, n_links=4,
          hbm_bytes=16e9)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
    "s2": 1, "u2": 1,
}

_ARRAY_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_SKIP_MEM_OPS = {"tuple", "get-tuple-element", "parameter", "constant",
                 "bitcast", "after-all", "partition-id", "replica-id"}


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _ARRAY_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(shape_str: str) -> List[int]:
    m = _ARRAY_RE.search(shape_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


@dataclasses.dataclass
class Instr:
    name: str
    shape: str
    op: str
    operands: List[str]
    line: str


# result type is either a tuple shape "(s32[], f32[...]{...}, ...)" (no nested
# parens, but may contain /*index=N*/ comments) or a plain array shape.
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\([^)]*\)|[\w\[\],\{\}]+)\s+"
    r"([\w\-]+)\(")
_HDR_RE = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*(?:\.v\d+)?\s*\(")


@dataclasses.dataclass
class HloStats:
    flops: float
    hbm_bytes: float          # fusion-aware estimate (roofline memory term)
    hbm_bytes_unfused: float  # every op's operands+outputs (upper bound)
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]
    dot_count: float

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


# ops whose outputs are materialized to HBM on a TPU-style fused compile;
# bare elementwise/broadcast/reduce/convert ops are assumed fused into their
# producers/consumers (the CPU backend fuses far less than TPU would, so
# counting them would overstate HBM traffic ~20x).
_MATERIALIZE_OPS = {
    "dot", "convolution", "fusion", "copy", "dynamic-update-slice",
    "dynamic-slice", "gather", "scatter", "sort", "custom-call", "rng",
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "transpose", "reshape", "concatenate", "pad",
    "slice", "iota",
}


def parse_module(text: str):
    comps: Dict[str, List[Instr]] = {}
    shapes: Dict[str, str] = {}
    entry: Optional[str] = None
    cur: Optional[str] = None
    for line in text.splitlines():
        stripped = line.rstrip()
        if stripped.endswith("{") and "(" in stripped and "=" not in stripped.split("(")[0]:
            m = _HDR_RE.match(stripped)
            if m:
                cur = m.group(2)
                comps[cur] = []
                if m.group(1):
                    entry = cur
                continue
        if cur is None:
            continue
        if stripped == "}":
            cur = None
            continue
        im = _INSTR_RE.match(line)
        if not im:
            continue
        name, shape, op = im.group(1), im.group(2).strip(), im.group(3)
        # operand names: %tokens inside the first (...) group
        paren = line[line.index(op + "(") + len(op) + 1:]
        depth, args = 1, []
        buf = ""
        for ch in paren:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    args.append(buf)
                    break
            if depth >= 1:
                buf += ch
        opnames = re.findall(r"%([\w\.\-]+)", args[0] if args else "")
        inst = Instr(name, shape, op, opnames, line)
        comps[cur].append(inst)
        shapes[name] = shape
    return comps, shapes, entry


def _trip_count(line: str) -> int:
    m = re.search(r'known_trip_count[\\"]*:\s*\{[\\"]*n[\\"]*:[\\"]*(\d+)', line)
    if m:
        return int(m.group(1))
    return 1


def _callees(inst: Instr) -> List[Tuple[str, int, str]]:
    """(callee, multiplier, kind) edges of an instruction."""
    out = []
    if inst.op == "while":
        cm = re.search(r"condition=%?([\w\.\-]+)", inst.line)
        bm = re.search(r"body=%?([\w\.\-]+)", inst.line)
        trips = _trip_count(inst.line)
        if bm:
            out.append((bm.group(1), trips, "body"))
        if cm:
            out.append((cm.group(1), trips + 1, "cond"))
        return out
    if inst.op == "conditional":
        bm = re.search(r"branch_computations=\{([^}]*)\}", inst.line)
        if bm:
            for b in bm.group(1).split(","):
                out.append((b.strip().lstrip("%"), 1, "branch"))
        for k in ("true_computation", "false_computation"):
            m = re.search(rf"{k}=%?([\w\.\-]+)", inst.line)
            if m:
                out.append((m.group(1), 1, "branch"))
        return out
    if inst.op == "fusion":
        m = re.search(r"calls=%?([\w\.\-]+)", inst.line)
        if m:
            out.append((m.group(1), 1, "fusion"))
        return out
    if inst.op in ("call", "async-start", "custom-call"):
        m = re.search(r"(?:to_apply|calls|called_computation)=%?([\w\.\-]+)", inst.line)
        if m:
            out.append((m.group(1), 1, "call"))
    return out


def _dot_flops(inst: Instr, shapes: Dict[str, str]) -> float:
    out_dims = _shape_dims(inst.shape)
    lhs = shapes.get(inst.operands[0]) if inst.operands else None
    if lhs is None:
        return 0.0
    lhs_dims = _shape_dims(lhs)
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", inst.line)
    if m and m.group(1):
        k = 1
        for d in m.group(1).split(","):
            di = int(d)
            if di < len(lhs_dims):
                k *= lhs_dims[di]
    else:
        k = 1
    out_n = 1
    for d in out_dims:
        out_n *= d
    return 2.0 * out_n * k


def analyze_hlo(text: str) -> HloStats:
    """Parse one post-partitioning HLO module and total its roofline terms.

    Args:
      text: HLO text (``module.to_string()`` of a compiled executable, or
        the synthetic module from ``CommPlan.to_hlo()``).

    Returns an ``HloStats`` with trip-count-scaled per-device totals: FLOPs,
    fusion-aware HBM bytes, and per-kind collective payload bytes/counts
    (all-gather counted by gathered OUTPUT bytes, every other collective by
    operand bytes — the convention the workload cross-check matches).
    """
    comps, shapes, entry = parse_module(text)
    if entry is None:
        entry = next(iter(comps), None)
    # propagate multipliers; kind 'fusion' bodies tracked separately for memory
    mult: Dict[str, float] = {}
    fusion_body: Dict[str, bool] = {}

    stack = [(entry, 1.0, False)]
    seen_guard = 0
    while stack:
        seen_guard += 1
        if seen_guard > 200000:
            break
        name, m, in_fusion = stack.pop()
        if name not in comps:
            continue
        mult[name] = mult.get(name, 0.0) + m
        fusion_body[name] = fusion_body.get(name, True) and in_fusion
        for inst in comps[name]:
            for callee, k, kind in _callees(inst):
                stack.append((callee, m * k, in_fusion or kind == "fusion"))

    flops = 0.0
    hbm_fused = 0.0
    hbm_unfused = 0.0
    coll_b = {k: 0.0 for k in _COLLECTIVES}
    coll_c = {k: 0.0 for k in _COLLECTIVES}
    dots = 0.0
    for cname, insts in comps.items():
        m = mult.get(cname, 0.0)
        if m == 0.0:
            continue
        is_fusion = fusion_body.get(cname, False)
        for inst in insts:
            op = inst.op
            if op in ("dot", "convolution"):
                flops += m * _dot_flops(inst, shapes)
                dots += m
            base = op.replace("-start", "")
            if base in _COLLECTIVES:
                if base == "all-gather":
                    payload = _shape_bytes(inst.shape)       # gathered bytes
                else:
                    payload = sum(_shape_bytes(shapes.get(o, ""))
                                  for o in inst.operands)
                coll_b[base] += m * payload
                coll_c[base] += m
            if not is_fusion and op not in _SKIP_MEM_OPS and not op.endswith("-done"):
                out_b = _shape_bytes(inst.shape)
                in_b = sum(_shape_bytes(shapes.get(o, "")) for o in inst.operands)
                hbm_unfused += m * (out_b + in_b)
                if base in _MATERIALIZE_OPS:
                    # in-place loop accumulators (scan stacking): each slice is
                    # written once over the loop, so the buffer counts ONCE,
                    # not once per iteration.
                    in_place = (op == "dynamic-update-slice"
                                or any(shapes.get(o) == inst.shape
                                       for o in inst.operands))
                    hbm_fused += (1.0 if in_place else m) * out_b
                    if op in ("dot", "convolution"):
                        hbm_fused += m * in_b
    return HloStats(flops=flops, hbm_bytes=hbm_fused,
                    hbm_bytes_unfused=hbm_unfused, collective_bytes=coll_b,
                    collective_counts=coll_c, dot_count=dots)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float) -> Dict[str, float]:
    """Per-device roofline times (seconds) and the dominant term.

    Inputs are per-device totals for one step; returns ``compute_s`` /
    ``memory_s`` / ``collective_s`` at the ``HW`` constants plus
    ``dominant``, the largest of the three.
    """
    t_compute = flops_per_device / HW["peak_flops"]
    t_memory = bytes_per_device / HW["hbm_bw"]
    t_coll = collective_bytes_per_device / (HW["n_links"] * HW["link_bw"])
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return dict(compute_s=t_compute, memory_s=t_memory, collective_s=t_coll,
                dominant=dominant)
