"""One dry-run cell's per-device FLOPs by product and collectives by op,
in the port's trace and, with ``--reference``, in the JAX reference's HLO.

    PYTHONPATH=src python tools/dryrun_attribution.py --arch kimi-k2-1t-a32b \
        --shape train_4k [--overrides '{"n_layers": 1}'] [--multi-pod] \
        [--reference] [--functions] [--top 40] [--out FILE]

The port's side is ``repro_torch.launch.dryrun.lower_cell`` on the CPU
(the plain path, a fake world of 256 or 512 ranks), counted once with
every tensor's bytes taken as its element count; its trace rows give each
matrix product's FLOPs by its local operand shapes and each collective's
elements by its op, the mesh axes its group spans (``@pod+data``) and
its operand shapes.  The reference's side runs in a
subprocess (this file imports neither jax nor the reference package): its
own ``lower_cell`` with 512 XLA host devices and Auto mesh axes, as
``tests/test_torch_dryrun.py`` runs it, and its compiled HLO read with its
``hlo_analysis`` conventions (trip-count multipliers; an all-gather counted
by its output, every other collective by its operands), each ``dot`` by
its output and operand shapes, each collective by kind, operand shape and
replica groups.  Elements, not bytes: XLA's CPU backend widens bf16
collectives to f32.  With ``--functions`` each collective's key also
names the functions that issued it: the port's innermost functions on the
Python stack as ``Accounting`` records them (a backward that autograd
runs names only the port's own autograd functions), the reference's from
its HLO's stack frames (``tools/hlo_frames.py``).  Prints
both tables and the totals by kind; ``--out`` writes them as JSON.  CPU
only; the reference side needs jax.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import collections, json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def make_mesh(shape, names, *args, **kwargs):
    kwargs.setdefault("axis_types", (AxisType.Auto,) * len(names))
    return _make_mesh(shape, names, *args, **kwargs)


jax.make_mesh = make_mesh
import repro.launch.dryrun as RD
from hlo_frames import stack_functions
H = RD.H
texts = []
_analyze = H.analyze_hlo


def analyze(hlo):
    texts.append(hlo)
    return _analyze(hlo)


H.analyze_hlo = analyze
arch, shape, overrides = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
result, _ = RD.lower_cell(arch, shape, sys.argv[4] == "1", overrides=overrides)
comps, shapes, entry = H.parse_module(texts[-1])
mult, stack = {}, [(entry, 1.0)]
while stack:
    name, m = stack.pop()
    if name not in comps:
        continue
    mult[name] = mult.get(name, 0.0) + m
    for inst in comps[name]:
        for callee, k, _ in H._callees(inst):
            stack.append((callee, m * k))


def elements(s):
    n_all = 0
    for dt, dims in H._ARRAY_RE.findall(s):
        if H._DTYPE_BYTES.get(dt, 0):
            n = 1
            for d in filter(None, dims.split(",")):
                n *= int(d)
            n_all += n
    return n_all


def bare(s):
    return s.split("{")[0]


functions = stack_functions(texts[-1])


flops = collections.Counter()
coll = collections.Counter()
calls = collections.Counter()
for cname, insts in comps.items():
    m = mult.get(cname, 0.0)
    for inst in insts if m else ():
        if inst.op in ("dot", "convolution"):
            key = "%s = %s" % (bare(inst.shape), " x ".join(
                bare(shapes.get(o, "?")) for o in inst.operands[:2]))
            flops[key] += m * H._dot_flops(inst, shapes)
        kind = inst.op.replace("-start", "")
        if kind in H._COLLECTIVES:
            if kind == "all-gather":
                what, n = bare(inst.shape), elements(inst.shape)
            else:
                what = ",".join(bare(shapes.get(o, "")) for o in inst.operands)
                n = sum(elements(shapes.get(o, "")) for o in inst.operands)
            g = re.search(r"replica_groups=(\[[^ ]*|\{\{[\d,]{0,24})",
                          inst.line)
            key = "%s %s %s" % (kind, what, g.group(1) if g else "")
            if sys.argv[5] == "1":
                key += " [%s]" % " < ".join(functions(inst.line)[:2])
            coll[key] += m * n
            calls[key] += m
print(json.dumps(dict(
    flops_per_device=result["cost"]["flops_per_device"],
    flops_by_product=dict(flops),
    collective_elements=dict(coll), collective_calls=dict(calls))))
"""


def port_side(arch: str, shape: str, overrides: dict, multi_pod: bool,
              by_function: bool = False) -> dict:
    """The port's trace of the cell, counted in elements."""
    import torch

    from repro_torch.launch import dryrun as D

    torch.set_num_threads(4)
    nbytes = D._nbytes
    D._nbytes = lambda t: t.numel()
    try:
        result, rows = D.lower_cell(arch, shape, multi_pod,
                                    overrides=overrides, device="cpu")
    finally:
        D._nbytes = nbytes
    flops, coll, calls = (collections.Counter() for _ in range(3))
    for op, shapes, f, n, fns in rows:
        key = "%s %s" % (op, " x ".join(str(tuple(s)) for s in shapes))
        if f:
            flops[key] += f
        else:
            if by_function:
                key += " [%s]" % " < ".join(fns[:3])
            coll[key] += n
            calls[key] += 1
    return dict(flops_per_device=result["cost"]["flops_per_device"],
                flops_by_product=dict(flops), collective_elements=dict(coll),
                collective_calls=dict(calls),
                elements_by_kind=result["collectives"]["bytes_by_kind"])


def reference_side(arch: str, shape: str, overrides: dict, multi_pod: bool,
                   by_function: bool = False) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        (str(ROOT / "src"), str(ROOT / "tools"))))
    out = subprocess.run([sys.executable, "-c", REFERENCE, arch, shape,
                          json.dumps(overrides), str(int(multi_pod)),
                          str(int(by_function))],
                         env=env, check=True,
                         capture_output=True, text=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    kinds = collections.Counter()
    for key, n in got["collective_elements"].items():
        kinds[key.split(" ", 1)[0]] += n
    got["elements_by_kind"] = dict(kinds)
    return got


def _table(title: str, side: dict, top: int) -> None:
    print(f"== {title}: {side['flops_per_device']:.6e} FLOPs a device")
    for key, f in sorted(side["flops_by_product"].items(),
                         key=lambda kv: -kv[1])[:top]:
        print(f"  {f:.4e}  {key}")
    kinds = side["elements_by_kind"]
    print(f"  collective elements by kind "
          f"{ {k: v for k, v in kinds.items() if v} } total "
          f"{sum(kinds.values()):.6e}")
    for key, n in sorted(side["collective_elements"].items(),
                         key=lambda kv: -kv[1])[:top]:
        print(f"  {n:.4e}  x{side['collective_calls'][key]:g}  {key}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--overrides", default='{"n_layers": 1}')
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh (default 16 x 16)")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--functions", action="store_true",
                    help="name each collective's issuing functions")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides)
    cell = (args.arch, args.shape, overrides, args.multi_pod)
    sides = dict(port=port_side(*cell, args.functions))
    if args.reference:
        sides["reference"] = reference_side(*cell, args.functions)
    for name, side in sides.items():
        _table(f"{name} {args.arch} {args.shape} {overrides}", side, args.top)
    if "reference" in sides:
        mine, ref = (sum(sides[s]["elements_by_kind"].values())
                     for s in ("port", "reference"))
        print(f"port / reference: FLOPs "
              f"{sides['port']['flops_per_device'] / sides['reference']['flops_per_device'] - 1:+.4%}"
              f", collective elements {mine / ref - 1:+.2%}")
    if args.out:
        Path(args.out).write_text(json.dumps(dict(
            arch=args.arch, shape=args.shape, overrides=overrides,
            multi_pod=args.multi_pod, **sides), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
