"""Which layout XLA's SPMD partitioner gives the reference's embedding
lookup: the table's rows moved, the tokens moved, or the table's whole
rows gathered over 'model', at points of (rows V, d_model D, tokens a
rank, mesh); with ``--collectives``, what each point's compiled HLO moves.

    PYTHONPATH=src python tools/embedding_layouts.py \
        [--points '[[65024, 4096, 16, 4096, [16, 16]], ...]'] [--collectives]

A point is [V, D, rows of the batch a rank, S, mesh shape] with the mesh
(data, model) or (pod, data, model).  For each, a subprocess (this file
imports neither jax nor the reference package) lowers the reference's
``models.model._embed_in`` for a (V, D) table placed as its rules place
``embed`` (rows on 'model', D on 'data') and (B, S) tokens on the batch
axes, with the loss ``sum(tanh(x) * c)`` and its gradient, on 512 XLA host
devices with Auto mesh axes (as ``tests/test_torch_dryrun.py`` runs the
reference's dry run), and reads the compiled HLO's collectives: ``tokens``
where the token ids are all-gathered, ``table`` where table blocks are
permuted (the rows moved to D on 'model'), ``rows`` where the table's
whole rows are all-gathered without a permute of table blocks.  Prints one
JSON line a point; ``--collectives`` adds the point's collectives in
program order: kind, dtype, shapes (an all-gather's result, else its
operands), the mesh axes its replica groups span (a permute's pairs), the
group's size and elements a device (the loss's own scalar all-reduce among
them).  With no ``--points``, a grid over vocabularies, tokens and meshes
that straddles every band's edges (~10 minutes).  CPU only; needs jax.
``repro_torch.parallel.act.embed_layout`` is the rule read from it, and
``tests/test_torch_lowering_faults.py`` holds the two to each other.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import json, os, re, sys, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.parallel import sharding as sh
from repro.models import model as RM

KINDS = ("all-gather", "all-reduce", "collective-permute", "all-to-all",
         "reduce-scatter")
ARRAY = re.compile(r"(\w+)\[([\d,]*)\]")


def compiled(V, D, Bl, S, shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = jax.make_mesh(tuple(shape), names,
                         axis_types=(AxisType.Auto,) * len(names),
                         devices=jax.devices()[:int(np.prod(shape))])
    ba = names[:-1]
    B = Bl * int(np.prod([mesh.shape[a] for a in ba]))
    cfg = types.SimpleNamespace(compute_dtype="bfloat16")

    def loss(table, tokens, c):
        with sh.activation_mesh(mesh):
            x = RM._embed_in({"embed": table}, {"tokens": tokens}, cfg)
        return (jnp.tanh(x.astype(jnp.float32)) * c).sum()

    t_sh = NamedSharding(mesh, P("model", "data"))
    f = jax.jit(jax.value_and_grad(loss),
                in_shardings=(t_sh, NamedSharding(mesh, P(ba, None)),
                              NamedSharding(mesh, P(ba, None, None))),
                out_shardings=(NamedSharding(mesh, P()), t_sh))
    with mesh:
        return f.lower(jax.ShapeDtypeStruct((V, D), jnp.float32),
                       jax.ShapeDtypeStruct((B, S), jnp.int32),
                       jax.ShapeDtypeStruct((B, S, D), jnp.float32)
                       ).compile().as_text()


def instructions(hlo):
    # (kind, result, attributes) of each collective (the compiled HLO
    # prints no operand's shape)
    out = []
    for line in hlo.splitlines():
        m = re.search(r"= (\(.*?\)|\S+?)(?:\{[^}]*\})? (%s)(?:-start)?\("
                      r"[^)]*\)(, .*)?$" % "|".join(KINDS), line)
        if m:
            out.append((m.group(2), m.group(1), m.group(3) or ""))
    return out


def layout_of(colls, V):
    if any(k == "all-gather" and r.startswith("s32") for k, r, _ in colls):
        return "tokens"
    if any(k == "collective-permute" and r.startswith("f32")
           for k, r, _ in colls):
        return "table"
    if any(k == "all-gather" and r.startswith("f32[%d," % V)
           for k, r, _ in colls):
        return "rows"
    return "unknown"


def groups(attrs, n):
    # the replica groups (lists of partition ids) of an instruction's
    # attributes; a permute's (source, target) pairs
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", attrs)
    if m:
        ids = np.arange(n).reshape([int(d) for d in m.group(3).split(",")])
        if m.group(4):
            ids = ids.transpose([int(d) for d in m.group(4).split(",")])
        return ids.reshape(int(m.group(1)), int(m.group(2))).tolist()
    m = re.search(r"(?:replica_groups|source_target_pairs)=\{(\{.*?\})\}",
                  attrs)
    if not m:
        return [list(range(n))]
    return [[int(i) for i in g.split(",") if i]
            for g in re.findall(r"\{([\d,]*)\}", m.group(1))]


def axes_of(gs, shape, names):
    # the mesh axes along which the devices of one group (or of one
    # permute's pairs) differ
    spans = set()
    for g in gs:
        at = np.array([np.unravel_index(i, shape) for i in g])
        spans |= {names[j] for j in range(len(shape))
                  if len(set(at[:, j].tolist())) > 1}
    return [a for a in names if a in spans]


def collectives_of(colls, shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = int(np.prod(shape))
    rows = []
    for kind, result, attrs in colls:
        arrays = ARRAY.findall(result)
        dims = [[int(d) for d in ds.split(",") if d] for _, ds in arrays]
        gs = groups(attrs, n)
        size = len(gs[0]) if kind != "collective-permute" else 2
        # a reduce-scatter's operand is its group's results
        scale = size if kind == "reduce-scatter" else 1
        rows.append(dict(
            kind=kind, dtype=arrays[0][0], shapes=dims,
            axes=axes_of(gs if kind == "collective-permute" else gs[:1],
                         shape, names),
            group=size,
            elements=scale * int(sum(np.prod(d) for d in dims))))
    return rows


want_collectives = sys.argv[2] == "1"
for V, D, Bl, S, shape in json.loads(sys.argv[1]):
    colls = instructions(compiled(V, D, Bl, S, shape))
    row = dict(V=V, D=D, tokens_rank=Bl * S,
               tokens_batch=Bl * S * int(np.prod(shape[:-1])),
               mesh=shape, layout=layout_of(colls, V))
    if want_collectives:
        row["collectives"] = collectives_of(colls, shape)
    print(json.dumps(row), flush=True)
"""


def read(points: List[list], collectives: bool = False) -> List[dict]:
    """The reference's layout at each point, in order (one subprocess);
    with ``collectives``, also each collective of its compiled HLO, in
    program order: kind, dtype, shapes (an all-gather's result, else its
    operands), the mesh axes its replica groups span (a permute's pairs),
    its group's size (2 for a permute) and elements a device."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", REFERENCE,
                           json.dumps(points), str(int(collectives))],
                          env=env, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"the reference's lowering failed:\n"
                           f"{done.stderr[-3000:]}")
    out = done.stdout
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def grid() -> List[list]:
    """Vocabularies from half to 32 times a rank's tokens, around the
    table's boundaries, on five meshes; the three parity cells; and
    vocabularies from 0.75 to 1.5 times the batch's tokens, straddling the
    edges of the row-gather bands, at two widths on nine meshes."""
    pts = []
    for shape in ([16, 16], [16, 8], [8, 16]):
        for T in (4096, 16384, 65536):
            for r in (0.5, 0.9375, 1.0, 1.0625, 4, 8, 12, 13.5, 14, 16,
                      16.5, 20, 32):
                pts.append([int(r * T) // 256 * 256, 4096, T // 4096, 4096,
                            shape])
    for r in (6, 7.5, 8, 8.5):
        pts.append([int(r * 4096) // 256 * 256, 4096, 1, 4096, [8, 8]])
    for Bl in (1, 2):
        for r in (7.8125, 15.875, 31.25, 32, 44, 48, 64, 80):
            pts.append([int(r * Bl * 4096) // 512 * 512, 7168, Bl, 4096,
                        [2, 16, 16]])
    pts += [[65024, 4096, 16, 4096, [16, 16]],
            [163840, 7168, 16, 4096, [16, 16]],
            [163840, 7168, 8, 4096, [2, 16, 16]]]
    for shape in ([2, 2], [4, 4], [8, 8], [16, 16], [16, 8], [8, 16],
                  [2, 2, 2], [2, 4, 4], [2, 16, 16]):
        T = 4096 * int(np.prod(shape[:-1]))
        for D in (2048, 4096):
            for r in (0.75, 0.875, 0.9375, 0.96875, 0.984375, 1.0, 1.00390625,
                      1.0078125, 1.015625, 1.0625, 1.1875, 1.25, 1.328125,
                      1.40625, 1.4375, 1.5):
                pts.append([int(r * T) // shape[-1] * shape[-1], D, 1, 4096,
                            shape])
    return pts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", default=None)
    ap.add_argument("--collectives", action="store_true",
                    help="print each point's collectives too")
    args = ap.parse_args(argv)
    points = json.loads(args.points) if args.points else grid()
    for row in read(points, args.collectives):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
