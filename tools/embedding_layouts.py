"""Which layout XLA's SPMD partitioner gives the reference's embedding
lookup: the table's rows moved, the tokens moved, or the table's whole
rows gathered over 'model', at points of (rows V, d_model D, tokens a
rank, mesh).

    PYTHONPATH=src python tools/embedding_layouts.py \
        [--points '[[65024, 4096, 16, 4096, [16, 16]], ...]']

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
whole rows are all-gathered without a permute.  Prints one JSON line a
point; with no ``--points``, a grid over vocabularies, tokens and meshes
(~5 minutes).  CPU only; needs jax.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import json, os, re, sys, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.parallel import sharding as sh
from repro.models import model as RM


def layout(V, D, Bl, S, shape):
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
        hlo = f.lower(jax.ShapeDtypeStruct((V, D), jnp.float32),
                      jax.ShapeDtypeStruct((B, S), jnp.int32),
                      jax.ShapeDtypeStruct((B, S, D), jnp.float32)
                      ).compile().as_text()
    colls = re.findall(r"= (\S+?)(?:\{[^}]*\})? (all-gather|all-reduce|"
                       r"collective-permute|all-to-all)(?:-start)?\(", hlo)
    if any(k == "all-gather" and s.startswith("s32") for s, k in colls):
        return "tokens"
    if any(k == "collective-permute" and s.startswith("f32")
           for s, k in colls):
        return "table"
    if any(k == "all-gather" and s.startswith("f32[%d," % V)
           for s, k in colls):
        return "rows"
    return "unknown"


for V, D, Bl, S, shape in json.loads(sys.argv[1]):
    print(json.dumps(dict(V=V, D=D, tokens_rank=Bl * S,
                          tokens_batch=Bl * S * int(np.prod(shape[:-1])),
                          mesh=shape, layout=layout(V, D, Bl, S, shape))),
          flush=True)
"""


def read(points: List[list]) -> List[dict]:
    """The reference's layout at each point, in order (one subprocess)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE,
                          json.dumps(points)], env=env, check=True,
                         capture_output=True, text=True).stdout
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def grid() -> List[list]:
    """Vocabularies from half to 32 times a rank's tokens, around the
    boundaries, on five meshes; the three parity cells."""
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
    return pts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", default=None)
    args = ap.parse_args(argv)
    points = json.loads(args.points) if args.points else grid()
    for row in read(points):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
