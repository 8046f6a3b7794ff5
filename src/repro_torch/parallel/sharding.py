"""Logical sharding rules -> partition specs for the model's parameters.

The port's copy of the parameter half of the reference's
``parallel/sharding.py`` (``_param_rule``, ``param_pspecs``) and of the two
mesh helpers it reads from ``parallel/act.py`` (``_axis_size``, ``_div``).

Mesh axes (``'data'``, ``'model'``), policy of the baseline:

* TP (``'model'``)  -> heads / d_ff / vocab / experts;
* FSDP (``'data'``) -> the d_model axis of every weight matrix (ZeRO-3
  style).

``param_pspecs`` is the single source of truth for which parameter axes are
``'model'``-sharded: the workload lowering (:mod:`repro_torch.core.
workloads`) divides each parameter's gradient bytes by its tensor-parallel
shard factor and counts the ``'model'``-sharded matmul pairs that emit TP
collectives.  It passes a duck-typed mesh: the rules read only
``mesh.axis_names`` and ``mesh.shape`` (a name -> size mapping), so no
devices are needed to evaluate them.  A spec is a :class:`P`, the port's
stand-in for ``jax.sharding.PartitionSpec``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M

__all__ = ["P", "param_pspecs"]


class P(tuple):
    """A partition spec: one entry per array axis, each ``None``
    (replicated), a mesh-axis name, or a tuple of names."""

    def __new__(cls, *entries: Any) -> "P":
        return super().__new__(cls, entries)


def _axis_size(mesh: Any, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _div(n: int, mesh: Any, axis: str) -> bool:
    return n % _axis_size(mesh, axis) == 0


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
