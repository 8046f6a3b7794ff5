"""The port's sharding rules and activation constraints
(``repro_torch.parallel.{sharding,act}``) against the JAX reference's
``parallel/{sharding,act}.py`` on the CPU.

Every rule is held spec for spec: ``param_pspecs``, ``opt_pspecs``,
``batch_pspecs`` and ``cache_pspecs`` on every registered config x every
shape in ``SHAPES`` x the production meshes (16 x 16, 2 x 16 x 16), the
reference test's (2, 4) and a (1, 1) mesh, each a duck-typed mesh (axis
names and sizes, no devices) given to both.  ``constrain``'s cleaning of
absent, size-1 and non-dividing axes is held to the reference's, read off
the ``NamedSharding`` its ``constrain`` builds.  The DTensor placements of
a spec are checked by hand here; on ranks, in ``test_torch_sharded.py``.
"""
import importlib
import types

import pytest
import torch

from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.launch.mesh import (LogicalMesh, make_production_mesh,
                                     run_ranks)
from repro_torch.parallel import act as A
from repro_torch.parallel import sharding as PSH
from repro_torch.parallel.ranks import summed_shards_rank
from test_torch_harness import load_reference

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model"))]


@pytest.fixture(scope="module")
def ref():
    r = load_reference()
    for name in ("repro.parallel.sharding", "repro.parallel.act",
                 "repro.launch.mesh"):
        setattr(r, name.rsplit(".", 1)[-1], importlib.import_module(name))
    return r


def _duck(shape, names):
    """The duck-typed mesh both packages' rules read."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, shape)))


def _specs(tree):
    """Leaves of a spec tree as plain tuples, with the tree's shape."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [_specs(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("arch", list_configs())
def test_rules_equal_the_reference(ref, arch):
    cfg, rcfg = get_config(arch), ref.config_base.get_config(arch)
    for shape, names in MESHES:
        mesh = _duck(shape, names)
        where = (arch, shape)
        assert _specs(PSH.param_pspecs(cfg, mesh)) == _specs(
            ref.sharding.param_pspecs(rcfg, mesh)), where
        assert _specs(PSH.opt_pspecs(cfg, mesh)) == _specs(
            ref.sharding.opt_pspecs(rcfg, mesh)), where
        for sname, sp in SHAPES.items():
            rsp = ref.config_base.SHAPES[sname]
            assert _specs(PSH.batch_pspecs(cfg, sp, mesh)) == _specs(
                ref.sharding.batch_pspecs(rcfg, rsp, mesh)), where + (sname,)
            assert _specs(PSH.cache_pspecs(cfg, sp, mesh)) == _specs(
                ref.sharding.cache_pspecs(rcfg, rsp, mesh)), where + (sname,)
        assert PSH.batch_axes(mesh) == ref.sharding.batch_axes(mesh)
        for dims in ((7, 16), (0, 3, 32), (5,)):
            assert PSH.pick_tp_dim(mesh, *dims) == \
                ref.sharding.pick_tp_dim(mesh, *dims)
    # the port's meshes carry the same names and sizes
    for multi, (shape, names) in ((False, MESHES[0]), (True, MESHES[1])):
        m = make_production_mesh(multi_pod=multi)
        assert (m.axis_names, tuple(m.shape.values())) == (names, shape)


def test_exports_cover_the_reference(ref):
    for mine, theirs in ((A, ref.act), (PSH, ref.sharding)):
        missing = set(theirs.__all__) - set(dir(mine))
        assert not missing, (mine.__name__, missing)
    assert (PSH.BATCH, PSH.TP) == (ref.sharding.BATCH, ref.sharding.TP)


#: (mesh, array shape, spec): absent axes, size-1 axes, dims the axes do
#: not divide, and ('pod', 'data') entries, kept whole or dropped
CONSTRAIN_CASES = [
    (((2, 4), ("data", "model")), (8, 32, 4, 16), (A.BATCH, None, A.TP, None)),
    (((2, 4), ("data", "model")), (8, 32, 2, 16), (A.BATCH, None, A.TP, None)),
    (((2, 4), ("data", "model")), (3, 32, 64), (A.BATCH, None, A.TP)),
    (((2, 4), ("data", "model")), (8, 32, 1, 16), (A.BATCH, None, None, A.TP)),
    (((2, 16, 16), ("pod", "data", "model")), (64, 8, 32),
     (A.BATCH, None, A.TP)),
    (((2, 16, 16), ("pod", "data", "model")), (16, 8, 32),
     (A.BATCH, None, A.TP)),
    (((2, 16, 16), ("pod", "data", "model")), (2, 8, 30),
     (("pod",), "model", None)),
    (((1, 1), ("data", "model")), (8, 32, 4, 16), (A.BATCH, None, A.TP, None)),
    (((16, 16), ("data", "model")), (256, 4096, 152064),
     (A.BATCH, None, A.TP)),
    (((16, 16), ("data", "model")), (4, 384, 27, 7168),
     (A.BATCH, A.TP, None, None)),
]


@pytest.mark.parametrize("mesh,shape,spec", CONSTRAIN_CASES)
def test_constrain_cleans_axes_as_the_reference(ref, monkeypatch, mesh, shape,
                                                spec):
    """The reference's ``constrain`` builds ``NamedSharding(mesh,
    P(*clean))``; capture that spec (no devices needed) and hold the
    port's ``clean_spec`` to it."""
    duck = _duck(*mesh)
    monkeypatch.setattr(ref.act, "NamedSharding", lambda m, p: p)
    monkeypatch.setattr(ref.act.jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    with ref.act.activation_mesh(duck):
        want = ref.act.constrain(types.SimpleNamespace(shape=shape), *spec)
    assert A.clean_spec(shape, spec, duck) == tuple(want)


def test_constrain_is_identity_off_mesh_and_on_plain_tensors():
    """Outside an activation_mesh, or on a plain tensor inside one,
    ``constrain`` returns its argument itself (single-device runs keep
    every bit)."""
    x = torch.randn(4, 8)
    assert A.constrain(x, A.BATCH, None) is x
    assert A.constrain(None, A.BATCH) is None
    with A.activation_mesh(_duck((2, 4), ("data", "model"))):
        assert A.constrain(x, A.BATCH, A.TP) is x
        assert A._ACT_MESH is not None
    assert A._ACT_MESH is None


def test_placements_of_a_spec():
    """One placement per mesh dim; a dim over ('pod', 'data') takes two
    Shard(d) in mesh-dim order; any other order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = LogicalMesh((2, 2, 2), ("pod", "data", "model"))
    assert A.placements_for((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert A.placements_for((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert A.placements_for((("data",), None), mesh) == (
        Replicate(), Shard(0), Replicate())
    assert A.placements_for(("pod", None), LogicalMesh(
        (2, 4), ("data", "model"))) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh-dim order"):
        A.placements_for((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        A.placements_for(("model", "model"), mesh)


def test_per_shard_runs_plain_tensors_directly():
    """Without a DTensor among its arguments ``per_shard`` is the call
    itself (the single-device path)."""
    x = torch.randn(3, 5)
    got = A.per_shard(lambda a, *, s: a * s, (x,), (("b", "d"),),
                      (("b", "d"),), frozenset({"b"}), s=2.0)
    assert torch.equal(got, x * 2.0)


def test_per_shard_summed_labels_give_a_partial_sum():
    """On 4 gloo CPU ranks (data 2 x model 2): x (4, 8), rows on 'data'
    and columns on 'model', summed over its columns with the columns'
    label summed.  Each rank sums its own block: the result is sharded on
    'data' and a Partial sum over 'model', whose whole value is the
    one-device sum (small integers: exact); the input's gradient keeps
    x's placements, each rank its own (2, 4) block, and is the one-device
    gradient.  Off a mesh the same call runs the function directly."""
    whole = (torch.arange(32, dtype=torch.float32).reshape(4, 8) % 7) - 3
    w = torch.arange(1, 5, dtype=torch.float32)
    for r in run_ranks(summed_shards_rank, 4, (2, 2), device="cpu"):
        assert r["placements"] == [("Shard", 0), ("Partial", None)]
        assert torch.equal(torch.from_numpy(r["y"]), whole.sum(-1))
        assert r["grad_placements"] == r["x_placements"] == [
            ("Shard", 0), ("Shard", 1)]
        assert r["grad_local_shape"] == r["x_local_shape"] == (2, 4)
        assert torch.equal(torch.from_numpy(r["grad"]),
                           w[:, None].expand(4, 8))
    got = A.per_shard(lambda t: t.sum(-1), (whole,), (("b", "n"),),
                      (("b",),), frozenset({"b"}),
                      summed=frozenset({"n"}))
    assert torch.equal(got, whole.sum(-1))
