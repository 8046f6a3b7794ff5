"""The port's architecture configs against the JAX reference's.

The port keeps its own copy of ``configs/base.py`` and of every config data
file; each registered config must equal the reference's field by field, with
the same analytic parameter counts, the same ``reduced`` form and the same
cells.
"""
import dataclasses

import pytest

from repro_torch import configs as PC
from repro_torch.configs import base as PB
from repro_torch.models import model as PM
from test_torch_harness import load_reference

# the registry is static data: list it here rather than at collection time
ARCHS = ["falcon-mamba-7b", "gemma-2b", "gemma3-12b", "grok-1-314b",
         "h2o-danube-3-4b", "hubert-xlarge", "jamba-v0.1-52b",
         "kimi-k2-1t-a32b", "lm100m", "qwen2-7b", "qwen2-vl-7b"]


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["pattern"] = [dataclasses.asdict(s) for s in cfg.pattern]
    return out


def test_registry_lists_the_same_archs(ref):
    assert PC.list_configs() == ref.configs.list_configs() == ARCHS
    assert list(PB.SHAPES) == list(ref.config_base.SHAPES)
    for name, shape in PB.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            ref.config_base.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(ref, arch):
    mine, theirs = PC.get_config(arch), ref.configs.get_config(arch)
    assert _fields(mine) == _fields(theirs)
    for prop in ("n_repeats", "d_inner", "dt_rank", "has_attention",
                 "sub_quadratic"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()
    assert ([s.name for s in PB.cells_for(mine)]
            == [s.name for s in ref.config_base.cells_for(theirs)])


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_equals_reference(ref, arch):
    mine = PB.reduced(PC.get_config(arch))
    theirs = ref.config_base.reduced(ref.configs.get_config(arch))
    assert _fields(mine) == _fields(theirs)
    assert mine.param_count() == theirs.param_count()
    for repeats in (1, 3):
        assert _fields(PB.reduced(PC.get_config(arch), repeats)) == _fields(
            ref.config_base.reduced(ref.configs.get_config(arch), repeats))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-7b",
                                  "falcon-mamba-7b", "gemma3-12b"])
def test_param_shapes_equal_reference(ref, arch):
    """The port's parameter tree has the reference's paths and shapes, at
    full width (shapes only: nothing is allocated)."""
    cfg = PC.get_config(arch)
    rshapes = ref.model.param_shapes(ref.configs.get_config(arch))

    def norm(t):
        if isinstance(t, dict):
            return {k: norm(v) for k, v in t.items()}
        if isinstance(t, list):
            return [norm(v) for v in t]
        return tuple(t)

    assert norm(PM.param_shapes(cfg)) == norm(rshapes)


def test_jamba_param_count_differs_from_the_tree():
    """Recorded reference behaviour, kept by the copy: for jamba,
    ``param_count`` leaves out the dense MLP and its norm on the three
    non-MoE Mamba positions of each period, and two of the three (d_inner,)
    vectors (``conv_b``, ``dt_bias``, ``D``) of every Mamba layer, all of
    which the parameter tree holds: 51.57 B materialized, 49.46 B counted."""
    import math

    cfg = PC.get_config("jamba-v0.1-52b")

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return math.prod(t)

    D, R = cfg.d_model, cfg.n_repeats
    mlps = R * 3 * (3 * D * cfg.d_ff + D)
    vectors = R * 7 * 2 * cfg.d_inner
    materialized = count(PM.param_shapes(cfg))
    assert materialized == cfg.param_count() + mlps + vectors
    assert (materialized, cfg.param_count()) == (51_570_315_264,
                                                 49_455_878_144)
