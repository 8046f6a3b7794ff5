"""The port's ``launch/specs`` and ``launch/mesh`` and the quickstart
against the JAX reference on the CPU.

* ``input_specs``, ``train_state_specs`` and ``cache_specs``: meta-device
  tensors whose trees, shapes and dtypes equal the reference's
  ``jax.eval_shape`` stand-ins, on every registered config (and every
  shape in ``SHAPES`` for the batch and cache specs).
* ``shard_batch`` keeps the reference's contract on one process.
* ``python -m repro_torch.quickstart --device cpu`` prints the reference
  ``examples/quickstart.py``'s figures, number for number (every figure
  is a host computation: dense spectra and numpy draws in both).
"""
import contextlib
import importlib
import io
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.launch import mesh as LM
from repro_torch.launch import specs as SP
from repro_torch.optim.adamw import AdamWConfig
from test_torch_harness import ROOT, load_reference

NUMBER = r"-?\d+(?:\.\d+)?"


@pytest.fixture(scope="module")
def ref():
    r = load_reference()
    r.specs = importlib.import_module("repro.launch.specs")
    return r


def _described(tree):
    """A spec tree as nested dicts / lists of (shape, dtype name)."""
    if isinstance(tree, dict):
        return {k: _described(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_described(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), str(np.dtype(tree.dtype))


@pytest.mark.parametrize("arch", list_configs())
def test_specs_equal_the_references_eval_shape(ref, arch):
    cfg, rcfg = get_config(arch), ref.config_base.get_config(arch)
    opt = AdamWConfig()
    ropt = ref.adamw.AdamWConfig()
    assert _described(SP.train_state_specs(cfg, opt)) == _described(
        ref.specs.train_state_specs(rcfg, ropt)), arch
    for name, shape in SHAPES.items():
        rshape = ref.config_base.SHAPES[name]
        assert _described(SP.input_specs(cfg, shape)) == _described(
            ref.specs.input_specs(rcfg, rshape)), (arch, name)
        if shape.kind == "decode" and cfg.causal:
            assert _described(SP.cache_specs(cfg, shape)) == _described(
                ref.specs.cache_specs(rcfg, rshape)), (arch, name)


def test_specs_allocate_nothing():
    """kimi-k2's 1 T parameters and their AdamW state as meta tensors."""
    params, opt = SP.train_state_specs(get_config("kimi-k2-1t-a32b"),
                                       AdamWConfig())
    from repro_torch import tree as T

    leaves = T.leaves(params) + T.leaves(opt)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in T.leaves(params)) > 1e12


def test_shard_batch_is_the_identity_in_one_process():
    a, b = torch.zeros(4, 3), torch.ones(4)
    assert LM.shard_batch(a) is a
    got = LM.shard_batch(a, b)
    assert got[0] is a and got[1] is b


def _printed(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_quickstart_prints_the_references_figures(ref):
    from repro_torch import quickstart as Q

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        reference = importlib.import_module("quickstart")
    finally:
        sys.path.remove(str(ROOT / "examples"))
    mine = _printed(lambda: Q.main(device="cpu"))
    theirs = _printed(reference.main)
    assert re.findall(NUMBER, mine) == re.findall(NUMBER, theirs)
    assert len(re.findall(NUMBER, mine)) > 40
    assert mine.splitlines() == theirs.splitlines()


def test_quickstart_cli_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    env = {"PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.quickstart"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
