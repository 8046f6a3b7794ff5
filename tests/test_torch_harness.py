"""Harness of the PyTorch port's parity tests: the JAX reference loader, and
the port's own boundary (what it imports, where it runs by default).

The reference is loaded inside a fixture, never at import time: loading it
aliases ``jax.experimental.enable_x64`` (gone from newer jax, still imported
by the reference's routing and traffic modules) to
``lambda: jax.enable_x64(True)`` before ``import repro``, and doing that at
collection would change which reference test files collect in the same
worker.  Data crosses between the two frameworks as numpy; JAX stays on the
CPU.  Other ``test_torch_*`` files import :func:`load_reference` from here.
"""
import ast
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def load_reference() -> types.SimpleNamespace:
    """Import the JAX reference (after the ``enable_x64`` alias) and return
    its modules the parity tests use."""
    import importlib

    import jax
    import jax.experimental as jexp

    if not hasattr(jexp, "enable_x64"):
        jexp.enable_x64 = lambda: jax.enable_x64(True)
    mods = {}
    for name in ("repro.obs", "repro.api", "repro.api.registry",
                 "repro.api.analysis", "repro.api.survey", "repro.core.graphs",
                 "repro.core.topologies", "repro.core.ramanujan",
                 "repro.core.properties", "repro.core.spectral",
                 "repro.core.faults", "repro.core.collectives",
                 "repro.core.simulate", "repro.core.placement",
                 "repro.core.synthesis",
                 "repro.core.lifts", "repro.core.reduction",
                 "repro.core.routing", "repro.core.traffic",
                 "repro.kernels.spmv", "repro.configs", "repro.models.layers",
                 "repro.models.attention", "repro.models.mamba",
                 "repro.models.moe", "repro.models.transformer",
                 "repro.models.model"):
        mods[name.rsplit(".", 1)[-1]] = importlib.import_module(name)
    mods["config_base"] = importlib.import_module("repro.configs.base")
    # the kernels' Pallas bodies and oracles, e.g. ``rmsnorm_kernel``
    for kern in ("cayley_spmv", "rmsnorm", "flash_attention", "mamba_scan"):
        for part in ("kernel", "ref", "ops"):
            mods[f"{kern}_{part}"] = importlib.import_module(
                f"repro.kernels.{kern}.{part}")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, **mods)


def ref_topology(ref: types.SimpleNamespace, g):
    """The reference's Topology over a port topology's own edge list, loops
    and meta (so both frameworks see the same graph)."""
    return ref.graphs.Topology(
        g.name, g.n, g.edges.copy(),
        loops=None if g.loops is None else g.loops.copy(), meta=dict(g.meta))


def load_chip_smoke() -> types.ModuleType:
    """``chip_smoke.py`` loaded as a module (its helpers and constants, not
    its run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _python_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_or_reference(path):
    """Static check: no port module (nor chip_smoke.py) names jax, repro or
    networkx in an import statement (the machine with the card has none of
    them; ``random_regular`` carries its own copy of networkx's pairing)."""
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro", "networkx"}


def test_importing_the_port_loads_no_jax_or_reference():
    """Runtime check, in a fresh interpreter: importing every module of the
    port leaves jax, every repro.* module and networkx out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.api.survey, repro_torch.api.analysis\n"
        "import repro_torch.core.workloads, repro_torch.parallel.sharding\n"
        "import repro_torch.launch.hlo_analysis, repro_torch.topology_report\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'networkx')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_cuda():
    """Entry points default to the card and raise without one; they never
    carry on on the CPU unless asked."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.api import Analysis, survey
    from repro_torch.core import spectral as S
    from repro_torch.core import topologies as T
    from repro_torch.kernels import spmv as KS

    g = T.petersen()
    tab, w = g.gather_operands()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Analysis("petersen")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        survey(["petersen"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.rho2_lanczos(g, iters=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KS.spmv_matvec(tab, w)
    assert Analysis("petersen", device="cpu").rho2 == pytest.approx(2.0)


def test_chip_smoke_fails_without_cuda_or_sources(tmp_path):
    """chip_smoke.py exits non-zero and prints no result here (no card), and
    also when it stands alone in a directory without the port."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_reference_loader_runs_the_reference(ref):
    a = ref.analysis.Analysis("lps(13,5)", dense_threshold=0)
    assert a.rho2 == pytest.approx(1.7502792, abs=1e-3)


def test_port_spec_lists_equal_the_benchmarks(ref):
    """The port keeps its own copies of the benchmarks' spec lists (the
    benchmarks import the reference); they must not drift."""
    import benchmarks.collective_sim as CSB
    import benchmarks.fault_sweep as FS
    import benchmarks.lps_bench as LB
    import benchmarks.routing_eval as RE
    import benchmarks.routing_schemes as RS
    import benchmarks.scale_bench as SB
    import benchmarks.table1 as T1
    from repro_torch import specs
    from repro_torch.core import traffic

    assert specs.TABLE1_SPECS == T1.SPECS
    assert specs.LPS_SPECS == LB.SPECS
    assert specs.LPS_DENSE_THRESHOLD == LB.DENSE_THRESHOLD
    assert specs.ROUTING_EVAL_SPECS == RE.SPECS
    assert specs.SCALE_BENCH_SPECS == SB.SPECS
    assert specs.SCALE_SPEC == SB.SCALE_SPEC
    assert specs.SCALE_NODES == SB.SCALE_NODES
    assert specs.SCALE_SOURCES == SB.SCALE_SOURCES
    assert specs.DIAMETER_LB_FLOOR == SB.DIAMETER_LB_FLOOR
    assert specs.SCALE_COLUMNS == SB.COLUMNS
    assert specs.ROUTING_SCHEMES_SPECS == RS.SPECS
    assert specs.ROUTING_SCHEMES_EXPANDERS == RS.EXPANDERS
    assert specs.ROUTING_SCHEMES_DENSE_THRESHOLD == RS.DENSE_THRESHOLD
    assert traffic.ROUTING_SCHEMES == RS.SCHEMES
    assert (specs.MCF_TOL_REL, specs.MCF_TOL_ABS) == (RS.MCF_TOL_REL,
                                                      RS.MCF_TOL_ABS)
    assert specs.COLLECTIVE_SIM_SPECS == CSB.SPECS
    assert specs.COLLECTIVE_SIM_SPECTRAL_ORDER == CSB.SPECTRAL_ORDER
    assert specs.COLLECTIVE_SIM_PAYLOAD == CSB.PAYLOAD
    assert specs.COLLECTIVE_SIM_THPT_TOL == CSB.THPT_TOL
    assert specs.COLLECTIVE_SIM_EXTRA_ALGO_MAX_N == CSB.EXTRA_ALGO_MAX_N
    assert specs.COLLECTIVE_SIM_DENSE_THRESHOLD == CSB.DENSE_THRESHOLD
    assert specs.FAULT_SWEEP_SPECS == FS.SPECS
    assert (specs.FAULT_SWEEP_RATES, specs.FAULT_SWEEP_SAMPLES,
            specs.FAULT_SWEEP_ATTACK_RATE, specs.FAULT_SWEEP_SEED,
            specs.FAULT_SWEEP_ITERS) == (FS.RATES, FS.SAMPLES, FS.ATTACK_RATE,
                                         FS.SEED, FS.ITERS)


def test_obs_copy_keeps_the_reference_api(ref):
    from repro_torch import obs

    assert obs.__all__ == ref.obs.__all__
    obs.reset()
    with obs.tracing():
        with obs.span("a", phase="execute"):
            obs.count("x", 2)
    rep = obs.metrics_report()
    assert rep.counters["x"] == 2 and rep.spans["a"].calls == 1
    assert np.isfinite(rep.phases["execute"])
