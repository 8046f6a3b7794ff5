"""repro_torch.launch — meshes, ranks, input stand-ins and the HLO byte
auditor of the reference's ``launch`` package (PyTorch port).

* :mod:`.mesh` — the production meshes as axis names and sizes, a
  ``DeviceMesh`` over the process group, ``shard_batch``, and
  :func:`mesh.run_ranks`, which starts N ranks joined in one gloo group;
* :mod:`.specs` — meta-device stand-ins of every model input and of the
  train state and caches;
* :mod:`.hlo_analysis` — the stdlib-only parser that the workload lowering
  (:mod:`repro_torch.core.workloads`) re-reads its own synthetic HLO with.

Not ported yet: ``dryrun`` and ``hillclimb``, which lower every (arch x
shape x mesh) cell through XLA for 256 or 512 placeholder devices and read
the HLO; their counterpart traces the sharded step over a fake world.
"""
from . import hlo_analysis
from .hlo_analysis import HW, HloStats, analyze_hlo, roofline_terms

__all__ = ["HW", "HloStats", "analyze_hlo", "hlo_analysis", "roofline_terms"]
