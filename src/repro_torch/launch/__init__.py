"""repro_torch.launch — meshes, ranks, input stand-ins, the HLO byte
auditor, and the dry run of the reference's ``launch`` package (PyTorch
port).

* :mod:`.mesh` — the production meshes as axis names and sizes, a
  ``DeviceMesh`` over the process group, ``shard_batch``, and
  :func:`mesh.run_ranks`, which starts N ranks joined in one gloo group;
* :mod:`.specs` — meta-device stand-ins of every model input and of the
  train state and caches;
* :mod:`.hlo_analysis` — the stdlib-only parser that the workload lowering
  (:mod:`repro_torch.core.workloads`) re-reads its own synthetic HLO with,
  the reference's modeled accelerator ``HW`` and the card's ``HW_H100``;
* :mod:`.dryrun` — every (arch x shape x mesh) cell's sharded step traced
  over a fake world of 256 or 512 ranks with fake tensors, and one rank's
  FLOPs, bytes, collectives and memory (``python -m
  repro_torch.launch.dryrun``);
* :mod:`.hillclimb` — one cell traced with config overrides beside its
  dry-run baseline (``python -m repro_torch.launch.hillclimb``).

:mod:`.dryrun` and :mod:`.hillclimb` are not imported here: run them as
modules.
"""
from . import hlo_analysis
from .hlo_analysis import HW, HW_H100, HloStats, analyze_hlo, roofline_terms

__all__ = ["HW", "HW_H100", "HloStats", "analyze_hlo", "hlo_analysis",
           "roofline_terms"]
