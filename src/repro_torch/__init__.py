"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The paper's main measurement runs end to end here: build a topology from a
registry spec (:mod:`repro_torch.api.registry`), measure rho_2 / lambda
(dense host oracle, or Lanczos on the card through the hand-written spmv
kernel of :mod:`repro_torch.kernels.spmv`), check it against the Table-1
bounds, and emit survey rows (:mod:`repro_torch.api`); the Cayley matvec
(:mod:`repro_torch.kernels.cayley_spmv`) is the alternative Lanczos
operator.  Topologies are also designed (:mod:`repro_torch.core.synthesis`:
lift towers searched with signed Lanczos on the card) and routed
(:mod:`repro_torch.core.routing`, :mod:`repro_torch.core.traffic`: BFS,
minimal-path counts, minimal-ECMP link loads), up to the datacenter-scale
``xpander(65536,32,0,0)`` survey row.  The LM stack
serves the reference's model configs (:mod:`repro_torch.configs`,
:mod:`repro_torch.models`, :mod:`repro_torch.serve`): prefill and greedy
decode, with RMSNorm, prefill attention and the Mamba prefill scan as
hand-written kernels on the card.

The package imports torch, numpy and scipy — never jax, and nothing of the
reference package.  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU.
"""
