"""repro_torch.launch — the HLO byte auditor of the reference's ``launch``
package (PyTorch port).

Only :mod:`.hlo_analysis` is ported: the stdlib-only parser that the
workload lowering (:mod:`repro_torch.core.workloads`) re-reads its own
synthetic HLO with.  Not ported yet: the dry-run compile and launch path.
"""
from . import hlo_analysis
from .hlo_analysis import HW, HloStats, analyze_hlo, roofline_terms

__all__ = ["HW", "HloStats", "analyze_hlo", "hlo_analysis", "roofline_terms"]
