"""The port's own copies of the reference benchmarks' spec lists.

The port may not import the reference's ``benchmarks`` package (it imports
the JAX stack), so the lists its checks run over live here; a test holds them
equal to ``benchmarks/table1.py``, ``benchmarks/lps_bench.py`` and
``benchmarks/routing_eval.py``.
"""

#: benchmarks/table1.py SPECS — the paper's Table 1 instances
TABLE1_SPECS = [
    "butterfly(3,4)", "butterfly(4,4)", "ccc(5)", "ccc(7)", "clex(3,3)",
    "clex(4,3)", "data_vortex(8,4)", "data_vortex(16,5)", "hypercube(8)",
    "hypercube(10)", "petersen_torus(7,6)", "slimfly(5)", "slimfly(13)",
    "slimfly(17)", "torus(8,2)", "torus(16,2)", "torus(8,3)",
]

#: benchmarks/lps_bench.py SPECS and DENSE_THRESHOLD — LPS certification
LPS_SPECS = ["lps(13,5)", "lps(13,17)", "lps(17,5)", "lps(17,13)",
             "lps(29,5)"]
LPS_DENSE_THRESHOLD = 5000

#: benchmarks/routing_eval.py SPECS
ROUTING_EVAL_SPECS = [
    "lps(13,5)", "slimfly(13)", "torus(16,2)", "hypercube(8)", "ccc(6)",
    "butterfly(3,4)", "petersen_torus(5,4)", "dragonfly",
    "random_regular(256,6,0)",
]
