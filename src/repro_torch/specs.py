"""The port's own copies of the reference benchmarks' spec lists.

The port may not import the reference's ``benchmarks`` package (it imports
the JAX stack), so the lists its checks run over live here; tests hold them
equal to the benchmark modules named beside each list.
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

#: benchmarks/scale_bench.py SPECS — the exactness sweep's families
SCALE_BENCH_SPECS = [
    "lps(13,5)", "slimfly(13)", "torus(16,2)", "hypercube(8)", "ccc(6)",
    "butterfly(3,4)", "petersen_torus(5,4)", "dragonfly",
    "random_regular(256,6,0)",
]

#: benchmarks/scale_bench.py — the datacenter-scale survey row
SCALE_SPEC = "xpander(65536,32,0,0)"
SCALE_NODES = 65536
SCALE_SOURCES = 64            # sample_fraction = 64 / 65536 ~ 0.1%
#: Moore bound: a 32-regular graph on 65536 nodes has diameter >= 4; the
#: sampled lower bound must land in [3, true diameter]
DIAMETER_LB_FLOOR = 3

#: benchmarks/scale_bench.py COLUMNS — the scale row's schema
SCALE_COLUMNS = [
    "instance", "nodes", "radix", "backend", "rho2",
    "diameter_bfs", "diameter_lb", "diameter_ok", "avg_hops", "avg_hops_ci",
    "path_diversity", "traffic_pattern", "max_link_load",
    "saturation_throughput", "throughput_spectral", "seconds",
]

#: benchmarks/routing_schemes.py SPECS, EXPANDERS, DENSE_THRESHOLD and the
#: MCF tolerances — the routing-scheme comparison (its SCHEMES are
#: ``core.traffic.ROUTING_SCHEMES``)
ROUTING_SCHEMES_SPECS = [
    "lps(13,5)", "slimfly(13)", "xpander(256,6,0,0)", "torus(16,2)",
    "hypercube(8)", "ccc(6)", "butterfly(3,4)", "petersen_torus(5,4)",
    "dragonfly",
]
ROUTING_SCHEMES_EXPANDERS = ("lps(13,5)", "slimfly(13)", "xpander(256,6,0,0)")
ROUTING_SCHEMES_DENSE_THRESHOLD = 1024
MCF_TOL_REL = 1e-6
MCF_TOL_ABS = 1e-9

#: benchmarks/collective_sim.py SPECS, SPECTRAL_ORDER, PAYLOAD, THPT_TOL,
#: EXTRA_ALGO_MAX_N and DENSE_THRESHOLD — the executed-collective bench
COLLECTIVE_SIM_SPECS = [
    "lps(13,5)", "slimfly(13)", "torus(16,2)", "hypercube(8)", "ccc(6)",
    "butterfly(3,4)", "petersen_torus(5,4)", "dragonfly", "xpander(512,6)",
]
COLLECTIVE_SIM_SPECTRAL_ORDER = ["slimfly(13)", "hypercube(8)", "lps(13,5)",
                                 "torus(16,2)", "ccc(6)"]
COLLECTIVE_SIM_PAYLOAD = float(1 << 26)
COLLECTIVE_SIM_THPT_TOL = 1e-3
COLLECTIVE_SIM_EXTRA_ALGO_MAX_N = 512
COLLECTIVE_SIM_DENSE_THRESHOLD = 1024

#: benchmarks/fault_sweep.py SPECS, RATES, SAMPLES, ATTACK_RATE, SEED, ITERS
FAULT_SWEEP_SPECS = [
    "lps(13,5)", "slimfly(13)", "torus(16,2)", "hypercube(8)", "ccc(6)",
    "butterfly(3,4)", "petersen_torus(5,4)", "dragonfly",
    "random_regular(256,6,0)",
]
FAULT_SWEEP_RATES = (0.02, 0.05, 0.1, 0.2)
FAULT_SWEEP_SAMPLES = 32
FAULT_SWEEP_ATTACK_RATE = 0.1
FAULT_SWEEP_SEED = 0
FAULT_SWEEP_ITERS = 160

#: benchmarks/workload_sim.py WORKLOADS and PLACEMENT — the executed
#: training-step bench (its families are ``COLLECTIVE_SIM_SPECS``): three
#: model configs at world = 64 ranks under uniform-random placement
WORKLOAD_SIM_WORKLOADS = [
    "kimi_k2_1t@dp=16,tp=4,ep=8",
    "qwen2_7b@dp=16,tp=4",
    "grok_1_314b@dp=16,tp=4,ep=8",
]
WORKLOAD_SIM_PLACEMENT = "random"
