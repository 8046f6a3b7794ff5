"""The survey fan-out of the PyTorch port: one engine behind Table 1 and the
LPS certification.

``survey(specs, columns=...)`` builds every requested topology through the
registry, wraps each in a lazy :class:`~repro_torch.api.analysis.Analysis`,
batches same-shape Lanczos solves into a single batched call, and emits
rows / CSV / JSON.  The main-path column sets (:data:`DEFAULT_COLUMNS`,
:data:`TABLE1_COLUMNS`, :data:`RAMANUJAN_COLUMNS`) and the evaluation
keywords are ported: ``routing=`` (:data:`ROUTING_COLUMNS`, every routing
scheme and the MCF ceiling), ``simulate=`` (:data:`SIM_COLUMNS`) and
``faults=`` (:data:`FAULT_COLUMNS`).  The reference's ``workload=`` keyword
(training-step plans) is not ported yet and raises
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import spectral as S
from repro_torch.core.graphs import Topology
from repro_torch.device import DEFAULT_DEVICE, resolve_device

from .analysis import Analysis
from .registry import REGISTRY

__all__ = ["survey", "SurveyResult", "COLUMNS", "DEFAULT_COLUMNS",
           "TABLE1_COLUMNS", "RAMANUJAN_COLUMNS", "FAULT_COLUMNS",
           "ROUTING_COLUMNS", "SIM_COLUMNS"]


def _round(x: float, nd: int = 6) -> float:
    return round(float(x), nd)


def csv_field(v) -> str:
    """One CSV cell, quoted/escaped when needed (shared by every CSV writer)."""
    s = "" if v is None else str(v)
    if any(ch in s for ch in ',"\n'):
        s = '"' + s.replace('"', '""') + '"'
    return s


def _forms_value(a: Analysis, key: str) -> Any:
    cf = a.closed_forms
    return _round(cf[key]) if cf and key in cf else None


#: column name -> Analysis -> value.  Scripts may register more.
COLUMNS: Dict[str, Callable[[Analysis], Any]] = {
    "topology": lambda a: a.family or a.name,
    "instance": lambda a: a.name,
    "spec": lambda a: a.spec or a.name,
    "nodes": lambda a: a.n,
    "radix": lambda a: None if a.radix is None else int(a.radix)
        if float(a.radix).is_integer() else a.radix,
    "backend": lambda a: a.backend,
    "bipartite": lambda a: bool(a.topo.meta.get("bipartite")),
    "rho2": lambda a: _round(a.rho2),
    "rho2_ub_paper": lambda a: _forms_value(a, "rho2_ub"),
    "rho2_lb_paper": lambda a: _forms_value(a, "rho2_lb"),
    "rho2_ok": lambda a: _closed_form_ok(a),
    "lambda": lambda a: _round(a.lambda_nontrivial),
    "ramanujan_bound": lambda a: _round(a.ramanujan["lambda_bound"]),
    "is_ramanujan": lambda a: a.ramanujan["is_ramanujan"],
    "diameter": lambda a: a.diameter,
    "alon_milman_diam_ub": lambda a: a.bounds["alon_milman_diameter_ub"],
    "bw_witness": lambda a: a.bisection_witness,
    "bw_fiedler_lb": lambda a: _round(a.bounds["fiedler_bw_lb"], 2),
    "bw_ub_paper": lambda a: _forms_value(a, "bw_ub"),
    "bw_m_half_ub": lambda a: a.bounds["first_moment_bw_ub"],
    "ramanujan_rho2": lambda a: _round(a.ramanujan["rho2_optimum"]),
    "rho2_gap_ratio": lambda a: _round(a.ramanujan["rho2_ratio"], 4),
}

DEFAULT_COLUMNS = [
    "topology", "spec", "nodes", "radix", "backend", "rho2", "rho2_ub_paper",
    "rho2_ok", "bw_fiedler_lb", "bw_witness", "bw_ub_paper",
    "ramanujan_rho2", "rho2_gap_ratio",
]

#: the exact schema of the reference's benchmarks/out/table1.csv
TABLE1_COLUMNS = [
    "topology", "instance", "nodes", "radix", "rho2", "rho2_ub_paper",
    "rho2_ok", "bw_fiedler_lb", "bw_witness", "bw_ub_paper",
    "ramanujan_rho2", "rho2_gap_ratio", "seconds",
]

#: the LPS certification schema (the reference's benchmarks/lps_bench.py)
RAMANUJAN_COLUMNS = [
    "topology", "spec", "nodes", "radix", "bipartite", "backend", "lambda",
    "ramanujan_bound", "is_ramanujan", "diameter", "alon_milman_diam_ub",
    "seconds",
]


#: resilience columns appended automatically when ``survey(faults=...)``
FAULT_COLUMNS = [
    "fault_model", "fault_rate", "rho2_degraded", "rho2_retention",
    "connectivity_prob", "bw_fiedler_lb_degraded",
]

#: measured path-structure columns appended when ``survey(routing=...)``:
#: exact BFS diameter (hops) + agreement with the registered closed form,
#: the certified diameter lower bound (= diameter when exact; the sampled
#: estimator's guarantee otherwise), average shortest-path length (hops) with
#: its 95% bootstrap CI (degenerate when exact), mean minimal-path count per
#: pair, max directed link load (injection units) and saturation throughput
#: under the configured traffic pattern, and the spectral throughput
#: prediction.  ``routing={"schemes": True}`` additionally fills the
#: routing-scheme comparison: saturation throughput under Valiant load
#: balancing (``thpt_valiant``), UGAL-style adaptive selection
#: (``thpt_ugal``) and k-shortest-path non-minimal ECMP (``thpt_ksp``),
#: the multi-commodity-flow optimal-routing ceiling (``thpt_mcf_ub``, None
#: when scipy is unavailable), and ``thpt_gap_to_opt`` — the best measured
#: scheme as a fraction of that ceiling.
ROUTING_COLUMNS = [
    "diameter_bfs", "diameter_lb", "diameter_ok", "avg_hops", "avg_hops_ci",
    "path_diversity", "traffic_pattern", "max_link_load",
    "saturation_throughput", "throughput_spectral", "thpt_valiant",
    "thpt_ugal", "thpt_ksp", "thpt_mcf_ub", "thpt_gap_to_opt",
]

#: executed-schedule columns appended when ``survey(simulate=...)``: the
#: simulated collective/algorithm and round count, simulated completion time
#: vs the NetworkModel analytic lower bound (ms of the modeled interconnect;
#: ``sim_model_ratio`` = simulated/predicted, ``sim_geq_model`` asserts the
#: bound held), peak link utilization (busy fraction), and the *executed*
#: uniform-workload saturation throughput (injection units — comparable to
#: the static ``saturation_throughput`` of :data:`ROUTING_COLUMNS`).
SIM_COLUMNS = [
    "sim_collective", "sim_algorithm", "sim_rounds", "sim_time_ms",
    "model_time_ms", "sim_model_ratio", "sim_geq_model", "sim_util_max",
    "sim_thpt_uniform",
]


def _closed_form_ok(a: Analysis, tol: float = 1e-6) -> Optional[bool]:
    """Measured rho2 against the registered closed form (None if no form)."""
    cf = a.closed_forms
    if not cf or not ({"rho2_ub", "rho2_lb"} & set(cf)):
        return None
    ok = True
    if "rho2_ub" in cf:
        if cf.get("rho2_exact"):
            ok &= abs(a.rho2 - cf["rho2_ub"]) <= tol * max(1.0, cf["rho2_ub"])
        else:
            ok &= a.rho2 <= cf["rho2_ub"] + tol
    if "rho2_lb" in cf:
        ok &= a.rho2 >= cf["rho2_lb"] - tol
    return bool(ok)


@dataclasses.dataclass
class SurveyResult:
    """Rows + column order, with CSV/JSON emitters.

    ``rows`` hold one dict per surveyed instance (eigenvalues dimensionless,
    diameters in hops, ``seconds`` wall time); ``columns`` fixes the emission
    order.
    """
    rows: List[Dict[str, Any]]
    columns: List[str]

    def __iter__(self):
        return iter(self.rows)

    def __len__(self) -> int:
        return len(self.rows)

    def to_csv(self, path: Optional[str] = None) -> str:
        """Render rows as CSV in column order (quoting comma-bearing cells).

        Args: ``path`` — optional file to write (parents created).
        Returns the CSV text either way.
        """
        text = "\n".join(
            [",".join(self.columns)]
            + [",".join(csv_field(r.get(c)) for c in self.columns)
               for r in self.rows])
        if path is not None:
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)
        return text

    def to_json(self, path: Optional[str] = None) -> str:
        """Render rows as a JSON array (numpy scalars/arrays coerced).

        Args: ``path`` — optional file to write (parents created).
        Returns the JSON text either way.
        """
        text = json.dumps(self.rows, indent=2, default=_json_default)
        if path is not None:
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)
        return text


def _json_default(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not JSON-serializable: {type(x)}")


def _as_analysis(spec: Union[str, Topology, Analysis], **kwargs) -> Analysis:
    if isinstance(spec, Analysis):
        return spec
    if isinstance(spec, Topology):
        return Analysis(spec, **kwargs)
    return Analysis(REGISTRY.build(spec, device=kwargs["device"]), **kwargs)


def _batch_lanczos_rho2(analyses: Sequence[Analysis]) -> Dict[int, float]:
    """Solve same-shape Lanczos-backend instances in one batched call each.

    Groups by (device, n, gather-table width, iters, seed); groups of >= 2
    regular, non-bipartite graphs share a single ``rho2_lanczos_batched``
    solve (the (B, n, k) form of the spmv kernel) whose results pre-populate
    each Analysis's rho2 cache.  Everything else falls back to the
    per-instance path on first access.  Returns each batched analysis's share
    of its group's solve time (id(a) -> seconds) so row timings stay honest.
    """
    groups: Dict[tuple, List[Analysis]] = {}
    for a in analyses:
        if a.backend != "lanczos" or "rho2" in a.__dict__:
            continue
        if a.topo.meta.get("bipartite") or a.radix is None:
            continue
        deg = np.bincount(a.topo.edges.reshape(-1), minlength=a.n)
        key = (str(a.device), a.n, int(deg.max()), a.lanczos_iters, a.seed)
        groups.setdefault(key, []).append(a)
    shares: Dict[int, float] = {}
    for (_, n, width, iters, seed), grp in groups.items():
        if len(grp) < 2:
            continue
        obs.count("survey/lanczos_groups")
        obs.count("survey/lanczos_grouped_instances", len(grp))
        t0 = time.time()
        vals = S.rho2_lanczos_batched([a.topo for a in grp], iters=iters,
                                      seed=seed, device=grp[0].device)
        share = (time.time() - t0) / len(grp)
        for a, v in zip(grp, vals):
            a.__dict__["rho2"] = v      # pre-populate the cached_property
            shares[id(a)] = share
    return shares


def _fault_config(faults: Union[float, Dict[str, Any]]) -> Dict[str, Any]:
    cfg = dict(rate=float(faults)) if isinstance(faults, (int, float)) \
        else dict(faults)
    cfg.setdefault("rate", 0.05)
    cfg.setdefault("model", "link")
    cfg.setdefault("samples", 16)
    return cfg


def _fault_values(a: Analysis, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """One-rate fault sweep for a survey row → the FAULT_COLUMNS values."""
    sweep = a.fault_sweep(rates=[cfg["rate"]], model=cfg["model"],
                          samples=cfg["samples"], seed=cfg.get("seed"))
    r = sweep.rows[0]
    return dict(
        fault_model=cfg["model"],
        fault_rate=cfg["rate"],
        rho2_degraded=_round(r["rho2_mean"]),
        rho2_retention=None if r["rho2_retention"] is None
            else _round(r["rho2_retention"], 4),
        connectivity_prob=r["connectivity_prob"],
        bw_fiedler_lb_degraded=_round(r["bw_fiedler_lb_mean"], 2),
    )


def _routing_config(routing: Union[bool, Dict[str, Any]]) -> Dict[str, Any]:
    cfg = {} if routing is True else dict(routing)
    cfg.setdefault("pattern", "uniform")
    cfg.setdefault("sample_fraction", None)   # None = exact all-sources BFS
    cfg.setdefault("seed", None)              # None = the session's seed
    cfg.setdefault("schemes", False)          # fill the thpt_* comparison
    cfg.setdefault("slack", 1)                # ksp detour budget
    cfg.setdefault("groups", None)            # MCF commodity grouping
    return cfg


def _sim_config(simulate: Union[bool, Dict[str, Any]]) -> Dict[str, Any]:
    cfg = {} if simulate is True else dict(simulate)
    cfg.setdefault("collective", "all_reduce")
    cfg.setdefault("algorithm", None)
    cfg.setdefault("payload", float(1 << 26))
    cfg.setdefault("pattern", "uniform")   # None skips the workload column
    if cfg["collective"] == "traffic":
        # the simulated-vs-model columns need a collective the analytic
        # model predicts; the executed workload already has its own column
        raise ValueError(
            "survey(simulate=...): collective='traffic' has no analytic "
            "prediction to validate against — pick a collective (e.g. "
            "'all_reduce') and choose the workload via pattern=")
    return cfg


def _sim_values(a: Analysis, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Executed-schedule quantities for one survey row (SIM_COLUMNS)."""
    sim = a.simulate(cfg["collective"], cfg["algorithm"],
                     payload=cfg["payload"])
    val = a.network_model().validate(sim)
    thpt = None
    if cfg["pattern"]:
        thpt = a.simulate("traffic", pattern=cfg["pattern"],
                          payload=cfg["payload"]).saturation_throughput
    # the largest payload: the same one sim_util_max is accounted at
    row = val["rows"][int(np.argmax(sim.payload_bytes))]
    return dict(
        sim_collective=cfg["collective"],
        sim_algorithm=sim.algorithm,
        sim_rounds=sim.rounds,
        sim_time_ms=_round(row["measured_s"] * 1e3),
        model_time_ms=_round(row["predicted_s"] * 1e3),
        sim_model_ratio=_round(row["ratio"], 4),
        sim_geq_model=val["all_measured_geq_predicted"],
        sim_util_max=_round(sim.utilization_max, 4),
        sim_thpt_uniform=None if thpt is None else _round(thpt, 4),
    )


def _routing_values(a: Analysis, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Measured routing/traffic quantities for one survey row (ROUTING_COLUMNS)."""
    from repro_torch.core.traffic import spectral_throughput_estimate

    r = a.routing(sample_fraction=cfg["sample_fraction"], seed=cfg["seed"])
    t = a.traffic(cfg["pattern"], sample_fraction=cfg["sample_fraction"],
                  seed=cfg["seed"])
    cf = a.closed_forms
    # exact runs assert equality with the closed form; a sampled run can only
    # certify that its lower bound does not exceed it
    diameter_ok = None if not cf or "diameter" not in cf \
        else bool(r.diameter == int(cf["diameter"])) if r.exact \
        else bool(r.diameter_lb <= int(cf["diameter"]))
    schemes: Dict[str, Optional[float]] = dict(
        thpt_valiant=None, thpt_ugal=None, thpt_ksp=None, thpt_mcf_ub=None,
        thpt_gap_to_opt=None)
    if cfg["schemes"]:
        measured = {"minimal": t.saturation_throughput}
        for scheme in ("valiant", "ugal", "ksp"):
            measured[scheme] = a.traffic(
                cfg["pattern"], scheme=scheme, slack=cfg["slack"],
                sample_fraction=cfg["sample_fraction"],
                seed=cfg["seed"]).saturation_throughput
        schemes.update(thpt_valiant=_round(measured["valiant"], 4),
                       thpt_ugal=_round(measured["ugal"], 4),
                       thpt_ksp=_round(measured["ksp"], 4))
        try:
            ub = a.mcf_throughput_ub(cfg["pattern"], groups=cfg["groups"])
        except RuntimeError:     # scipy not installed: no ceiling, no gap
            ub = None
        if ub is not None and np.isfinite(ub) and ub > 0:
            best = max(v for v in measured.values() if np.isfinite(v))
            schemes.update(thpt_mcf_ub=_round(ub, 4),
                           thpt_gap_to_opt=_round(best / ub, 4))
    return dict(
        diameter_bfs=r.diameter,
        diameter_lb=r.diameter_lb,
        diameter_ok=diameter_ok,
        avg_hops=_round(r.avg_path_length, 4),
        avg_hops_ci=[_round(c, 4) for c in r.avg_hops_ci],
        path_diversity=_round(r.path_diversity_mean, 4),
        traffic_pattern=t.pattern,
        max_link_load=_round(t.max_link_load, 4),
        saturation_throughput=_round(t.saturation_throughput, 4),
        throughput_spectral=_round(
            spectral_throughput_estimate(a.n, a.rho2), 4),
        **schemes,
    )


def survey(specs: Sequence[Union[str, Topology, Analysis]],
           columns: Optional[Sequence[str]] = None, *,
           dense_threshold: int = S.DENSE_THRESHOLD,
           lanczos_iters: int = 200, seed: int = 0,
           batch_lanczos: bool = True,
           faults: Optional[Union[float, Dict[str, Any]]] = None,
           routing: Optional[Union[bool, Dict[str, Any]]] = None,
           simulate: Optional[Union[bool, Dict[str, Any]]] = None,
           workload: Optional[Any] = None,
           trace: Union[bool, str, pathlib.Path, None] = None,
           device: Union[str, torch.device, None] = DEFAULT_DEVICE
           ) -> SurveyResult:
    """Uniform spectral survey over many topologies (the paper's Table 1).

    ``specs``: spec strings (``"slimfly(q=13)"``), Topology instances, or
    pre-built Analysis sessions.  ``columns``: names from :data:`COLUMNS`
    (plus ``"seconds"``, filled with per-row wall time); defaults to
    :data:`DEFAULT_COLUMNS`.  Instances with ``n > dense_threshold`` route
    through the Lanczos path on ``device`` automatically (default
    ``"cuda"``; raises without a card unless ``device="cpu"``); same-shape
    groups share one batched solve.

    ``faults``: a fault rate (``faults=0.05``) or config dict
    (``faults=dict(rate=0.1, model="attack_spectral", samples=32)``) runs a
    per-instance fault sweep at that rate on ``device`` and appends the
    resilience columns of :data:`FAULT_COLUMNS` to every row.

    ``routing``: ``True`` or a config dict (``routing=dict(pattern=
    "adversarial")``) runs the measured path-level analysis on ``device`` —
    batched all-sources BFS + minimal-path ECMP link loads under one
    synthetic traffic pattern — appending :data:`ROUTING_COLUMNS` to every
    row (diameters/hops in hops, loads in injection units).  Config keys
    ``sample_fraction`` / ``seed`` switch to the sampled-source estimator
    (``routing=dict(sample_fraction=0.01, seed=0)``): ``diameter_bfs`` is
    then the certified lower bound ``diameter_lb``, ``avg_hops_ci`` its
    bootstrap CI, and traffic loads carry the n/S correction — the
    datacenter-scale path (``sample_fraction=1.0`` reproduces exact).
    ``routing=dict(schemes=True)`` additionally evaluates the non-minimal /
    adaptive routing schemes and the MCF optimal-routing ceiling, filling
    ``thpt_valiant`` / ``thpt_ugal`` / ``thpt_ksp`` / ``thpt_mcf_ub`` /
    ``thpt_gap_to_opt`` (config keys ``slack`` and ``groups`` tune the ksp
    detour budget and MCF commodity grouping).

    ``simulate``: ``True`` or a config dict (``simulate=dict(collective=
    "all_reduce", algorithm="ring", payload=1 << 26, pattern="uniform")``)
    *executes* the collective schedule and the uniform workload on every
    instance's modeled links, appending :data:`SIM_COLUMNS` — simulated
    completion time next to the NetworkModel lower bound, peak link
    utilization, and the executed saturation throughput.

    ``workload``: the reference's training-job plans; not ported yet —
    raises ``NotImplementedError``.

    ``trace``: ``True`` records :mod:`repro_torch.obs` spans for the whole
    survey (build / batched-solve / per-row), readable afterwards via
    ``obs.trace_events()`` / ``obs.metrics_report()``; a path writes the
    Chrome-trace-event ``trace.json`` there on exit (perfetto-loadable).
    """
    if workload is not None:
        raise NotImplementedError(
            "survey(workload=...) needs core/workloads, which is not ported "
            "to repro_torch yet (ROADMAP Queue 1 item 2, core/workloads)")
    dev = resolve_device(device)
    cols = list(columns if columns is not None else DEFAULT_COLUMNS)
    fault_cfg = routing_cfg = sim_cfg = None
    extra = {"seconds"}
    if faults is not None:
        fault_cfg = _fault_config(faults)
        cols += [c for c in FAULT_COLUMNS if c not in cols]
        extra |= set(FAULT_COLUMNS)    # only meaningful with faults=...
    if routing not in (None, False):   # {} is a valid all-defaults config
        routing_cfg = _routing_config(routing)
        cols += [c for c in ROUTING_COLUMNS if c not in cols]
        extra |= set(ROUTING_COLUMNS)  # only meaningful with routing=...
    if simulate not in (None, False):  # {} is a valid all-defaults config
        sim_cfg = _sim_config(simulate)
        cols += [c for c in SIM_COLUMNS if c not in cols]
        extra |= set(SIM_COLUMNS)      # only meaningful with simulate=...
    unknown = [c for c in cols if c not in extra and c not in COLUMNS]
    if unknown:
        raise KeyError(f"unknown survey column(s) {unknown}; available: "
                       f"{sorted(COLUMNS)} + {sorted(extra)}")
    with contextlib.ExitStack() as stack:
        if trace not in (None, False):
            path = None if trace is True else trace
            stack.enter_context(obs.tracing(path))
        analyses, build_secs = [], []
        with obs.span("survey/build", phase="build", specs=len(specs)):
            for s in specs:
                t0 = time.time()
                analyses.append(_as_analysis(
                    s, dense_threshold=dense_threshold,
                    lanczos_iters=lanczos_iters, seed=seed, device=dev))
                build_secs.append(time.time() - t0)
        solve_shares: Dict[int, float] = {}
        if batch_lanczos:
            with obs.span("survey/batched_lanczos", phase="execute"):
                solve_shares = _batch_lanczos_rho2(analyses)
        rows = []
        for a, built in zip(analyses, build_secs):
            t0 = time.time()
            with obs.span("survey/row", phase="execute", instance=a.name,
                          family=a.family or a.name):
                row = {c: COLUMNS[c](a) for c in cols
                       if c != "seconds" and c in COLUMNS}
                if fault_cfg is not None:
                    row.update(_fault_values(a, fault_cfg))
                if routing_cfg is not None:
                    row.update(_routing_values(a, routing_cfg))
                if sim_cfg is not None:
                    row.update(_sim_values(a, sim_cfg))
            if "seconds" in cols:
                # construction + (amortized) batched solve + lazy evaluation
                row["seconds"] = round(
                    built + solve_shares.get(id(a), 0.0) + time.time() - t0, 2)
            rows.append(row)
    return SurveyResult(rows=rows, columns=cols)
