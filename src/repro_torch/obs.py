"""Zero-dependency tracing + metrics for the PyTorch port (a copy of the
reference package's stdlib-only ``obs`` module, counter names unchanged).

Three primitives, threaded through the ported engines (spectral, survey,
the spmv kernel dispatcher):

* **Spans** — :func:`span` / :func:`traced` record hierarchical wall-time
  intervals with tags and the peak-RSS high-water delta across the span.
  Recording is **off by default** (a disabled span is a shared no-op object);
  :func:`tracing` / :func:`enable` turn it on.  The buffer renders as
  Chrome-trace-event JSON (:func:`write_trace`, loadable in Perfetto /
  ``chrome://tracing``), a text tree (:func:`render_tree`), or an aggregated
  :class:`MetricsReport` (:func:`metrics_report`).  Spans time the host:
  device work launched inside a span is only included once something in the
  span waits for it (the Lanczos solvers do, when they copy alpha/beta to
  the host).
* **Counters** — :func:`count` / :func:`counters` are always on (a dict
  increment under a lock — nanoseconds, never gated on :func:`enabled`).
  The engines maintain the canonical counter namespace:

  - ``jit_trace/<engine>`` — in the JAX reference these count XLA
    (re)traces.  PyTorch runs eagerly and has no trace to count, so the
    port never increments them; the names stay reserved so a consumer of
    both packages reads one namespace.
  - ``spmv/dispatch/<backend>`` — :func:`repro_torch.kernels.spmv.spmv`
    dispatch decisions, one per call (``ref`` or ``cuda``).
  - ``spmv/matvec/<backend>`` — matvec closures created per resolved
    backend (:func:`repro_torch.kernels.spmv.spmv_matvec`).
  - ``lanczos/solves`` / ``lanczos/iters`` /
    ``lanczos/breakdown_truncations`` — host-side Lanczos accounting.
  - ``survey/lanczos_groups`` / ``survey/lanczos_grouped_instances`` — the
    survey's same-shape batching decisions.

  Kernel launches are counted separately, by a plain integer on each kernel
  wrapper (:func:`repro_torch.kernels.spmv.launches`).

Everything here is stdlib-only (``time``/``resource``/``json``/``threading``).
RSS figures use ``getrusage(RUSAGE_SELF).ru_maxrss`` (KiB on Linux): a
*high-water* mark, so a span's ``rss_delta_kb`` reports how much the process
peak grew during the span (0 for work below the current peak), not live heap.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import pathlib
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

try:                                    # Unix; absent on Windows — RSS -> 0
    import resource as _resource
except ImportError:                     # pragma: no cover
    _resource = None

__all__ = [
    "span", "traced", "tracing", "enable", "disable", "enabled",
    "count", "counters", "counter_delta", "reset_counters",
    "trace_events", "reset_spans", "reset", "write_trace", "render_tree",
    "metrics_report", "MetricsReport", "SpanStat", "peak_rss_kb",
]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
_EVENTS: List[Dict[str, Any]] = []      # completed spans, Chrome "X" phase
_ENABLED = False
_T0 = time.perf_counter()               # trace-time origin (ts=0)
_TLS = threading.local()


def peak_rss_kb() -> int:
    """Process peak RSS high-water mark in KiB (0 where unsupported)."""
    if _resource is None:               # pragma: no cover
        return 0
    return int(_resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss)


# --------------------------------------------------------------------------
# counters (always on)
# --------------------------------------------------------------------------

def count(name: str, inc: int = 1) -> None:
    """Increment counter ``name`` by ``inc`` (thread-safe, never gated)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(inc)


def counters(prefix: Optional[str] = None) -> Dict[str, int]:
    """Snapshot of all counters, optionally filtered to a name prefix."""
    with _LOCK:
        snap = dict(_COUNTERS)
    if prefix is None:
        return snap
    return {k: v for k, v in snap.items() if k.startswith(prefix)}


def counter_delta(before: Dict[str, int],
                  prefix: Optional[str] = None) -> Dict[str, int]:
    """Counters that changed since the ``before`` snapshot (non-zero deltas
    only) — the idiom behind every no-retrace assertion::

        before = obs.counters("jit_trace/")
        run_again()
        assert obs.counter_delta(before, "jit_trace/") == {}
    """
    after = counters(prefix)
    keys = set(before) | set(after)
    out = {}
    for k in keys:
        if prefix is not None and not k.startswith(prefix):
            continue
        d = after.get(k, 0) - before.get(k, 0)
        if d:
            out[k] = d
    return out


def reset_counters() -> None:
    with _LOCK:
        _COUNTERS.clear()


# --------------------------------------------------------------------------
# spans (off unless enabled)
# --------------------------------------------------------------------------

def enabled() -> bool:
    """Whether spans are currently being recorded."""
    return _ENABLED


def enable() -> None:
    """Start recording spans (counters are always on regardless)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


class _NullSpan:
    """Shared no-op context — the full cost of a disabled span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "tags", "_t_start", "_rss0", "_depth")

    def __init__(self, name: str, tags: Dict[str, Any]):
        self.name = name
        self.tags = tags

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self._depth = len(stack)
        stack.append(self)
        self._rss0 = peak_rss_kb()
        self._t_start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t_end = time.perf_counter()
        rss1 = peak_rss_kb()
        stack = _TLS.stack
        if stack and stack[-1] is self:
            stack.pop()
        args = dict(self.tags)
        args["rss_delta_kb"] = max(0, rss1 - self._rss0)
        args["depth"] = self._depth
        ev = dict(name=self.name, ph="X", cat=str(self.tags.get("phase", "span")),
                  ts=(self._t_start - _T0) * 1e6,
                  dur=(t_end - self._t_start) * 1e6,
                  pid=1, tid=threading.get_ident() & 0xFFFF, args=args)
        with _LOCK:
            _EVENTS.append(ev)
        return False


def span(name: str, **tags: Any):
    """Context manager recording one hierarchical span.

    ``tags`` are attached verbatim (Chrome-trace ``args``); the reserved tag
    ``phase=`` ("build" / "compile" / "execute") feeds the per-phase wall-time
    breakdown of :func:`metrics_report`.  When recording is disabled this
    returns a shared no-op object — safe on hot paths.
    """
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, tags)


def traced(name: Optional[str] = None, phase: Optional[str] = None,
           **tags: Any) -> Callable:
    """Decorator form of :func:`span` — zero overhead while disabled::

        @obs.traced("routing/analyze", phase="execute")
        def analyze_routing(...): ...
    """
    def deco(fn: Callable) -> Callable:
        label = name or fn.__name__
        static = dict(tags)
        if phase is not None:
            static["phase"] = phase

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _ENABLED:
                return fn(*a, **kw)
            with _Span(label, static):
                return fn(*a, **kw)

        return wrapper

    return deco


@contextlib.contextmanager
def tracing(path: Optional[Union[str, pathlib.Path]] = None):
    """Enable span recording inside the block; optionally write the Chrome
    trace JSON to ``path`` on exit.  Nests: an inner ``tracing()`` inside an
    already-enabled region neither clears the buffer nor disables recording
    on exit (the outermost activation owns both)."""
    global _ENABLED
    prev = _ENABLED
    if not prev:
        reset_spans()
    _ENABLED = True
    try:
        yield
    finally:
        _ENABLED = prev
        if path is not None:
            write_trace(path)


def trace_events() -> List[Dict[str, Any]]:
    """Copy of the recorded span buffer (Chrome trace-event dicts)."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def reset_spans() -> None:
    """Clear the span buffer (counters untouched)."""
    with _LOCK:
        _EVENTS.clear()


def reset() -> None:
    """Clear spans AND counters (test isolation)."""
    reset_spans()
    reset_counters()


def write_trace(path: Union[str, pathlib.Path],
                events: Optional[Iterable[Dict[str, Any]]] = None) -> str:
    """Write the span buffer (or ``events``) as Chrome trace-event JSON
    (``{"traceEvents": [...]}``, ts/dur in microseconds — the format Perfetto
    and ``chrome://tracing`` load directly).  Returns the path written."""
    evs = trace_events() if events is None else list(events)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        dict(traceEvents=evs, displayTimeUnit="ms"), indent=1))
    return str(p)


def render_tree(events: Optional[Iterable[Dict[str, Any]]] = None) -> str:
    """Text rendering of the span hierarchy (indent = nesting depth)::

        survey/row [instance=slimfly(13)]  41.2ms
          spectral/rho2_lanczos  38.9ms  (+12.0MB peak)
    """
    evs = trace_events() if events is None else list(events)
    evs.sort(key=lambda e: e["ts"])
    lines = []
    for e in evs:
        args = e.get("args", {})
        depth = int(args.get("depth", 0))
        tags = {k: v for k, v in args.items()
                if k not in ("depth", "rss_delta_kb")}
        tag_s = (" [" + ", ".join(f"{k}={v}" for k, v in sorted(tags.items()))
                 + "]") if tags else ""
        rss = int(args.get("rss_delta_kb", 0))
        rss_s = f"  (+{rss / 1024:.1f}MB peak)" if rss else ""
        lines.append(f"{'  ' * depth}{e['name']}{tag_s}  "
                     f"{e['dur'] / 1e3:.1f}ms{rss_s}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SpanStat:
    """Aggregate of every recorded span sharing one name."""
    name: str
    calls: int
    total_seconds: float
    max_seconds: float
    rss_delta_kb: int          # summed peak-RSS growth across the spans

    def to_dict(self) -> Dict[str, Any]:
        return dict(name=self.name, calls=self.calls,
                    total_seconds=round(self.total_seconds, 6),
                    max_seconds=round(self.max_seconds, 6),
                    rss_delta_kb=self.rss_delta_kb)


def _interval_union_seconds(intervals: List[tuple]) -> float:
    """Total length of the union of (start, end) intervals — phase seconds
    without double-counting nested same-phase spans."""
    if not intervals:
        return 0.0
    intervals.sort()
    total, cur_lo, cur_hi = 0.0, intervals[0][0], intervals[0][1]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo)


@dataclasses.dataclass
class MetricsReport:
    """Aggregated view of one recording window.

    ``spans`` aggregates by span name; ``phases`` maps each ``phase=`` tag to
    the union-length of its spans' wall intervals (seconds — nested or
    overlapping same-phase spans are not double-counted); ``counters`` is a
    snapshot; ``peak_rss_kb`` the process high-water mark at report time.
    """
    spans: Dict[str, SpanStat]
    phases: Dict[str, float]
    counters: Dict[str, int]
    peak_rss_kb: int

    def to_dict(self) -> Dict[str, Any]:
        return dict(
            spans={k: v.to_dict() for k, v in sorted(self.spans.items())},
            phases={k: round(v, 6) for k, v in sorted(self.phases.items())},
            counters=dict(sorted(self.counters.items())),
            peak_rss_kb=self.peak_rss_kb)

    def report(self) -> str:
        """Compact text block for CLI output."""
        lines = [f"peak RSS        : {self.peak_rss_kb / 2**20:.2f} GiB"]
        if self.phases:
            ph = ", ".join(f"{k} {v:.3f}s" for k, v in sorted(self.phases.items()))
            lines.append(f"phases          : {ph}")
        for st in sorted(self.spans.values(), key=lambda s: -s.total_seconds):
            lines.append(f"  {st.name:32s} x{st.calls:<4d} "
                         f"{st.total_seconds * 1e3:9.1f}ms total, "
                         f"{st.max_seconds * 1e3:8.1f}ms max")
        return "\n".join(lines)


def metrics_report(events: Optional[Iterable[Dict[str, Any]]] = None
                   ) -> MetricsReport:
    """Aggregate the span buffer (or ``events``) into a :class:`MetricsReport`."""
    evs = trace_events() if events is None else list(events)
    spans: Dict[str, SpanStat] = {}
    phase_ivals: Dict[str, List[tuple]] = {}
    for e in evs:
        dur_s = e["dur"] / 1e6
        st = spans.get(e["name"])
        if st is None:
            spans[e["name"]] = SpanStat(e["name"], 1, dur_s, dur_s,
                                        int(e["args"].get("rss_delta_kb", 0)))
        else:
            st.calls += 1
            st.total_seconds += dur_s
            st.max_seconds = max(st.max_seconds, dur_s)
            st.rss_delta_kb += int(e["args"].get("rss_delta_kb", 0))
        phase = e["args"].get("phase")
        if phase is not None:
            phase_ivals.setdefault(str(phase), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    phases = {p: _interval_union_seconds(iv) / 1e6
              for p, iv in phase_ivals.items()}
    return MetricsReport(spans=spans, phases=phases, counters=counters(),
                        peak_rss_kb=peak_rss_kb())
