"""Runtime telemetry of the port: metrics, spans, the flight recorder,
per-request traces and the memory ledger.

The port of the parts of `mxnet_tpu.telemetry` that the serving and
resilience planes use, under the same metric names (``serve.tokens``,
``serve.prefill_chunks``, ``serve.kv.blocks_in_use``, ``serve.prefix.*``,
``serve.spec.*``, ``serve.ttft_ms``, ``resilience.stalls``, ...):

* the metric registry (`metrics.py`): counters, gauges with a
  high-watermark, histograms with exact p50/p99 (`inc`, `set_gauge`,
  `observe`, `counter_value`, `snapshot`);
* host spans on one session clock (`trace.py`: `span`, `record_span`,
  `span_clock`, `span_events`, `dump_trace` writes chrome://tracing JSON);
* the compile ring (`note_compile`, `recent_compiles`): what was last
  built, for stall post-mortems;
* the step plane: `step_event(site, ms, info)` runs the step-time
  anomaly detector (`anomaly.py`: rolling-median spikes, the step SLO,
  `step_quantiles`), appends a flight-recorder record (`flight.py`) with
  the step's counter deltas, what fired and the caller's info (the
  serving scheduler's active/completed request ids), and runs the
  ledger's rate-limited reconcile;
* `request_trace.py`: one `RequestTrace` per served request, whose spans
  tile its wall clock (`request_traces()` reads the last-N ring);
* `ledger.py`: device memory by scope (``kv_pool``, ``kv_draft``,
  ``prefix_cache``, ...), reconciled against `torch.cuda.memory_allocated`.

Gating: ``MXNET_TPU_TELEMETRY=0`` or `disable()` turns every call into one
global check. Not ported yet: the HTTP exporter, aggregation across ranks,
step attribution, federation and the profiling hooks.
"""
from __future__ import annotations

import os
import threading
import uuid

from .metrics import Counter, Gauge, Histogram, Registry
from .trace import TraceBuffer, write_chrome_trace

__all__ = ["enable", "disable", "registry", "inc", "set_gauge",
           "observe", "counter_value",
           "span", "record_span", "span_clock", "span_events", "snapshot",
           "reset", "dump_trace", "note_compile", "recent_compiles",
           "device_report", "memory_scopes", "trace_id", "safe_rank",
           "step_event", "step_quantiles", "flight_records", "request_traces", "Counter",
           "Gauge", "Histogram", "Registry"]

# the only state instrumented code reads on the disabled path
ENABLED = os.environ.get("MXNET_TPU_TELEMETRY", "1").lower() not in (
    "0", "false", "off")

registry = Registry()
_trace = TraceBuffer()


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


# ---------------------------------------------------------------- metrics
def inc(name, n=1):
    """Increment a counter; no-op (and no metric made) when disabled."""
    if not ENABLED:
        return 0
    return registry.counter(name).inc(n)


def set_gauge(name, value):
    if ENABLED:
        registry.gauge(name).set(value)


def observe(name, value):
    if ENABLED:
        registry.histogram(name).observe(value)


def counter_value(name):
    metric = registry.get(name)
    return metric.value if isinstance(metric, Counter) else 0


# ---------------------------------------------------------------- spans
class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "_t0")

    def __init__(self, name, cat):
        self.name = name
        self.cat = cat
        self._t0 = None

    def __enter__(self):
        self._t0 = _trace.now()
        return self

    def __exit__(self, *exc):
        _trace.add(self.name, self.cat, self._t0, _trace.now() - self._t0)
        return False


def span(name, cat="host"):
    """Context manager recording one chrome-trace span."""
    if not ENABLED:
        return _NULL_SPAN
    return _Span(name, cat)


def record_span(name, cat, start_s, dur_s, tid=None):
    """Record an already-timed range; `start_s` is on `span_clock()`'s
    epoch, `tid` overrides the chrome row (per-request rows use it)."""
    if ENABLED:
        _trace.add(name, cat, start_s, dur_s, tid=tid)


def span_clock():
    """Now, on the span buffer's epoch (seconds)."""
    return _trace.now()


def span_events(limit=None):
    """Recorded spans as (name, cat, ts_s, dur_s, tid), oldest first;
    `limit` keeps the newest N."""
    events = _trace.events()
    if limit is not None and len(events) > limit:
        events = events[-limit:]
    return events


# ---------------------------------------------------------------- identity
_RUN_LOCK = threading.Lock()
_RUN = {"trace_id": None}


def trace_id():
    """The run-wide trace id (drawn once, stable for the process)."""
    with _RUN_LOCK:
        if _RUN["trace_id"] is None:
            _RUN["trace_id"] = uuid.uuid4().hex[:16]
        return _RUN["trace_id"]


def safe_rank():
    """This worker's rank from the launcher's environment (``RANK``, then
    ``DMLC_WORKER_ID``; 0 when neither is set)."""
    try:
        return int(os.environ.get("RANK")
                   or os.environ.get("DMLC_WORKER_ID") or 0)
    except ValueError:
        return 0


# ---------------------------------------------------------------- compiles
_COMPILE_RING_LIMIT = 32
_compiles = []
_compiles_lock = threading.Lock()


def note_compile(name):
    """Record that `name` was just built (a kernel, a program); surfaces
    in `recent_compiles()` and in stall post-mortems."""
    if not ENABLED:
        return
    ts = _trace.now()
    with _compiles_lock:
        _compiles.append((str(name), ts))
        del _compiles[:-_COMPILE_RING_LIMIT]


def recent_compiles(limit=None):
    """The newest builds as (name, ts_s), oldest first."""
    with _compiles_lock:
        events = list(_compiles)
    if limit is not None and len(events) > limit:
        events = events[-limit:]
    return events


# ---------------------------------------------------------------- memory
def device_report():
    """Per-card allocator state for post-mortems (bytes allocated, the
    peak, bytes reserved); [] without an initialised CUDA runtime."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [{"device": "cuda:%d" % i,
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
             "bytes_reserved": torch.cuda.memory_reserved(i)}
            for i in range(torch.cuda.device_count())]


def memory_scopes():
    """The memory ledger's {scope: bytes} ({} when it is off)."""
    from . import ledger as _ledger
    return _ledger.scopes()


# ---------------------------------------------------------------- export
def snapshot():
    """{"counters": {name: n}, "gauges": {name: {"value", "max"}},
    "histograms": {name: {"count", "sum", "min", "max", "avg", "p50",
    "p99"}}}"""
    return registry.snapshot()


def reset():
    """Drop every metric, span, compile record, flight record, request
    trace, ledger scope and anomaly window (does not change ENABLED)."""
    from . import anomaly as _anomaly
    from . import flight as _flight, ledger as _ledger
    from . import request_trace as _reqtrace
    registry.reset()
    _anomaly.reset()
    _trace.clear()
    with _compiles_lock:
        del _compiles[:]
    _flight.reset()
    _reqtrace.reset()
    _ledger.reset()


def dump_trace(path=None):
    """Write the recorded spans and counters as chrome://tracing JSON
    (default: telemetry_trace.json in the working directory); returns the
    path."""
    path = path or "telemetry_trace.json"
    write_chrome_trace(path, _trace, registry, rank=safe_rank(),
                       trace_id=trace_id())
    return path


# ---------------------------------------------------------------- step plane
def step_event(site, dur_ms, info=None):
    """One call per training or serving step: runs anomaly detection over
    the duration, appends a flight record with this step's counter
    deltas, the anomalies that fired and `info` (a small JSON-able dict,
    e.g. the serving scheduler's active/completed request ids), and runs
    the ledger's rate-limited reconcile. No-op when disabled."""
    if not ENABLED:
        return
    from . import anomaly as _anomaly
    from . import flight as _flight, ledger as _ledger
    fired = _anomaly.observe(site, dur_ms)
    extras = dict(info) if info else {}
    if fired:
        extras["anomalies"] = fired
    _flight.record_step(site, dur_ms, extras=extras or None)
    _ledger.maybe_reconcile()


def step_quantiles(site=None):
    """Rolling p50/p99 step-time quantiles: one site's dict, or {site:
    dict} for every site when `site` is None."""
    from . import anomaly as _anomaly
    if site is not None:
        return _anomaly.quantiles(site)
    return _anomaly.quantiles_all()


def flight_records(limit=None):
    """The flight recorder's step records, oldest first."""
    from . import flight as _flight
    return _flight.records(limit=limit)


def request_traces(limit=None):
    """Completed per-request trace payloads, oldest first."""
    from . import request_trace as _reqtrace
    return _reqtrace.records(limit=limit)
