"""Host-side span recording and its chrome://tracing export.

The port of `mxnet_tpu.telemetry.trace`. Spans are recorded on the host
into a bounded ring (the device timeline belongs to `torch.profiler`;
these spans cover what it cannot name: serving steps, program calls,
request phases, stalls) and written as complete-duration ("ph": "X")
trace events, with the counters appended as chrome counter ("ph": "C")
samples. Load a dump at chrome://tracing or https://ui.perfetto.dev.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["TraceBuffer", "write_chrome_trace"]

MAX_EVENTS = 100000


class TraceBuffer:
    """Bounded ring of (name, cat, ts_s, dur_s, tid) span records on one
    session epoch."""

    def __init__(self, maxlen=MAX_EVENTS):
        self._events = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self.epoch_unix = time.time()

    def now(self):
        return time.perf_counter() - self._epoch

    def add(self, name, cat, ts_s, dur_s, tid=None):
        """Append one span; `tid` (the chrome row) defaults to the
        recording thread, per-request rows pass their own."""
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            self._events.append((name, cat, ts_s, dur_s, tid))

    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()


def write_chrome_trace(path, buffer, registry=None, process_name="mxnet_tpu",
                       rank=0, trace_id=None):
    """Write the span buffer (and the current counter values) as a
    chrome://tracing JSON file stamped with `rank` (the chrome pid) and
    the run's trace id; returns the event count."""
    rank = int(rank or 0)
    events = [{"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
               "args": {"name": "%s rank %d" % (process_name, rank)}}]
    last_ts = 0.0
    for name, cat, ts_s, dur_s, tid in buffer.events():
        ts_us = ts_s * 1e6
        events.append({"name": name, "cat": cat, "ph": "X", "ts": ts_us,
                       "dur": dur_s * 1e6, "pid": rank, "tid": tid})
        last_ts = max(last_ts, ts_us)
    if registry is not None:
        for name, value in registry.snapshot()["counters"].items():
            events.append({"name": name, "cat": "counter", "ph": "C",
                           "ts": last_ts, "pid": rank,
                           "args": {"value": value}})
    payload = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": {"rank": rank, "trace_id": trace_id,
                            "epoch_unix": buffer.epoch_unix}}
    with open(path, "w") as f:
        json.dump(payload, f)
    return len(events)
