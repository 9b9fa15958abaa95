"""Metric primitives and their registry.

The port of `mxnet_tpu.telemetry.metrics`: a thread-safe get-or-create
store of named counters, gauges and histograms. Counters and gauges are as
in the JAX package. A histogram here keeps every observation, so its
snapshot reports exact p50/p99 beside count/sum/min/max/avg (a serving or
training run observes a few thousand values at most).
"""
from __future__ import annotations

import json
import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]


class Counter:
    """Monotonically increasing count (calls, bytes, cache hits)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self):
        return self._value

    def snapshot(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value with a high-watermark: `set` keeps the max ever
    seen, so transient peaks survive."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._max = 0
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value
            if value > self._max:
                self._max = value

    @property
    def value(self):
        return self._value

    @property
    def max(self):
        return self._max

    def snapshot(self):
        # value and max are a pair: read them under one lock
        with self._lock:
            return {"value": self._value, "max": self._max}


class Histogram:
    """Latency/size distribution that keeps its observations."""

    __slots__ = ("name", "_values", "_lock")

    def __init__(self, name):
        self.name = name
        self._values = []
        self._lock = threading.Lock()

    def observe(self, value):
        with self._lock:
            self._values.append(float(value))

    @property
    def count(self):
        return len(self._values)

    def snapshot(self):
        with self._lock:
            arr = np.asarray(self._values, np.float64)
        if not arr.size:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "avg": None, "p50": None, "p99": None}
        return {"count": int(arr.size), "sum": float(arr.sum()),
                "min": float(arr.min()), "max": float(arr.max()),
                "avg": float(arr.mean()),
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}


class Registry:
    """Thread-safe get-or-create store of named metrics."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name, cls):
        metric = self._metrics.get(name)
        if metric is None:
            with self._lock:
                metric = self._metrics.get(name)
                if metric is None:
                    metric = cls(name)
                    self._metrics[name] = metric
        if not isinstance(metric, cls):
            raise TypeError(
                "telemetry metric %r already registered as %s, requested %s"
                % (name, type(metric).__name__, cls.__name__))
        return metric

    def counter(self, name):
        return self._get_or_create(name, Counter)

    def gauge(self, name):
        return self._get_or_create(name, Gauge)

    def histogram(self, name):
        return self._get_or_create(name, Histogram)

    def get(self, name):
        return self._metrics.get(name)

    def reset(self):
        with self._lock:
            self._metrics.clear()

    def snapshot(self):
        """{"counters": {name: int}, "gauges": {name: {value, max}},
        "histograms": {name: {count, sum, min, max, avg, p50, p99}}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            elif m.count:
                out["histograms"][name] = m.snapshot()
        return out

    def dumps(self, format="table"):
        """The snapshot as JSON or as the profiler's text table (counters,
        then gauges with their high-watermark, then histograms)."""
        if format not in ("table", "json"):
            raise ValueError(
                "telemetry dumps format must be 'table' or 'json', got %r"
                % (format,))
        snap = self.snapshot()
        if format == "json":
            return json.dumps(snap)
        lines = []
        if snap["counters"]:
            lines.append("%-48s %16s" % ("Counter", "Value"))
            for name, v in snap["counters"].items():
                lines.append("%-48s %16d" % (name, v))
        if snap["gauges"]:
            lines.append("%-48s %16s %16s" % ("Gauge", "Value", "Max"))
            for name, g in snap["gauges"].items():
                lines.append("%-48s %16g %16g" % (name, g["value"], g["max"]))
        if snap["histograms"]:
            lines.append("%-48s %10s %12s %12s %12s %12s" %
                         ("Histogram", "Count", "Sum", "Avg", "Min", "Max"))
            for name, h in snap["histograms"].items():
                lines.append("%-48s %10d %12.3f %12.3f %12.3f %12.3f" %
                             (name, h["count"], h["sum"], h["avg"] or 0.0,
                              h["min"] or 0.0, h["max"] or 0.0))
        return "\n".join(lines)
