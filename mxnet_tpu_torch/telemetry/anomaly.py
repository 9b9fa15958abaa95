"""Step-time anomaly detection: rolling-median spikes and an SLO (the port
of `mxnet_tpu.telemetry.anomaly`).

`telemetry.step_event` feeds every step's duration to the tracker of its
site:

* **spike**: a step longer than ``k x`` the rolling median of the last
  ``MXNET_TPU_ANOMALY_WINDOW`` steps (default 64) of the same site, after
  a warm-up of `WARMUP_STEPS`, increments ``telemetry.anomaly.step_time``
  (and the per-site counter) and records a zero-length ``anomaly@<site>``
  span (category ``anomaly``) beside the spans that explain it.
  ``MXNET_TPU_ANOMALY_FACTOR`` sets k (default 4).
* **SLO**: with ``MXNET_TPU_STEP_SLO_MS`` set, a step over it increments
  ``telemetry.anomaly.slo`` (and the per-site counter).

`quantiles(site)` gives p50/p99 over the window (`telemetry.
step_quantiles`). The integrity sentinel's loss window shares
`default_window` and the warm-up. Everything sits behind the telemetry
gate: `step_event` is a no-op when ``MXNET_TPU_TELEMETRY=0``.
"""
from __future__ import annotations

import os
import threading
from collections import deque

__all__ = ["StepTimeTracker", "observe", "quantiles", "quantiles_all",
           "reset", "default_window", "default_factor", "default_slo_ms"]

# spikes only fire once the window has seen enough steps to trust a median
WARMUP_STEPS = 8


def default_window():
    try:
        return max(WARMUP_STEPS,
                   int(os.environ.get("MXNET_TPU_ANOMALY_WINDOW", "64")))
    except (TypeError, ValueError):
        return 64


def default_factor():
    try:
        return float(os.environ.get("MXNET_TPU_ANOMALY_FACTOR", "4"))
    except (TypeError, ValueError):
        return 4.0


def default_slo_ms():
    raw = os.environ.get("MXNET_TPU_STEP_SLO_MS")
    if not raw:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def _median(sorted_vals):
    n = len(sorted_vals)
    mid = n // 2
    if n % 2:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])


def _quantile(sorted_vals, q):
    """Nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


class StepTimeTracker:
    """Per-site rolling window of step durations with spike/SLO detection."""

    def __init__(self, window=None, factor=None, slo_ms=None):
        self.window = window or default_window()
        self.factor = factor if factor is not None else default_factor()
        self.slo_ms = slo_ms if slo_ms is not None else default_slo_ms()
        self._windows = {}  # site -> deque of recent step durations (ms)
        self._lock = threading.Lock()

    def observe(self, site, dur_ms):
        """Record one step; returns the list of anomaly kinds it fired
        (empty for a normal step). Telemetry counters/spans are emitted by
        the caller-facing module function so the tracker stays pure."""
        dur_ms = float(dur_ms)
        fired = []
        with self._lock:
            win = self._windows.get(site)
            if win is None:
                win = self._windows[site] = deque(maxlen=self.window)
            if len(win) >= WARMUP_STEPS:
                med = _median(sorted(win))
                if med > 0 and dur_ms > self.factor * med:
                    fired.append(("step_time", med))
            if self.slo_ms is not None and dur_ms > self.slo_ms:
                fired.append(("slo", self.slo_ms))
            # the spike joins the window AFTER the check (it must not vote
            # on its own median) — and then raises the baseline, so a
            # genuine regime change stops firing once it IS the new normal
            win.append(dur_ms)
        return fired

    def quantiles(self, site):
        """{"p50", "p99", "n", "last_ms"} over the site's rolling window,
        or None for an unseen site."""
        with self._lock:
            win = self._windows.get(site)
            if not win:
                return None
            vals = sorted(win)
            last = win[-1]
        return {"p50": _quantile(vals, 0.50), "p99": _quantile(vals, 0.99),
                "n": len(vals), "last_ms": last}

    def quantiles_all(self):
        with self._lock:
            sites = list(self._windows)
        out = {}
        for site in sites:
            q = self.quantiles(site)
            if q is not None:
                out[site] = q
        return out

    def reset(self):
        with self._lock:
            self._windows.clear()


_TRACKER = StepTimeTracker()


def observe(site, dur_ms):
    """Module-level entry point (called by `telemetry.step_event`): run the
    tracker and emit the `telemetry.anomaly.*` counters + marker span for
    whatever fired. Returns the fired kinds (for the flight recorder)."""
    from .. import telemetry as _telem
    fired = _TRACKER.observe(site, dur_ms)
    for kind, baseline in fired:
        _telem.inc("telemetry.anomaly.%s" % kind)
        _telem.inc("telemetry.anomaly.%s.%s" % (kind, site))
        # zero-duration marker next to the slow span it indicts
        _telem.record_span("anomaly@%s" % site, "anomaly",
                           _telem.span_clock(), 0.0)
    return [kind for kind, _ in fired]


def quantiles(site):
    return _TRACKER.quantiles(site)


def quantiles_all():
    return _TRACKER.quantiles_all()


def reset():
    """Drop all rolling windows AND re-read the env knobs (tests monkeypatch
    MXNET_TPU_STEP_SLO_MS / _FACTOR / _WINDOW around a reset)."""
    global _TRACKER
    _TRACKER = StepTimeTracker()
