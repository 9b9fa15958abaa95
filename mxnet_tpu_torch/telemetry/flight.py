"""Crash flight recorder: a bounded ring of per-step context that survives
to the post-mortem.

The port of `mxnet_tpu.telemetry.flight`. Counters say how much; a crash
needs what just happened. The recorder keeps the last
``MXNET_TPU_FLIGHT_STEPS`` (default 256) step records — step duration,
the step's counter deltas, builds since the previous record, buffered
events (``serve_shed``, ``serve_recover``, ``serve_replica_death``, ...)
and the caller's extras (the serving scheduler's active and completed
request ids) — fed by `telemetry.step_event`.

The ring surfaces when a run dies: the watchdog embeds its tail in
`StallError` (``format_report()``), and an unhandled exception writes it
to ``MXNET_TPU_FLIGHT_DIR`` (default: the system temp dir) as
``flight_rank<r>_<pid>.json`` through a chained ``sys.excepthook``
(installed on the first record; ``MXNET_TPU_FLIGHT_AUTODUMP=0`` turns it
off; ``MXNET_TPU_FLIGHT_DUMP_AT_EXIT=1`` also dumps at every exit).
Inert under ``MXNET_TPU_TELEMETRY=0``.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "record_step", "note_event", "records", "dump",
           "dump_on_crash", "format_records", "reset", "default_ring_steps"]

# counters whose per-step delta tells the step's story (absent ones are
# skipped, zero deltas dropped)
_DELTA_COUNTERS = (
    "comm.collectives", "kvstore.push_bytes", "kvstore.pull_bytes",
    "train_step.compile", "serve.tokens", "serve.prefill_chunks",
    "serve.spec.accepted", "serve.recoveries", "resilience.retries",
    "resilience.stalls", "resilience.faults_injected",
)

_EVENT_LIMIT = 16     # events buffered between two step records


def default_ring_steps():
    try:
        return max(8, int(os.environ.get("MXNET_TPU_FLIGHT_STEPS", "256")))
    except (TypeError, ValueError):
        return 256


class FlightRecorder:
    """Bounded ring of per-step records plus the between-step event
    inbox."""

    def __init__(self, maxlen=None):
        self._ring = deque(maxlen=maxlen or default_ring_steps())
        self._lock = threading.Lock()
        self._seq = 0
        self._last_counters = {}
        self._last_compile_ts = -1.0
        self._events = []    # (kind, detail, t) since the last record

    def record_step(self, site, dur_ms, extras=None):
        """Append one step record; deltas are against the previous record,
        so the ring reads as a per-step ledger. `extras` merges in
        verbatim."""
        from .. import telemetry as _telem
        if not _telem.ENABLED:
            return None
        record = {"t": time.time(), "site": site,
                  "step_ms": round(float(dur_ms), 3)}
        for key, value in (extras or {}).items():
            record.setdefault(str(key), value)
        with self._lock:
            # counters and the compile ring are read under the recorder
            # lock: two sites recording at once must not interleave a read
            # with another's _last_counters update (negative deltas)
            counters = {}
            for name in _DELTA_COUNTERS:
                metric = _telem.registry.get(name)
                if metric is not None:
                    counters[name] = metric.value
            self._seq += 1
            record["seq"] = self._seq
            deltas = {name: value - self._last_counters.get(name, 0)
                      for name, value in counters.items()
                      if value != self._last_counters.get(name, 0)}
            self._last_counters.update(counters)
            if deltas:
                record["deltas"] = deltas
            compiles = [(n, ts) for n, ts in _telem.recent_compiles()
                        if ts > self._last_compile_ts]
            if compiles:
                record["compiles"] = [n for n, _ in compiles]
                self._last_compile_ts = max(ts for _, ts in compiles)
            if self._events:
                record["events"] = ["%s %s" % (k, d)
                                    for k, d, _ in self._events]
                del self._events[:]
            self._ring.append(record)
        _maybe_install_crash_hook()
        return record

    def note_event(self, kind, detail=""):
        """Buffer an event for the next step record."""
        with self._lock:
            if len(self._events) < _EVENT_LIMIT:
                self._events.append((str(kind), str(detail), time.time()))

    def records(self, limit=None):
        with self._lock:
            out = list(self._ring)
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._last_counters.clear()
            self._last_compile_ts = -1.0
            del self._events[:]
            self._seq = 0

    def dump(self, path=None, reason=None, dir_hint=None):
        """Write the ring (with rank and trace id) as JSON; returns the
        path, or None when the ring is empty. Destination: `path`, else
        ``MXNET_TPU_FLIGHT_DIR``, else `dir_hint`, else the temp dir."""
        import tempfile
        from .. import telemetry as _telem
        recs = self.records()
        if not recs:
            return None
        rank = _telem.safe_rank()
        if path is None:
            path = os.path.join(
                os.environ.get("MXNET_TPU_FLIGHT_DIR") or dir_hint
                or tempfile.gettempdir(),
                "flight_rank%d_%d.json" % (rank, os.getpid()))
        payload = {"rank": rank, "trace_id": _telem.trace_id(),
                   "dumped_at": time.time(), "reason": reason,
                   "records": recs}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


def format_records(recs, limit=10):
    """Render step records as the post-mortem table (newest last)."""
    if not recs:
        return "flight recorder: empty"
    lines = ["flight recorder (last %d of %d steps):"
             % (min(limit, len(recs)), len(recs))]
    for r in recs[-limit:]:
        parts = ["  #%-6d %-12s %8.2f ms" % (r.get("seq", 0),
                                             r.get("site", "?"),
                                             r.get("step_ms", 0.0))]
        deltas = r.get("deltas", {})
        for key, label in (("serve.tokens", "tokens"),
                           ("comm.collectives", "coll"),
                           ("resilience.faults_injected", "faults")):
            if key in deltas:
                parts.append("%s=%s" % (label, deltas[key]))
        if r.get("compiles"):
            parts.append("compiled=%s" % ",".join(r["compiles"]))
        if r.get("events"):
            parts.append("events=[%s]" % "; ".join(r["events"]))
        if r.get("active_requests"):
            # the serving headline: which requests were in flight
            parts.append("active=[%s]" % ",".join(r["active_requests"]))
        if r.get("completed_requests"):
            parts.append("done=[%s]" % ",".join(r["completed_requests"]))
        lines.append(" ".join(parts))
    return "\n".join(lines)


# ---------------------------------------------------------------- module API
_RECORDER = FlightRecorder()
_HOOK_LOCK = threading.Lock()
_HOOK = {"installed": False, "prev": None}


def record_step(site, dur_ms, extras=None):
    return _RECORDER.record_step(site, dur_ms, extras=extras)


def note_event(kind, detail=""):
    from .. import telemetry as _telem
    if _telem.ENABLED:
        _RECORDER.note_event(kind, detail)


def records(limit=None):
    return _RECORDER.records(limit=limit)


def dump(path=None, reason=None, dir_hint=None):
    return _RECORDER.dump(path=path, reason=reason, dir_hint=dir_hint)


def dump_on_crash(reason, dir_hint=None):
    """Best-effort dump for the crash paths: never raises; returns the
    path or None."""
    try:
        return _RECORDER.dump(reason=reason, dir_hint=dir_hint)
    except Exception:  # noqa: BLE001 - a post-mortem must not mask the crash
        return None


def reset():
    _RECORDER.reset()


def _autodump_enabled():
    return os.environ.get("MXNET_TPU_FLIGHT_AUTODUMP", "1").lower() not in (
        "0", "false", "off")


def _crash_excepthook(etype, value, tb):
    path = None
    if _autodump_enabled() and not issubclass(etype, KeyboardInterrupt):
        path = dump_on_crash("unhandled %s: %s" % (etype.__name__, value))
    if path:
        print("mxnet_tpu_torch: flight recorder dumped to %s" % path,
              file=sys.stderr)
    (_HOOK["prev"] or sys.__excepthook__)(etype, value, tb)


def _exit_dump():
    if os.environ.get("MXNET_TPU_FLIGHT_DUMP_AT_EXIT", "").lower() in (
            "1", "true", "on"):
        dump_on_crash("atexit")


def _maybe_install_crash_hook():
    """Chain the excepthook and register the exit dump once, after the
    ring first holds something worth dumping."""
    if _HOOK["installed"]:
        return
    with _HOOK_LOCK:
        if _HOOK["installed"]:
            return
        _HOOK["installed"] = True
        if not _autodump_enabled():
            return
        import atexit
        _HOOK["prev"] = sys.excepthook
        sys.excepthook = _crash_excepthook
        atexit.register(_exit_dump)
