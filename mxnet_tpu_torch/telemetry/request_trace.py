"""Per-request tracing for the serving plane.

The port of `mxnet_tpu.telemetry.request_trace`. A `RequestTrace` is made
at enqueue and rides the request's `StreamHandle` — so it crosses replica
boundaries when a drained stream resumes on a survivor — through admit,
prefill, every decode step and completion (or shed, deadline, recovery),
recording spans on the shared telemetry clock.

The spans TILE the request's wall clock: `mark()` closes the open
interval and advances the cursor, so queue wait + prefill + decode +
recovery account for the whole life but the last mark-to-finish tail.
Span names:

* ``queue``           enqueue (or backpressure re-entry) -> admission pop
* ``prefill``         pop -> first emitted token
* ``decode``          one span per emitted token (the inter-token interval)
* ``recovery.drain``  last activity -> the replica fault that drained it
* ``recovery.queue``  requeue -> re-admission on this or another replica

`finish()` snapshots a JSON-able payload into the last-N ring
(``MXNET_TPU_SERVE_TRACE_RING``, default 128; `telemetry.request_traces`)
and replays the spans into the chrome trace under a per-request row
(``req[<id>].<phase>``, cat ``request``). Inert under
``MXNET_TPU_TELEMETRY=0`` or ``MXNET_TPU_SERVE_TRACE=0``: `start()`
returns the no-op `NULL_TRACE`.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from collections import deque

__all__ = ["RequestTrace", "NullRequestTrace", "NULL_TRACE", "start",
           "records", "reset", "default_ring_size", "default_span_cap",
           "tracing_enabled"]


def default_ring_size():
    try:
        return max(8, int(os.environ.get("MXNET_TPU_SERVE_TRACE_RING",
                                         "128")))
    except (TypeError, ValueError):
        return 128


def default_span_cap():
    """Spans kept per trace; past the cap, marks coalesce into the last
    span (counted) so a long stream cannot balloon the ring."""
    try:
        return max(16, int(os.environ.get("MXNET_TPU_SERVE_TRACE_SPANS",
                                          "512")))
    except (TypeError, ValueError):
        return 512


def tracing_enabled():
    from .. import telemetry as _telem
    return _telem.ENABLED and os.environ.get(
        "MXNET_TPU_SERVE_TRACE", "1").lower() not in ("0", "false", "off")


class NullRequestTrace:
    """The disabled-path trace: every method a no-op."""

    __slots__ = ()
    null = True

    def mark(self, name, **meta):
        return self

    def note_replica(self, name):
        return self

    def note_drain(self, error=None):
        return self

    def finish(self, outcome, **meta):
        return None


NULL_TRACE = NullRequestTrace()


class RequestTrace:
    """One request's span timeline. Single-writer: the replica holding the
    stream owns its trace (ownership moves through the `RequestQueue` with
    the stream); the ring stores the immutable payload `finish()` took."""

    __slots__ = ("request_id", "trace_id", "rank", "t_enqueue",
                 "enqueued_unix", "spans", "replicas", "outcome",
                 "requeues", "_cursor", "_recovering", "_dropped_spans",
                 "_finished", "_cap", "_t_finish")
    null = False

    def __init__(self, request_id):
        from .. import telemetry as _telem
        self.request_id = str(request_id)
        self.trace_id = _telem.trace_id()
        self.rank = _telem.safe_rank()
        self.t_enqueue = _telem.span_clock()
        self.enqueued_unix = time.time()
        self.spans = []            # [name, start_s, dur_s, meta]
        self.replicas = []         # replicas that held the stream, in order
        self.outcome = None
        self.requeues = 0
        self._cursor = self.t_enqueue
        self._recovering = False
        self._dropped_spans = 0
        self._finished = False
        self._cap = default_span_cap()
        self._t_finish = None

    def mark(self, name, **meta):
        """Close [cursor, now] as span `name` and advance the cursor."""
        from .. import telemetry as _telem
        now = _telem.span_clock()
        dur = max(0.0, now - self._cursor)
        if self._recovering and name == "queue":
            # the wait after a drain is recovery time, not admission load
            name = "recovery.queue"
            self._recovering = False
        if len(self.spans) >= self._cap:
            last = self.spans[-1]
            last[2] += dur
            last[3]["coalesced"] = last[3].get("coalesced", 0) + 1
            self._dropped_spans += 1
        else:
            self.spans.append([name, self._cursor, dur, dict(meta)])
        self._cursor = now
        return self

    def note_replica(self, name):
        """Record the replica that now holds the stream."""
        name = str(name)
        if not self.replicas or self.replicas[-1] != name:
            self.replicas.append(name)
        return self

    def note_drain(self, error=None):
        """A replica fault drained this stream: close the open interval as
        ``recovery.drain`` and count the next queue wait as recovery."""
        self.mark("recovery.drain",
                  error=type(error).__name__ if error is not None else None)
        self._recovering = True
        self.requeues += 1
        return self

    def finish(self, outcome, **meta):
        """Terminal event: snapshot the payload into the ring and replay
        the spans as this request's own chrome row. Returns the payload.
        Idempotent: a second call returns the payload again."""
        from .. import telemetry as _telem
        if self._finished:
            return self.to_payload(**meta)
        self._finished = True
        self._t_finish = _telem.span_clock()
        self.outcome = str(outcome)
        payload = self.to_payload(**meta)
        if _telem.ENABLED:
            with _RING_LOCK:
                _RING.append(payload)
            tid = zlib.crc32(self.request_id.encode()) & 0x3fffffff
            for name, start, dur, _meta in self.spans:
                _telem.record_span("req[%s].%s" % (self.request_id, name),
                                   "request", start, dur, tid=tid)
        return payload

    def _phase_ms(self):
        out = {}
        for name, _start, dur, _meta in self.spans:
            key = name.split(".", 1)[0]  # recovery.* folds into recovery
            out[key] = out.get(key, 0.0) + dur * 1e3
        return {k: round(v, 3) for k, v in out.items()}

    def to_payload(self, **meta):
        """JSON-able snapshot: identity, outcome, per-phase totals and the
        spans (starts relative to enqueue, ms)."""
        # wall runs to the finish clock, not the last mark, so a lost tail
        # shows as unaccounted time
        end = self._t_finish if self._t_finish is not None else self._cursor
        payload = {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "rank": self.rank,
            "enqueued_unix": self.enqueued_unix,
            "outcome": self.outcome,
            "replicas": list(self.replicas),
            "requeues": self.requeues,
            "wall_ms": round((end - self.t_enqueue) * 1e3, 3),
            "accounted_ms": round(sum(d for _n, _s, d, _m in self.spans)
                                  * 1e3, 3),
            "phases_ms": self._phase_ms(),
            "spans": [{"name": n, "start_ms": round((s - self.t_enqueue)
                                                    * 1e3, 3),
                       "dur_ms": round(d * 1e3, 3), **m}
                      for n, s, d, m in self.spans],
        }
        if self._dropped_spans:
            payload["coalesced_spans"] = self._dropped_spans
        payload.update(meta)
        return payload


_RING = deque(maxlen=default_ring_size())
_RING_LOCK = threading.Lock()


def start(request_id):
    """A live trace for a new request, or `NULL_TRACE` when tracing is
    off."""
    return RequestTrace(request_id) if tracing_enabled() else NULL_TRACE


def records(limit=None):
    """Completed-request payloads, oldest first."""
    with _RING_LOCK:
        out = list(_RING)
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out


def reset():
    global _RING
    with _RING_LOCK:
        _RING = deque(maxlen=default_ring_size())
