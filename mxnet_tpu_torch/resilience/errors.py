"""Structured error taxonomy of the resilience and serving planes.

The port of `mxnet_tpu.resilience.errors`. Recovering safely needs
transient faults (worth retrying, draining and resuming) told apart from
deterministic ones (a wrong shape replays the same crash forever).

Hierarchy::

    MXNetError
      ResilienceError                  base of everything raised here
        RetriableError                 safe to retry / drain and resume
          TransportError               flaky endpoint, reset connection
            InjectedFault              raised by resilience.faults
          PreemptionError              host or device preemption
          StallError                   watchdog deadline passed
          DivergenceError              non-finite values or a loss spike
          RetryExhausted               retries spent; carries the last cause
        FatalTrainingError             deterministic: do not retry
          CheckpointCorruptError       every snapshot failed its checksum

`classify(exc)` maps any exception onto "retriable" or "fatal", by type
and then by message (CUDA runtime errors arrive as `RuntimeError`s).
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ResilienceError", "RetriableError", "TransportError",
           "InjectedFault", "PreemptionError", "StallError",
           "DivergenceError", "RetryExhausted", "FatalTrainingError",
           "CheckpointCorruptError", "classify", "is_retriable"]


class ResilienceError(MXNetError):
    """Base class of every error raised by the resilience and serving
    planes."""


class RetriableError(ResilienceError):
    """A fault where retrying (or draining and replaying) can succeed:
    nothing about the program itself is wrong."""


class TransportError(RetriableError):
    """Flaky communication: reset connections, unreachable endpoints,
    transient collective failures."""

    def __init__(self, message, site=None, key=None, attempt=None):
        super().__init__(message)
        self.site = site
        self.key = key
        self.attempt = attempt


class InjectedFault(TransportError):
    """A deterministic fault planted by `resilience.faults`, so recovery
    paths are testable on one card. Behaves exactly like a
    TransportError."""


class PreemptionError(RetriableError):
    """The host (or part of the device set) is going away. Recovery is a
    restore or a drain, not an in-place retry."""


class StallError(RetriableError):
    """A watched operation passed its deadline without a heartbeat.

    Raised by `resilience.watchdog` instead of hanging forever. Carries
    the site, the deadline and a post-mortem: the newest telemetry spans,
    the cards' allocator state, the newest builds, the flight-recorder
    tail and the memory ledger. `format_report()` renders it all."""

    def __init__(self, message, site=None, deadline_s=None, span_dump=None,
                 device_dump=None, compile_dump=None, flight_dump=None,
                 ledger_dump=None):
        super().__init__(message)
        self.site = site
        self.deadline_s = deadline_s
        # (name, cat, ts_s, dur_s, tid) — telemetry.span_events tail
        self.span_dump = list(span_dump or [])
        # per-card dicts — telemetry.device_report()
        self.device_dump = list(device_dump or [])
        # (name, ts_s) — telemetry.recent_compiles()
        self.compile_dump = list(compile_dump or [])
        # per-step dicts — telemetry.flight_records() tail
        self.flight_dump = list(flight_dump or [])
        # {scope: bytes} — telemetry.memory_scopes()
        self.ledger_dump = dict(ledger_dump or {})

    def format_spans(self, limit=20):
        lines = ["recent spans (newest last):"]
        for name, cat, ts_s, dur_s, _tid in self.span_dump[-limit:]:
            lines.append("  %10.3fs %-8s %s (%.3f ms)"
                         % (ts_s, cat, name, dur_s * 1e3))
        return "\n".join(lines)

    def format_devices(self):
        if not self.device_dump:
            return "device state: unavailable"
        lines = ["device state:"]
        for entry in self.device_dump:
            parts = ["  %-8s" % entry.get("device", "?")]
            for key in ("bytes_in_use", "peak_bytes_in_use",
                        "bytes_reserved"):
                if key in entry:
                    parts.append("%s=%s" % (key, entry[key]))
            lines.append(" ".join(parts))
        return "\n".join(lines)

    def format_flight(self, limit=10):
        from ..telemetry.flight import format_records
        return format_records(self.flight_dump, limit=limit)

    def format_ledger(self, top=6):
        if not self.ledger_dump:
            return "memory ledger: unavailable"
        lines = ["memory ledger (top scopes):"]
        for name, val in sorted(self.ledger_dump.items(),
                                key=lambda kv: -abs(kv[1]))[:top]:
            lines.append("  %-14s %d bytes" % (name, val))
        return "\n".join(lines)

    def format_report(self, span_limit=20):
        """The post-mortem: host spans, card state, the ledger, the newest
        builds and the flight-recorder tail."""
        lines = [str(self), "", self.format_spans(limit=span_limit), "",
                 self.format_devices()]
        if self.ledger_dump:
            lines.append(self.format_ledger())
        if self.compile_dump:
            lines.append("last builds (newest last):")
            for name, ts_s in self.compile_dump[-10:]:
                lines.append("  %10.3fs %s" % (ts_s, name))
        lines.append("")
        lines.append(self.format_flight())
        return "\n".join(lines)


class DivergenceError(RetriableError):
    """A non-finite value or a loss spike. Recovery rolls back to the last
    good state and skips the poisoned batch; an in-place retry replays the
    same divergence."""

    def __init__(self, message, step=None, site=None, keys=None,
                 flight_dump=None):
        super().__init__(message)
        self.step = step
        self.site = site
        self.keys = list(keys or [])
        self.flight_dump = list(flight_dump or [])

    def format_flight(self, limit=10):
        from ..telemetry.flight import format_records
        return format_records(self.flight_dump, limit=limit)

    def format_report(self):
        lines = [str(self)]
        if self.keys:
            lines.append("offending keys: %s" % ",".join(
                str(k) for k in self.keys))
        lines.append("")
        lines.append(self.format_flight())
        return "\n".join(lines)


class RetryExhausted(RetriableError):
    """Every attempt a RetryPolicy (or a stream's retry budget) allowed
    failed with a retriable error. Carries the last cause."""

    def __init__(self, message, site=None, attempts=None, last_error=None):
        super().__init__(message)
        self.site = site
        self.attempts = attempts
        self.last_error = last_error


class FatalTrainingError(ResilienceError):
    """Deterministic failure: retrying replays the identical crash, so it
    is surfaced at once."""


class CheckpointCorruptError(FatalTrainingError):
    """Every candidate checkpoint step failed its sha256 verification or
    could not be loaded. A single corrupt step is recoverable (restore
    falls back to the next-oldest one and counts ``checkpoint.corrupt``),
    so this error means the whole retention window is bad."""

    def __init__(self, message, steps_tried=None):
        super().__init__(message)
        self.steps_tried = list(steps_tried or [])


# ---------------------------------------------------------------- classifier
# message markers of transient transport trouble
_TRANSIENT_MARKERS = (
    "unavailable", "deadline_exceeded", "deadline exceeded",
    "connection reset", "connection refused", "connection closed",
    "broken pipe", "socket closed", "timed out", "timeout",
    "preempted", "cancelled", "aborted", "heartbeat",
    "failed to connect", "coordination service",
)

# deterministic-error markers: never retriable, whatever the type
_FATAL_MARKERS = (
    "shape", "dtype", "rank mismatch", "invalid_argument",
    "invalid argument", "not been initialized", "unimplemented",
    "out of memory", "resource_exhausted", "resource exhausted",
)


def classify(exc):
    """"retriable" or "fatal". Resilience types carry their verdict;
    anything else is judged by type, then message. Unknown errors are
    fatal: silently retrying an unclassified crash hides bugs."""
    if isinstance(exc, RetriableError):
        return "retriable"
    if isinstance(exc, FatalTrainingError):
        return "fatal"
    if isinstance(exc, (ConnectionError, BrokenPipeError, TimeoutError,
                        InterruptedError)):
        return "retriable"
    if isinstance(exc, (TypeError, ValueError, KeyError, IndexError,
                        AssertionError, NotImplementedError,
                        ZeroDivisionError, AttributeError)):
        return "fatal"
    msg = str(exc).lower()
    # fatal markers win: "invalid argument: connection ..." must not spin
    if any(m in msg for m in _FATAL_MARKERS):
        return "fatal"
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return "retriable"
    return "fatal"


def is_retriable(exc):
    return classify(exc) == "retriable"
