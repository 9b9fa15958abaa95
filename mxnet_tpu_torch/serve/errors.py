"""Structured serving errors: load-shedding and deadline misses.

A serving runtime under pressure fails *requests*, never the process: an
exhausted KV pool or a full queue answers with a structured `Overloaded`
(carrying enough state for the client to back off) instead of running
into an out-of-memory error, and a request that cannot meet its deadline
is shed with `DeadlineExceeded` (carrying whatever tokens it produced).
"""
from __future__ import annotations

from ..resilience.errors import ResilienceError

__all__ = ["ServeError", "Overloaded", "DeadlineExceeded"]


class ServeError(ResilienceError):
    """Base class of every error raised by mxnet_tpu_torch.serve."""


class Overloaded(ServeError):
    """Graceful load-shed: the runtime cannot admit this request right now.

    reason: ``queue_full`` (admission queue at capacity), ``kv_exhausted``
    (the paged KV pool cannot hold the request's worst-case context), or
    ``too_large`` (the request can NEVER fit; retrying is pointless).
    ``ledger_breakdown`` ({scope: bytes} from the memory ledger, on
    ``kv_exhausted``) names whose bytes crowded the pool out.
    """

    def __init__(self, message, reason=None, queue_depth=None,
                 kv_free_blocks=None, kv_needed_blocks=None,
                 retry_after_s=None, ledger_breakdown=None):
        super().__init__(message)
        self.reason = reason
        self.queue_depth = queue_depth
        self.kv_free_blocks = kv_free_blocks
        self.kv_needed_blocks = kv_needed_blocks
        self.retry_after_s = retry_after_s
        self.ledger_breakdown = (dict(ledger_breakdown)
                                 if ledger_breakdown else None)


class DeadlineExceeded(ServeError):
    """The request's deadline passed — in the queue (no tokens) or
    mid-stream (`tokens` carries the partial output). `request_trace`
    carries the request's own timeline (the `RequestTrace` payload)."""

    def __init__(self, message, tokens=None, request_trace=None):
        super().__init__(message)
        self.tokens = list(tokens or [])
        self.request_trace = request_trace
