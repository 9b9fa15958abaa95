"""Retry policy: exponential backoff, jitter and per-op deadlines.

The port of `mxnet_tpu.resilience.retry`. `call_with_retry` reruns a
call that failed with a transient error (`errors.classify`); deterministic
failures are re-raised on the first attempt. The serving scheduler takes
each request's default replica-fault budget from
`RetryPolicy().max_attempts`.

Env knobs (read when a policy is made):

``MXNET_TPU_RETRIES``        max attempts per op (default 3; 1 = no retry)
``MXNET_TPU_RETRY_BASE_S``   first backoff delay (default 0.05 s)
``MXNET_TPU_RETRY_MAX_S``    backoff ceiling (default 2 s)

Telemetry: ``resilience.retries`` (and ``resilience.retries.<site>``) per
retried attempt; ``resilience.retry_exhausted`` and a `RetryExhausted`
carrying the site, attempt count and last cause when the budget is spent.
"""
from __future__ import annotations

import functools
import os
import random as _pyrandom
import time

from .errors import DivergenceError, RetryExhausted, classify

__all__ = ["RetryPolicy", "call_with_retry", "retriable", "default_policy"]


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class RetryPolicy:
    """How many times, how far apart, and for how long in total.

    jitter: each delay is multiplied by a uniform draw from
    [1 - jitter, 1 + jitter], so workers do not retry in lockstep.
    deadline_s: wall-clock budget over all attempts of one op.
    """

    def __init__(self, max_attempts=None, base_delay_s=None, max_delay_s=None,
                 jitter=0.25, deadline_s=None):
        if max_attempts is None:
            max_attempts = int(_env_float("MXNET_TPU_RETRIES", 3))
        if base_delay_s is None:
            base_delay_s = _env_float("MXNET_TPU_RETRY_BASE_S", 0.05)
        if max_delay_s is None:
            max_delay_s = _env_float("MXNET_TPU_RETRY_MAX_S", 2.0)
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s

    def delay(self, attempt):
        """Backoff after failed attempt number `attempt` (1-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (2.0 ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * _pyrandom.random() - 1.0)
        return max(0.0, d)

    def __repr__(self):
        return ("RetryPolicy(max_attempts=%d, base=%gs, max=%gs, "
                "jitter=%g, deadline=%s)"
                % (self.max_attempts, self.base_delay_s, self.max_delay_s,
                   self.jitter, self.deadline_s))


def default_policy():
    return RetryPolicy()


def call_with_retry(fn, *args, site="op", policy=None, context=None,
                    on_retry=None, retry_on=None, **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying transient failures.

    site: telemetry label; context: folded into the error message;
    on_retry: ``(attempt, exc)`` callback before each backoff; retry_on:
    predicate narrowing which retriable errors retry in place. Fatal
    errors and `DivergenceError` propagate at once; after the last
    attempt (or past ``policy.deadline_s``) `RetryExhausted` chains the
    last cause.
    """
    from .. import telemetry as _telem
    if policy is None:
        policy = RetryPolicy()
    t0 = time.monotonic()
    last = None
    attempt = 0
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — the classifier decides
            if isinstance(exc, DivergenceError):
                # the same inputs diverge again: only a rollback helps
                raise
            if classify(exc) != "retriable":
                raise
            if retry_on is not None and not retry_on(exc):
                raise
            last = exc
            if attempt >= policy.max_attempts:
                break
            delay = policy.delay(attempt)
            if (policy.deadline_s is not None
                    and time.monotonic() + delay - t0 > policy.deadline_s):
                break
            _telem.inc("resilience.retries")
            _telem.inc("resilience.retries.%s" % site)
            if on_retry is not None:
                on_retry(attempt, exc)
            with _telem.span("retry_backoff@%s" % site, "resilience"):
                time.sleep(delay)
    _telem.inc("resilience.retry_exhausted")
    detail = (" [%s]" % context) if context else ""
    raise RetryExhausted(
        "%s%s failed after %d attempt(s) in %.2fs; last error: %s: %s"
        % (site, detail, attempt, time.monotonic() - t0,
           type(last).__name__, last),
        site=site, attempts=attempt, last_error=last) from last


def retriable(site="op", policy=None):
    """Decorator form of `call_with_retry`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return call_with_retry(lambda: fn(*args, **kwargs),
                                   site=site, policy=policy)
        return inner
    return wrap
