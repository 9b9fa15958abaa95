"""Proactive preemption notices: SIGTERM and a maintenance-event poller
(the port of `mxnet_tpu.resilience.preempt`).

Restore-and-replay after a `PreemptionError` throws away every step since
the last periodic snapshot. Most preemptions are announced: the fleet
manager sends SIGTERM with a grace window, or a metadata server reports a
pending maintenance event. This module turns such an announcement into a
`PreemptionNotice` that `ResilientRunner` reads at the next step
boundary: it checkpoints at once (an off-cadence, coordinated save) and
then lets the preemption take the host, so a resume replays no step.

Two optional sources:

* **SIGTERM**: ``listener.start()`` installs a handler (on the main
  thread only: Python delivers signals there; elsewhere the listener
  polls only) that records the notice and chains to the previous handler.
* **maintenance poller**: a daemon thread calls ``poll_fn()`` every
  ``MXNET_TPU_PREEMPT_POLL_S`` seconds (default 5). `default_poll`
  consults the fault plan first (an ``MXNET_TPU_FAULT_PLAN`` entry at
  site ``preempt.poll`` of kind ``preempt`` is a maintenance event, so
  every proactive path runs in a test), then, when
  ``MXNET_TPU_PREEMPT_METADATA_URL`` is set, GETs it with a short timeout
  and reads any body other than ``NONE`` as a pending event. Other
  fabrics pass their own ``poll_fn``.

The grace window is ``MXNET_TPU_PREEMPT_GRACE_S`` (default 30 s).
Telemetry: ``resilience.preempt.notices`` (and per source).
"""
from __future__ import annotations

import logging
import os
import signal
import threading
import time

__all__ = ["PreemptionNotice", "PreemptionListener", "default_poll",
           "default_poll_interval_s", "default_grace_s", "POLL_SITE"]

_LOG = logging.getLogger("mxnet_tpu_torch.resilience")

# the fault-injection site the default poller consults: a plan entry
# "preempt.poll:preempt:N" makes the Nth poll observe a maintenance event
POLL_SITE = "preempt.poll"


def default_poll_interval_s():
    try:
        return float(os.environ.get("MXNET_TPU_PREEMPT_POLL_S", "5"))
    except (TypeError, ValueError):
        return 5.0


def default_grace_s():
    """The announced grace window: how long after the notice the host is
    expected to survive (``MXNET_TPU_PREEMPT_GRACE_S``, default 30 s)."""
    try:
        return float(os.environ.get("MXNET_TPU_PREEMPT_GRACE_S", "30"))
    except (TypeError, ValueError):
        return 30.0


class PreemptionNotice:
    """One pending preemption announcement, with the hard deadline it
    implies (`received_at + grace`) — the runner budgets its proactive
    checkpoint against `remaining_s()`."""

    __slots__ = ("reason", "source", "received_at", "deadline")

    def __init__(self, reason, source, grace_s=None):
        self.reason = reason
        self.source = source          # "sigterm" | "poll" | custom
        self.received_at = time.time()
        if grace_s is None:
            grace_s = default_grace_s()
        self.deadline = self.received_at + float(grace_s)

    def remaining_s(self):
        """Seconds left in the announced grace window (can go negative)."""
        return self.deadline - time.time()

    def __repr__(self):
        return "PreemptionNotice(%r, source=%r)" % (self.reason, self.source)


def _poll_metadata(url):
    """GET the maintenance-event URL: any body other than NONE means the
    host is going away. A short timeout: a slow metadata server must not
    stall the poll thread's cadence."""
    import urllib.request
    req = urllib.request.Request(url, headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(req, timeout=2.0) as resp:
        body = resp.read().decode("utf-8", "replace").strip()
    if body and body.upper() != "NONE":
        return body
    return None


def default_poll():
    """The pluggable poller's default: fault plan first (deterministic
    tests), then the metadata server when configured. Returns a reason
    string when a maintenance event is pending, else None."""
    from . import faults
    from .errors import PreemptionError
    try:
        faults.check(POLL_SITE)
    except PreemptionError as exc:
        return str(exc)
    url = os.environ.get("MXNET_TPU_PREEMPT_METADATA_URL")
    if url:
        try:
            return _poll_metadata(url)
        except Exception as exc:  # noqa: BLE001 - metadata flakiness is not
            # a preemption; keep polling
            _LOG.debug("preempt: metadata poll failed: %s", exc)
    return None


class PreemptionListener:
    """Collects preemption notices from SIGTERM and a maintenance poller.

    Usage (the runner does this when handed a listener)::

        listener = PreemptionListener()
        listener.start()
        ...
        notice = listener.pending()    # at each step boundary
        ...
        listener.stop()

    Thread model: `notify`/`pending`/`clear` serialize on one lock; the
    poll thread and a signal handler may race a main-thread reader.
    """

    def __init__(self, poll_fn=None, poll_interval_s=None, sigterm=True,
                 on_notice=None, grace_s=None):
        # poll_fn: None = the default (fault plan + metadata server),
        # False = signal-only listener, callable = custom fabric
        if poll_fn is None:
            poll_fn = default_poll
        elif poll_fn is False:
            poll_fn = None
        self._poll_fn = poll_fn
        self.grace_s = (default_grace_s() if grace_s is None
                        else float(grace_s))
        self._poll_interval_s = (default_poll_interval_s()
                                 if poll_interval_s is None
                                 else float(poll_interval_s))
        self._sigterm = sigterm
        self._on_notice = on_notice
        self._lock = threading.Lock()
        self._notice = None
        # set by the SIGTERM handler WITHOUT locks or telemetry (signal
        # handlers run on the main thread between bytecodes — taking
        # self._lock there deadlocks if the interrupted frame holds it);
        # pending() and the poll thread fold it into a real notice from
        # normal context
        self._sig_reason = None
        self._stop_event = threading.Event()
        self._thread = None
        self._prev_handler = None
        self._installed = False

    # ------------------------------------------------------------------
    def start(self):
        """Install the SIGTERM handler (main thread only) and start the
        poll thread. Idempotent."""
        if self._sigterm and not self._installed:
            try:
                self._prev_handler = signal.signal(
                    signal.SIGTERM, self._handle_sigterm)
                self._installed = True
            except ValueError:
                # not the main thread: poller-only mode
                _LOG.debug("preempt: SIGTERM handler skipped (not main "
                           "thread)")
        if self._poll_fn is not None and (
                self._thread is None or not self._thread.is_alive()):
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._poll_loop, name="mxnet_tpu_torch_preempt_poll",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Stop polling and restore the previous SIGTERM handler."""
        self._stop_event.set()
        thread = self._thread
        if thread is not None and thread.is_alive() and \
                thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self._thread = None
        if self._installed:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler
                              if self._prev_handler is not None
                              else signal.SIG_DFL)
            except ValueError:  # pragma: no cover - stop() off-main-thread
                pass
            self._installed = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------------
    def notify(self, reason, source):
        """Record a notice (first one wins; later sources are counted but
        do not overwrite the original deadline)."""
        from .. import telemetry as _telem
        _telem.inc("resilience.preempt.notices")
        _telem.inc("resilience.preempt.notices.%s" % source)
        with self._lock:
            if self._notice is not None:
                return self._notice
            notice = PreemptionNotice(reason, source, grace_s=self.grace_s)
            self._notice = notice
        _LOG.warning("preempt: %s notice — %s (checkpointing at the next "
                     "step boundary)", source, reason)
        if self._on_notice is not None:
            try:
                self._on_notice(notice)
            except Exception:  # noqa: BLE001 - callbacks must not kill us
                pass
        return notice

    def pending(self):
        self._fold_signal()
        with self._lock:
            return self._notice

    def clear(self):
        with self._lock:
            notice, self._notice = self._notice, None
        return notice

    def _fold_signal(self):
        """Convert a signal-context flag into a real notice from normal
        context (where locks and telemetry are safe)."""
        reason, self._sig_reason = self._sig_reason, None
        if reason is not None:
            self.notify(reason, "sigterm")

    # ------------------------------------------------------------------
    def _handle_sigterm(self, signum, frame):
        # signal context: a single attribute store only (atomic under the
        # GIL) — no locks, no telemetry, both of which could be held by
        # the very frame this handler interrupted
        self._sig_reason = "SIGTERM received"
        prev = self._prev_handler
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    def _poll_loop(self):
        while not self._stop_event.is_set():
            if self.pending() is not None:  # also folds a SIGTERM flag
                return  # one notice is terminal; the host is going away
            try:
                reason = self._poll_fn()
            except Exception as exc:  # noqa: BLE001 - a poller bug must not
                # kill the listener thread
                _LOG.debug("preempt: poll_fn raised: %s", exc)
                reason = None
            if reason:
                self.notify(str(reason), "poll")
                return  # one notice is terminal; the host is going away
            self._stop_event.wait(self._poll_interval_s)
