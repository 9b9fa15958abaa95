"""Hang watchdog: deadlines and heartbeats around a step.

The port of `mxnet_tpu.resilience.watchdog`. A step that never completes
becomes a structured `StallError` instead of silence::

    with watchdog.guard("serve.step", deadline_s=2):
        server_step()                   # StallError if it takes > 2 s

One daemon monitor thread tracks every armed guard (one per thread).
When a deadline passes it counts ``resilience.stalls`` (and the per-site
counter), builds the post-mortem — the newest telemetry spans, the cards'
allocator state (probed on a bounded side thread), the newest builds,
the flight-recorder tail and the memory ledger — and raises the
`StallError` asynchronously in the guarded thread through
``PyThreadState_SetAsyncExc``, then calls the guard's ``on_stall``.

What it can interrupt: the asynchronous exception lands only at a Python
bytecode boundary. It ends Python-level waits, such as the cooperative
``hang`` that `resilience.faults` injects (it sleeps in 10 ms ticks for
this reason). It cannot interrupt a thread blocked inside a C call: a
CUDA synchronize, a device-to-host copy or a kernel that never returns
keeps the thread until the call itself returns. The stall is recorded all
the same, and ``guard.__exit__`` raises it the moment the call returns.

``heartbeat()`` pushes the calling thread's deadline forward by its full
span. The default deadline is ``MXNET_TPU_STEP_DEADLINE_S`` (unset: none;
a guard with no deadline does nothing).
"""
from __future__ import annotations

import ctypes
import os
import threading
import time

from .errors import StallError

__all__ = ["Watchdog", "get", "guard", "heartbeat", "default_deadline_s"]


def default_deadline_s():
    val = os.environ.get("MXNET_TPU_STEP_DEADLINE_S")
    if not val:
        return None
    try:
        return float(val)
    except ValueError:
        return None


def _async_raise(tid, exctype):
    """Raise `exctype` in thread `tid` at its next bytecode boundary."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid), ctypes.py_object(exctype))
    if res > 1:  # pragma: no cover - more than one thread state touched
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)


def _async_clear(tid):
    ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)


def _probe_devices(timeout_s=2.0):
    """telemetry.device_report() on a throwaway daemon thread, abandoned
    (empty) past `timeout_s`: the monitor must never block on a wedged
    runtime."""
    from .. import telemetry as _telem
    result = []

    def probe():
        try:
            result.extend(_telem.device_report())
        except Exception:  # noqa: BLE001 - the post-mortem is best-effort
            pass

    t = threading.Thread(target=probe, name="mxnet_tpu_device_probe",
                         daemon=True)
    t.start()
    t.join(timeout_s)
    return [] if t.is_alive() else list(result)


class _AsyncStall(BaseException):
    """Carrier raised asynchronously in the stalled thread; the guard's
    ``__exit__`` turns it into the `StallError` prepared on its entry
    (SetAsyncExc takes only a class). A BaseException, so an ``except
    Exception`` inside the guarded region cannot swallow it."""


class _Entry:
    __slots__ = ("site", "deadline", "deadline_s", "on_stall", "fired",
                 "stall")

    def __init__(self, site, deadline, deadline_s, on_stall):
        self.site = site
        self.deadline = deadline          # absolute monotonic time
        self.deadline_s = deadline_s
        self.on_stall = on_stall
        self.fired = False
        self.stall = None                 # prepared StallError


class Watchdog:
    """The monitor thread and the per-thread guard registry."""

    def __init__(self, poll_floor_s=0.005):
        self._entries = {}  # thread ident -> _Entry
        self._cond = threading.Condition(threading.Lock())
        self._thread = None
        self._poll_floor_s = poll_floor_s

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="mxnet_tpu_watchdog", daemon=True)
            self._thread.start()

    def _loop(self):
        while True:
            with self._cond:
                now = time.monotonic()
                pending = [e.deadline for e in self._entries.values()
                           if not e.fired]
                if not pending:
                    self._cond.wait()     # park until a guard arms
                    continue
                next_deadline = min(pending)
                if next_deadline > now:
                    self._cond.wait(max(self._poll_floor_s,
                                        next_deadline - now))
                    continue
                expired = [(tid, e) for tid, e in self._entries.items()
                           if not e.fired and e.deadline <= now]
                for _, entry in expired:
                    entry.fired = True    # claimed under the lock: once
            # fire outside the lock: the post-mortem and on_stall must not
            # block heartbeat(), disarming or other threads' deadlines
            for tid, entry in expired:
                self._fire(tid, entry)

    def _fire(self, tid, entry):
        from .. import telemetry as _telem
        stall = StallError(
            "watchdog: %r exceeded its %.3gs deadline (no heartbeat) — "
            "raising instead of hanging forever"
            % (entry.site, entry.deadline_s),
            site=entry.site, deadline_s=entry.deadline_s,
            span_dump=_telem.span_events(limit=64),
            device_dump=_probe_devices(timeout_s=2.0),
            compile_dump=_telem.recent_compiles(limit=10),
            flight_dump=_telem.flight_records(limit=32),
            ledger_dump=_telem.memory_scopes())
        with self._cond:
            if self._entries.get(tid) is not entry:
                # the op finished between the claim and now and its guard
                # exited clean: raise into nothing it runs next
                return
            entry.stall = stall
            _async_raise(tid, _AsyncStall)
        _telem.inc("resilience.stalls")
        _telem.inc("resilience.stalls.%s" % entry.site)
        _telem.record_span("stall@%s" % entry.site, "resilience",
                           _telem.span_clock(), 0.0)
        if entry.on_stall is not None:
            try:
                entry.on_stall(stall)
            except Exception:  # noqa: BLE001 - a callback must not kill us
                pass

    def guard(self, site, deadline_s=None, on_stall=None):
        """Context manager arming a deadline for the calling thread."""
        return _Guard(self, site, deadline_s, on_stall)

    def heartbeat(self):
        """Push the calling thread's armed deadline forward by its span."""
        tid = threading.get_ident()
        with self._cond:
            entry = self._entries.get(tid)
            if entry is not None and not entry.fired:
                entry.deadline = time.monotonic() + entry.deadline_s
                self._cond.notify_all()

    def _arm(self, entry):
        tid = threading.get_ident()
        with self._cond:
            if tid in self._entries:
                raise RuntimeError(
                    "watchdog guard already armed for this thread "
                    "(site=%r); nested guards are not supported"
                    % self._entries[tid].site)
            self._entries[tid] = entry
            self._ensure_thread()
            self._cond.notify_all()
        return tid

    def _disarm(self, tid):
        """Remove the thread's entry; returns the prepared StallError when
        the async raise was sent (clearing it if still undelivered)."""
        with self._cond:
            entry = self._entries.pop(tid, None)
            stall = entry.stall if entry is not None else None
            self._cond.notify_all()
        if stall is not None:
            _async_clear(tid)
        return stall


class _Guard:
    def __init__(self, wd, site, deadline_s, on_stall):
        self._wd = wd
        self._site = site
        self._deadline_s = (deadline_s if deadline_s is not None
                            else default_deadline_s())
        self._on_stall = on_stall
        self._tid = None

    def __enter__(self):
        if self._deadline_s is None:
            return self   # no deadline configured: transparent
        entry = _Entry(self._site, time.monotonic() + self._deadline_s,
                       self._deadline_s, self._on_stall)
        self._tid = self._wd._arm(entry)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._tid is None:
            return False
        try:
            stall = self._wd._disarm(self._tid)
        except _AsyncStall:
            # the carrier landed inside __exit__: disarm again for the
            # prepared StallError
            stall = self._wd._disarm(self._tid)
        if stall is not None:
            if exc is not None and not isinstance(exc, _AsyncStall):
                raise stall from exc
            raise stall
        if isinstance(exc, _AsyncStall):
            # a carrier without a recorded stall: never let the internal
            # BaseException escape
            raise StallError(
                "watchdog: %r interrupted (stall record lost)" % self._site,
                site=self._site, deadline_s=self._deadline_s) from exc
        return False


_DEFAULT = Watchdog()


def get():
    return _DEFAULT


def guard(site, deadline_s=None, on_stall=None):
    return _DEFAULT.guard(site, deadline_s=deadline_s, on_stall=on_stall)


def heartbeat():
    _DEFAULT.heartbeat()
