"""Deterministic fault injection at named call sites.

The port of `mxnet_tpu.resilience.faults`. Every recovery path must be
testable on one card with no luck involved: the instrumented paths call
``faults.check(site)``, and when a plan is active and one of its entries
matches (site, nth call at that site) the fault fires.

Instrumented sites in the port:

``serve.admit``   inference-request admission (`InferenceServer.submit`)
``serve.step``    top of every serving scheduler step, inside the hang
                  watchdog's guard: an ``error`` or ``preempt`` here is the
                  "replica killed mid-stream" drill (in-flight streams
                  drain back to the queue and resume by re-prefill), a
                  ``hang`` the stall drill

Fault kinds:

``error``    raise `InjectedFault` (a TransportError: retriable)
``latency``  sleep `arg` seconds (default 0.05), then continue
``hang``     sleep in small cooperative ticks for `arg` seconds (default
             3600): the ticks give the watchdog's asynchronous
             `StallError` a bytecode boundary to land on
``preempt``  raise `PreemptionError`
``corrupt``  mutate the payload passing a `transform` site: NaN into the
             first float tensor or array, XOR-flipped bytes into a bytes
             blob (a no-op at plain `check` sites)

Plans come from ``MXNET_TPU_FAULT_PLAN`` (read at import) or a context
manager::

    MXNET_TPU_FAULT_PLAN="serve.step:error:3;serve.admit:latency:1:0.05"

    with faults.inject("serve.step:hang:2"):
        ...

Entry grammar: ``site:kind:nth[:arg]`` joined by ``;``. ``nth`` is the
1-based call count at that site, ``N+`` (every call from the Nth on) or
``*`` (every call). With no plan active, ``check()`` is one global read.
"""
from __future__ import annotations

import os
import threading
import time

from .errors import InjectedFault, PreemptionError

__all__ = ["FaultSpec", "FaultPlan", "inject", "activate", "deactivate",
           "active_plan", "check", "transform", "reset_counts",
           "call_count", "HANG_TICK_S", "KINDS"]

KINDS = ("error", "latency", "hang", "preempt", "corrupt")

# cooperative hang granularity: small enough that an async StallError
# lands promptly
HANG_TICK_S = 0.01

# the only state `check` reads when no plan is active
_ACTIVE = None
_LOCK = threading.Lock()


class FaultSpec:
    """One planned fault: (site, kind, nth, arg)."""

    __slots__ = ("site", "kind", "nth", "from_nth_on", "every", "arg")

    def __init__(self, site, kind, nth, arg=None):
        if kind not in KINDS:
            raise ValueError("fault kind must be one of %s, got %r"
                             % (KINDS, kind))
        self.site = site
        self.kind = kind
        nth = str(nth)
        self.every = nth == "*"
        self.from_nth_on = nth.endswith("+")
        self.nth = 0 if self.every else int(nth.rstrip("+"))
        if not self.every and self.nth < 1:
            raise ValueError("fault nth is 1-based, got %r" % (nth,))
        self.arg = arg

    def matches(self, count):
        if self.every:
            return True
        if self.from_nth_on:
            return count >= self.nth
        return count == self.nth

    def __repr__(self):
        nth = "*" if self.every else (
            "%d+" % self.nth if self.from_nth_on else str(self.nth))
        core = "%s:%s:%s" % (self.site, self.kind, nth)
        return core if self.arg is None else "%s:%g" % (core, self.arg)


class FaultPlan:
    """An ordered set of FaultSpecs plus per-site call counters; the first
    matching spec fires."""

    def __init__(self, specs=()):
        self.specs = list(specs)
        self._counts = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text):
        """Parse ``site:kind:nth[:arg];...``."""
        specs = []
        for entry in (text or "").split(";"):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            if len(parts) not in (3, 4):
                raise ValueError(
                    "fault plan entry %r is not site:kind:nth[:arg]" % entry)
            arg = float(parts[3]) if len(parts) == 4 else None
            specs.append(FaultSpec(parts[0], parts[1], parts[2], arg))
        return cls(specs)

    def bump(self, site):
        with self._lock:
            c = self._counts.get(site, 0) + 1
            self._counts[site] = c
            return c

    def count(self, site):
        return self._counts.get(site, 0)

    def reset_counts(self):
        with self._lock:
            self._counts.clear()

    def match(self, site, count):
        for spec in self.specs:
            if spec.site == site and spec.matches(count):
                return spec
        return None

    def __repr__(self):
        return "FaultPlan(%s)" % ";".join(repr(s) for s in self.specs)


def _plan_from_env():
    text = os.environ.get("MXNET_TPU_FAULT_PLAN", "")
    return FaultPlan.parse(text) if text.strip() else None


def activate(plan=None):
    """Install `plan` (a FaultPlan or plan string) globally; with no
    argument, (re)load ``MXNET_TPU_FAULT_PLAN``. Returns the active plan."""
    global _ACTIVE
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    with _LOCK:
        _ACTIVE = plan if plan is not None else _plan_from_env()
        return _ACTIVE


def deactivate():
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def active_plan():
    return _ACTIVE


class inject:
    """Context manager scoping a fault plan: counters start fresh on
    entry, the previous plan comes back on exit."""

    def __init__(self, plan):
        self.plan = (FaultPlan.parse(plan) if isinstance(plan, str)
                     else plan)
        self._prev = None

    def __enter__(self):
        global _ACTIVE
        with _LOCK:
            self._prev = _ACTIVE
            self.plan.reset_counts()
            _ACTIVE = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _ACTIVE
        with _LOCK:
            _ACTIVE = self._prev
        return False


def reset_counts():
    plan = _ACTIVE
    if plan is not None:
        plan.reset_counts()


def call_count(site):
    plan = _ACTIVE
    return plan.count(site) if plan is not None else 0


def _fire(spec, site, count, context):
    from .. import telemetry as _telem
    if spec.kind == "corrupt":
        return      # only bites at transform() sites
    _telem.inc("resilience.faults_injected")
    _telem.inc("resilience.faults_injected.%s" % spec.kind)
    where = "%s (call #%d%s)" % (site, count,
                                 (", %s" % context) if context else "")
    if spec.kind == "error":
        raise InjectedFault("injected transport fault at %s" % where,
                            site=site)
    if spec.kind == "preempt":
        raise PreemptionError("injected host preemption at %s" % where)
    if spec.kind == "latency":
        time.sleep(spec.arg if spec.arg is not None else 0.05)
        return
    # hang: the watchdog's async StallError (or the end of `arg` seconds
    # when nobody watches) ends the tick loop
    deadline = time.monotonic() + (spec.arg if spec.arg is not None
                                   else 3600.0)
    with _telem.span("injected_hang@%s" % site, "fault"):
        while time.monotonic() < deadline:
            time.sleep(HANG_TICK_S)


def check(site, context=None):
    """Fault hook at the top of an instrumented site: counts the call and
    fires a matching planned fault. `context` is folded into the injected
    error's message (e.g. "request=abc")."""
    plan = _ACTIVE
    if plan is None:
        return
    count = plan.bump(site)
    spec = plan.match(site, count)
    if spec is not None:
        _fire(spec, site, count, context)


# ---------------------------------------------------------------------------
# payload-transforming sites (the ``corrupt`` kind)
# ---------------------------------------------------------------------------
def _nan_at_first(t):
    out = t.detach().clone()
    out[(0,) * out.dim()] = float("nan")
    return out


def _corrupt_one(val):
    """Corrupt ONE value; returns (new_val, did_corrupt): NaN into a float
    torch tensor, numpy array or NDArray, XOR-flipped bytes into a bytes
    blob. Deterministic, so a chaos schedule replays exactly."""
    import numpy as np
    import torch
    if isinstance(val, (bytes, bytearray)):
        raw = bytes(val)
        if not raw:
            return val, False
        mid = len(raw) // 2
        span = max(1, min(8, len(raw) - mid))
        return (raw[:mid] + bytes(b ^ 0xFF for b in raw[mid:mid + span])
                + raw[mid + span:]), True
    if isinstance(val, np.ndarray):
        if val.dtype.kind == "f" and val.size:
            out = val.copy()
            out.flat[0] = np.nan
            return out, True
        return val, False
    if torch.is_tensor(val):
        if val.is_floating_point() and val.numel():
            return _nan_at_first(val), True
        return val, False
    from ..ndarray import NDArray
    if isinstance(val, NDArray):
        t = val.data_torch
        if t.is_floating_point() and t.numel():
            out = val.copy()
            out.data_torch[(0,) * t.dim()] = float("nan")
            return out, True
    return val, False


def _corrupt_payload(payload):
    """Corrupt the FIRST corruptible element of `payload` (recursing into
    tuples and lists), keeping the container's shape."""
    if isinstance(payload, (tuple, list)):
        out = list(payload)
        for i, item in enumerate(out):
            new, did = _corrupt_payload(item)
            if did:
                out[i] = new
                return type(payload)(out), True
        return payload, False
    return _corrupt_one(payload)


def transform(site, payload, context=None):
    """Fault hook for sites where data passes through: returns `payload`,
    corrupted when a ``corrupt`` spec matches; other kinds fire as in
    `check`."""
    plan = _ACTIVE
    if plan is None:
        return payload
    count = plan.bump(site)
    spec = plan.match(site, count)
    if spec is None:
        return payload
    if spec.kind != "corrupt":
        _fire(spec, site, count, context)
        return payload
    new, did = _corrupt_payload(payload)
    if did:
        from .. import telemetry as _telem
        _telem.inc("resilience.faults_injected")
        _telem.inc("resilience.faults_injected.corrupt")
        _telem.inc("resilience.faults_injected.corrupt.%s" % site)
    return new


# an env-provided plan is live from import, so MXNET_TPU_FAULT_PLAN=...
# works with no code change
activate(_plan_from_env())
