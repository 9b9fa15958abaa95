"""Profiler (the port of `mxnet_tpu.profiler`; reference:
python/mxnet/profiler.py over src/profiler/): per-op aggregate stats and
a device trace, `set_config`/`set_state`/`dumps`.

Two layers, as in the JAX package:

* The op table (`dumps()`): the imperative `invoke` times each call on
  the host clock and a hybridized block's call is one ``CachedOp:<name>``
  row. CUDA work is asynchronous, so these numbers are host dispatch
  time; device time comes from the second layer. The port's hybridized
  forward is eager, so the ops inside a ``CachedOp`` call are not
  recorded on their own: one program gives the same row names and counts
  as in the JAX package, where those ops run inside one jit program.
* The device trace: with ``profile_all``, `set_state('run')` starts a
  `torch.profiler` session (CPU activity, and CUDA when a card is
  present) and `set_state('stop')` ends it and writes its chrome trace
  beside the configured ``filename`` (``profile.json`` ->
  ``profile_trace.json``; `last_trace()` names it). A trace that fails to
  start raises.

`pause()`/`resume()` suspend the op table without ending an active
device trace (the reference's MXProfilePause keeps its session alive).
`dumps()`/`dump()` embed the telemetry snapshot (`mxnet_tpu_torch.
telemetry`) beside the op table when telemetry is on and not empty.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

__all__ = ["set_config", "set_state", "state", "dumps", "dump", "reset",
           "Scope", "scope", "pause", "resume"]

_lock = threading.Lock()
_config = {"profile_all": False, "profile_symbolic": True,
           "profile_imperative": True, "profile_memory": False,
           "profile_api": True, "filename": "profile.json",
           "aggregate_stats": True}
_state = "stop"
_paused = False
_session = None          # the torch.profiler session of a device trace
_last_trace = None
_cached_depth = 0        # > 0 inside a hybridized block's call
_agg = {}                # op name -> [count, total_s, min_s, max_s]


def set_config(**kwargs):
    """reference: profiler.py (set_config)."""
    unknown = set(kwargs) - set(_config) - {"profile_process"}
    if unknown:
        raise ValueError("unknown profiler config keys: %s" % unknown)
    _config.update({k: v for k, v in kwargs.items() if k in _config})


def state():
    return _state


def _sync_imperative_flag():
    from .ndarray import ndarray as _nd_mod
    _nd_mod._PROFILE_IMPERATIVE = (_state == "run" and not _paused
                                   and _config["profile_imperative"]
                                   and _cached_depth == 0)


def _trace_path():
    stem, _ = os.path.splitext(_config["filename"])
    return stem + "_trace.json"


def _start_trace():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    session = torch.profiler.profile(
        activities=acts, profile_memory=_config["profile_memory"])
    session.start()
    return session


def set_state(state_name="stop", profile_process="worker"):
    """reference: profiler.py (set_state): 'run' | 'stop'."""
    global _state, _paused, _session, _last_trace
    if state_name not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    prev = _state
    if state_name == "run" and prev != "run" and _config["profile_all"]:
        _session = _start_trace()
    _state = state_name
    _paused = False
    _sync_imperative_flag()
    if state_name == "stop" and prev == "run" and _session is not None:
        session, _session = _session, None
        session.stop()
        _last_trace = _trace_path()
        session.export_chrome_trace(_last_trace)


def last_trace():
    """The chrome trace the last device trace wrote (None before one)."""
    return _last_trace


def pause(profile_process="worker"):
    """Suspend the op table; an active device trace keeps running
    (reference: MXProfilePause; pause is not stop)."""
    global _paused
    if _state != "run":
        return
    _paused = True
    _sync_imperative_flag()


def resume(profile_process="worker"):
    """Resume the op table after pause(); the device trace never
    stopped."""
    global _paused
    if _state != "run":
        return
    _paused = False
    _sync_imperative_flag()


def is_running():
    return _state == "run"


def is_paused():
    return _paused


def is_profiling(kind):
    """True when stats of `kind` (a profile_* config key) aggregate right
    now: running, not paused, enabled, and not inside a hybridized
    block's call."""
    return (_state == "run" and not _paused and _config[kind]
            and _cached_depth == 0)


def record_op(name, seconds):
    """Add one call of `name` to the op table (the invoke and CachedOp
    hooks, and `Scope`)."""
    if _paused:
        return
    with _lock:
        ent = _agg.get(name)
        if ent is None:
            _agg[name] = [1, seconds, seconds, seconds]
        else:
            ent[0] += 1
            ent[1] += seconds
            ent[2] = min(ent[2], seconds)
            ent[3] = max(ent[3], seconds)


def cached_op(name, fn, *args):
    """Run a hybridized block's forward `fn(*args)` as one
    ``CachedOp:<name>`` row: the ops inside record no row of their own."""
    global _cached_depth
    t0 = time.perf_counter()
    _cached_depth += 1
    _sync_imperative_flag()
    try:
        return fn(*args)
    finally:
        _cached_depth -= 1
        _sync_imperative_flag()
        record_op("CachedOp:" + name, time.perf_counter() - t0)


def reset():
    with _lock:
        _agg.clear()


def _telemetry_snapshot():
    """The telemetry snapshot to embed in dumps(); {} when telemetry is
    off or empty."""
    from . import telemetry
    if not telemetry.ENABLED:
        return {}
    snap = telemetry.snapshot()
    if not any(snap.values()):
        return {}
    return snap


def dumps(reset_stats=False, format="table"):
    """The op table (reference: profiler.py (dumps) over
    src/profiler/aggregate_stats.cc), 'table' or 'json' (anything else
    raises ValueError), with the telemetry snapshot embedded."""
    if format not in ("table", "json"):
        raise ValueError(
            "profiler dumps format must be 'table' or 'json', got %r"
            % (format,))
    telem = _telemetry_snapshot()
    with _lock:
        rows = sorted(_agg.items(), key=lambda kv: -kv[1][1])
        if format == "json":
            payload = {k: {"count": v[0], "total_ms": v[1] * 1e3,
                           "min_ms": v[2] * 1e3, "max_ms": v[3] * 1e3,
                           "avg_ms": v[1] / v[0] * 1e3}
                       for k, v in rows}
            if telem:
                payload["telemetry"] = telem
            out = json.dumps(payload)
        else:
            lines = ["%-40s %10s %12s %12s %12s %12s" %
                     ("Name", "Calls", "Total(ms)", "Avg(ms)", "Min(ms)",
                      "Max(ms)")]
            for k, v in rows:
                lines.append("%-40s %10d %12.3f %12.3f %12.3f %12.3f" %
                             (k, v[0], v[1] * 1e3, v[1] / v[0] * 1e3,
                              v[2] * 1e3, v[3] * 1e3))
            if telem:
                from . import telemetry
                lines.append("")
                lines.append("Telemetry")
                lines.append(telemetry.dumps(format="table"))
            out = "\n".join(lines)
        if reset_stats:
            _agg.clear()
    return out


def dump(finished=True, profile_process="worker", format="json"):
    """Write the op table to the configured filename in `format`."""
    out = dumps(format=format)
    with open(_config["filename"], "w") as f:
        f.write(out)


class Scope:
    """A named range of user code: a context manager (re-entrant: nested
    `with` on the same instance records each range) or a decorator::

        timed = profiler.Scope("hot")
        with timed:
            with timed:          # nested: two ranges recorded
                ...

        @profiler.scope("hot")
        def f(...): ...

    Each range is a ``scope:<name>`` row of the op table and, with
    telemetry on, a span of its chrome trace. reference: profiler.py
    (Scope)."""

    def __init__(self, name="<unk>", append_mode=True):
        self.name = name
        self._tls = threading.local()   # a start stack per thread

    def _stack(self):
        stack = getattr(self._tls, "starts", None)
        if stack is None:
            stack = self._tls.starts = []
        return stack

    def __enter__(self):
        self._stack().append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        stack = self._stack()
        if stack:
            dur = time.perf_counter() - stack.pop()
            record_op("scope:" + self.name, dur)
            from . import telemetry
            if telemetry.ENABLED:
                telemetry.record_span("scope:" + self.name, "user",
                                      telemetry.span_clock() - dur, dur)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapper


scope = Scope
