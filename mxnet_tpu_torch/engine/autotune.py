"""Comm-schedule autotuning (the port of `mxnet_tpu.engine.autotune`).

A comm schedule is the pair of knobs of the bucketed exchange: the bucket
cap (``MXNET_TPU_COMM_BUCKET_MB``; 0 sends key by key) and the flush
policy: ``registration`` (every gradient fed at step time, in reverse
registration order) or ``ready`` (each bucket launched from the grad-ready
hook while backward runs, `engine.ready`).

`ScheduleAutotuner` sweeps a grid over the first training steps: each
candidate runs ``steps_per_candidate`` steps and is scored by its exposed
communication time, the milliseconds of ``comm`` spans that fall inside
``trainer.step`` spans (the part backward did not hide), plus a
thousandth of all comm time as a tie-break. The winner is pinned
process-wide (`set_schedule`: the cap through `engine.set_bucket_mb`, the
policy read by the Trainer) and rides checkpoints (`schedule_payload` /
`restore_schedule`), so a restart sweeps nothing. Every candidate computes
the same sums (bucketing and flush order change when an exchange starts,
not what it adds), so sweeping live is safe.

Switches::

    MXNET_TPU_COMM_AUTOTUNE=1          sweep (Trainer)
    MXNET_TPU_COMM_AUTOTUNE_STEPS=N    steps per candidate (default 2)
    MXNET_TPU_COMM_AUTOTUNE_CAPS=a,b   bucket-MB grid (default 0,4,25,100)
    MXNET_TPU_COMM_READY=1             the ready policy without a sweep
"""
from __future__ import annotations

import os

__all__ = ["CommSchedule", "ScheduleAutotuner", "autotune_enabled",
           "sweep_budget", "current_schedule", "set_schedule",
           "schedule_payload", "restore_schedule", "ready_env",
           "POLICIES"]

POLICIES = ("registration", "ready")

_DEFAULT_CAPS_MB = (0.0, 4.0, 25.0, 100.0)
_DEFAULT_STEPS = 2


def _flag(name):
    return os.environ.get(name, "0").lower() not in ("0", "", "false",
                                                     "off")


def autotune_enabled():
    """True when ``MXNET_TPU_COMM_AUTOTUNE`` asks for a sweep."""
    return _flag("MXNET_TPU_COMM_AUTOTUNE")


def ready_env():
    """True when ``MXNET_TPU_COMM_READY`` asks for the ready policy."""
    return _flag("MXNET_TPU_COMM_READY")


def sweep_budget():
    """Steps per candidate (``MXNET_TPU_COMM_AUTOTUNE_STEPS``, 2)."""
    try:
        return max(1, int(os.environ.get("MXNET_TPU_COMM_AUTOTUNE_STEPS",
                                         _DEFAULT_STEPS)))
    except (TypeError, ValueError):
        return _DEFAULT_STEPS


def _caps_grid():
    raw = os.environ.get("MXNET_TPU_COMM_AUTOTUNE_CAPS", "")
    out = []
    for part in raw.split(","):
        try:
            out.append(float(part))
        except ValueError:
            pass
    return out or list(_DEFAULT_CAPS_MB)


class CommSchedule:
    """One (bucket_mb, flush policy) point."""

    __slots__ = ("bucket_mb", "policy", "score", "source")

    def __init__(self, bucket_mb, policy, score=None, source="manual"):
        if policy not in POLICIES:
            raise ValueError("flush policy must be one of %s, got %r"
                             % (POLICIES, policy))
        self.bucket_mb = float(bucket_mb)
        self.policy = str(policy)
        self.score = None if score is None else float(score)
        self.source = str(source)

    def apply(self):
        """Pin the bucket cap process-wide; returns the previous
        override."""
        from . import set_bucket_mb
        return set_bucket_mb(self.bucket_mb)

    def describe(self):
        return "%gMB/%s" % (self.bucket_mb, self.policy)

    def to_payload(self):
        return {"schedule_format": 1, "bucket_mb": self.bucket_mb,
                "policy": self.policy, "score": self.score,
                "source": self.source}

    @classmethod
    def from_payload(cls, payload):
        if int(payload.get("schedule_format", -1)) != 1:
            raise ValueError("unsupported comm-schedule payload %r"
                             % (payload,))
        return cls(payload["bucket_mb"], payload["policy"],
                   score=payload.get("score"),
                   source=payload.get("source", "checkpoint"))

    def __eq__(self, other):
        return (isinstance(other, CommSchedule)
                and self.bucket_mb == other.bucket_mb
                and self.policy == other.policy)

    __hash__ = None

    def __repr__(self):
        return ("CommSchedule(%s, score=%s, source=%s)"
                % (self.describe(), self.score, self.source))


_CURRENT = None


def current_schedule():
    return _CURRENT


def set_schedule(schedule, announce=False):
    """Pin `schedule` process-wide (None clears it and the cap)."""
    global _CURRENT
    _CURRENT = schedule
    if schedule is None:
        from . import set_bucket_mb
        set_bucket_mb(None)
        return None
    schedule.apply()
    from .. import telemetry as _telem
    if _telem.ENABLED:
        _telem.set_gauge("comm.schedule.bucket_mb", schedule.bucket_mb)
        _telem.set_gauge("comm.schedule.ready",
                         1.0 if schedule.policy == "ready" else 0.0)
    if announce:
        from ..telemetry import flight
        flight.note_event("autotune", "comm schedule %s (score=%s, %s)"
                          % (schedule.describe(), schedule.score,
                             schedule.source))
    return schedule


def schedule_payload():
    """The pinned schedule as a checkpointable dict, or None."""
    return None if _CURRENT is None else _CURRENT.to_payload()


def restore_schedule(payload):
    """Re-pin a checkpointed schedule (None: nothing)."""
    if not payload:
        return None
    sched = CommSchedule.from_payload(payload)
    sched.source = "checkpoint"
    return set_schedule(sched, announce=True)


def exposed_comm(since, site="trainer.step"):
    """{"collective_ms", "exposed_ms", "overlap_frac"} of the spans
    recorded after `since` (a `telemetry.span_clock()` reading): comm
    time, the part of it inside `site` spans, and the hidden share."""
    from .. import telemetry as _telem
    events = [e for e in _telem.span_events() if e[2] >= since]
    steps = [(ts, ts + dur) for name, _, ts, dur, _ in events
             if name == site]
    coll = exposed = 0.0
    for name, cat, ts, dur, _ in events:
        if cat != "comm":
            continue
        coll += dur
        for lo, hi in steps:
            exposed += max(0.0, min(hi, ts + dur) - max(lo, ts))
    frac = None if coll == 0 else 1.0 - exposed / coll
    return {"collective_ms": coll * 1e3, "exposed_ms": exposed * 1e3,
            "overlap_frac": frac}


class ScheduleAutotuner:
    """Drives the sweep from the training loop::

        sched = tuner.current()    # the schedule of THIS step
        ... the step ...
        tuner.on_step_end()        # scores and pins when done
    """

    def __init__(self, candidates=None, steps_per_candidate=None,
                 site="trainer.step"):
        if candidates is None:
            candidates = [CommSchedule(mb, pol, source="sweep")
                          for mb in _caps_grid() for pol in POLICIES]
        self.candidates = list(candidates)
        if not self.candidates:
            raise ValueError("autotuner needs at least one candidate")
        self.steps_per = (sweep_budget() if steps_per_candidate is None
                          else max(1, int(steps_per_candidate)))
        self.site = site
        self.results = []          # [(CommSchedule, metrics)]
        self.sweep_steps = 0
        self._idx = 0
        self._step_in_candidate = 0
        self._since = None
        self.chosen = None

    @classmethod
    def restored(cls, schedule, site="trainer.step"):
        """A finished tuner whose winner is `schedule` (no sweep)."""
        tuner = cls(candidates=[schedule], site=site)
        tuner.chosen = schedule
        return tuner

    @property
    def done(self):
        return self.chosen is not None

    def current(self):
        if self.chosen is not None:
            return self.chosen
        if self._since is None:
            from .. import telemetry as _telem
            self._since = _telem.span_clock()
        return self.candidates[self._idx]

    @staticmethod
    def score(metrics):
        """Exposed comm milliseconds (lower is better), with a thousandth
        of all comm time as the tie-break."""
        coll = float(metrics.get("collective_ms", 0.0))
        exposed = metrics.get("exposed_ms")
        if exposed is None:
            frac = metrics.get("overlap_frac")
            exposed = coll * (1.0 - (0.0 if frac is None else float(frac)))
        return float(exposed) + 1e-3 * coll

    def on_step_end(self):
        """Advance by one finished step; returns the winner once pinned."""
        if self.chosen is not None:
            return self.chosen
        from .. import telemetry as _telem
        if self._since is None:
            self._since = _telem.span_clock()
        self.sweep_steps += 1
        self._step_in_candidate += 1
        if self._step_in_candidate < self.steps_per:
            return None
        cand = self.candidates[self._idx]
        metrics = exposed_comm(self._since, self.site)
        cand.score = self.score(metrics)
        self.results.append((cand, metrics))
        self._idx += 1
        self._step_in_candidate = 0
        self._since = _telem.span_clock()
        if self._idx < len(self.candidates):
            return None
        best = min(self.results, key=lambda cm: cm[0].score)[0]
        best.source = "autotune"
        self.chosen = best
        set_schedule(best, announce=True)
        if _telem.ENABLED:
            _telem.inc("comm.autotune.sweeps")
            _telem.set_gauge("comm.autotune.sweep_steps",
                             float(self.sweep_steps))
        return best
