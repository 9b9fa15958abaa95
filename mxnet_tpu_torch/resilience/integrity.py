"""Training integrity sentinel: catch silent divergence before it spreads
(the port of `mxnet_tpu.resilience.integrity`).

The resilience layers recover from faults that raise. A non-finite
gradient or a bad batch raises nothing: it poisons the weights steps
before any metric moves. This module is the detection half of the
integrity plane (`ResilientRunner`'s rollback-to-last-good is the
recovery half):

* **bucket sentinel** (``MXNET_TPU_INTEGRITY=1``): one all-finite
  reduction over the flat values a site already holds
  (`finite_scalar`: ``torch.isfinite(flat).all()``, one launch on the
  card) and one host read of it. The kvstore push (``kvstore.bucket``),
  the ZeRO updater's packed buckets (``zero.bucket``) and the
  `FusedTrainStep` (``fused_step``: its gradients and loss) check before
  any write, so a tripped check leaves weights and states as they were,
  and raise `DivergenceError` naming the keys. With the switch off the
  sites read nothing from the card.
* **loss sentinel**: a non-finite loss always trips; with
  ``MXNET_TPU_LOSS_SPIKE_FACTOR=k`` a loss past ``k x`` the rolling
  median of the last ``MXNET_TPU_ANOMALY_WINDOW`` losses (after the
  anomaly detector's warm-up) trips too.
* **wire checksum** (``MXNET_TPU_COMM_CHECKSUM=1``, `comm_checksum_
  enabled`): the dist kvstore checks each bucket's sum finite after the
  exchange (the reference's digest of its send buffer has nothing to
  guard here: torch's exchange works in place).

A `DivergenceError` carries the step (`set_step`: the runner stamps it),
the site, the keys and the flight recorder's tail. Counters:
``integrity.checks``, ``integrity.divergences`` (and per site),
``integrity.loss_spikes``, and ``integrity.amp_overflow`` /
``integrity.amp_skipped_steps`` (an AMP overflow skip told apart from a
rollback).
"""
from __future__ import annotations

import math
import os
import threading

from .errors import DivergenceError

__all__ = ["enabled", "comm_checksum_enabled", "loss_spike_factor",
           "set_step", "current_step", "finite_scalar", "check_finite",
           "check_scalar", "observe_loss", "note_amp_overflow",
           "note_amp_skip", "reset"]

_STATE = threading.local()
_LOCK = threading.Lock()
_LOSS_WINDOW = []   # rolling |loss| window of the spike detector


def _on(name):
    return os.environ.get(name, "0").lower() in ("1", "true", "yes", "on")


def enabled():
    """The sentinel's switch (``MXNET_TPU_INTEGRITY``)."""
    return _on("MXNET_TPU_INTEGRITY")


def comm_checksum_enabled():
    """``MXNET_TPU_COMM_CHECKSUM``: digest each dist bucket before the
    wire and check the sum after (one host digest and one host read a
    bucket, so it is its own switch)."""
    return _on("MXNET_TPU_COMM_CHECKSUM")


def loss_spike_factor():
    """``MXNET_TPU_LOSS_SPIKE_FACTOR`` as a float, or None (spikes off;
    non-finite losses still trip)."""
    raw = os.environ.get("MXNET_TPU_LOSS_SPIKE_FACTOR")
    if not raw:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def _window_size():
    from ..telemetry import anomaly as _anomaly
    return _anomaly.default_window()


def set_step(step):
    """Stamp the current global step (the runner does, each step), so that
    a divergence found deep in the comm stack names it."""
    _STATE.step = int(step) if step is not None else None


def current_step():
    return getattr(_STATE, "step", None)


def _raise(site, keys, detail):
    from .. import telemetry as _telem
    from ..telemetry import flight as _flight
    _telem.inc("integrity.divergences")
    _telem.inc("integrity.divergences.%s" % site)
    step = current_step()
    _flight.note_event(
        "divergence", "site=%s step=%s%s"
        % (site, "?" if step is None else step,
           (" keys=[%s]" % ",".join(str(k) for k in keys)) if keys else ""))
    raise DivergenceError(
        "integrity sentinel tripped at %s%s: %s"
        % (site, "" if step is None else " (step %d)" % step, detail),
        step=step, site=site, keys=keys,
        flight_dump=_telem.flight_records())


def finite_scalar(tensors):
    """One 0-d bool tensor on the tensors' device: every value of every
    tensor finite (one ``isfinite(...).all()`` over each flat tensor, and
    their and on the device)."""
    import torch
    flags = [torch.isfinite(t.detach().reshape(-1)).all() for t in tensors]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


def check_finite(tensors, site, keys=None):
    """One finite reduction over `tensors` and one host read: raises
    `DivergenceError` when a value is not finite (the ZeRO packed buckets,
    the kvstore push)."""
    from .. import telemetry as _telem
    _telem.inc("integrity.checks")
    if bool(finite_scalar(tensors)):
        return
    _raise(site, keys, "non-finite value in gradient bucket")


def check_scalar(fin, site, keys=None):
    """The host read of a finite flag a site already reduced (the
    `FusedTrainStep`'s): raises on False."""
    from .. import telemetry as _telem
    _telem.inc("integrity.checks")
    if bool(fin):
        return
    _raise(site, keys, "non-finite value in the step's gradients or loss")


def observe_loss(loss, step=None):
    """Feed one step's loss to the loss sentinel: a non-finite loss trips;
    with ``MXNET_TPU_LOSS_SPIKE_FACTOR`` set, so does one past k x the
    rolling median of |loss| after the warm-up. A loss that trips does not
    join the window (after a rollback the baseline is learned from clean
    steps)."""
    from ..telemetry import anomaly as _anomaly
    if step is not None:
        set_step(step)
    try:
        val = float(loss)
    except (TypeError, ValueError):
        return
    if not math.isfinite(val):
        _raise("train.loss", None, "non-finite loss %r" % val)
    factor = loss_spike_factor()
    if factor is None:
        _append_loss(abs(val))
        return
    with _LOCK:
        win = list(_LOSS_WINDOW)
    if len(win) >= _anomaly.WARMUP_STEPS:
        med = sorted(win)[len(win) // 2]
        if med > 0 and abs(val) > factor * med:
            from .. import telemetry as _telem
            _telem.inc("integrity.loss_spikes")
            _raise("train.loss", None,
                   "loss %.6g exceeds %.3g x rolling median %.6g"
                   % (val, factor, med))
    _append_loss(abs(val))


def _append_loss(val):
    with _LOCK:
        _LOSS_WINDOW.append(val)
        limit = _window_size()
        if len(_LOSS_WINDOW) > limit:
            del _LOSS_WINDOW[:len(_LOSS_WINDOW) - limit]


def note_amp_overflow():
    """AMP's loss scaler found a non-finite gradient."""
    from .. import telemetry as _telem
    _telem.inc("integrity.amp_overflow")


def note_amp_skip():
    """AMP skipped the update of an overflowed step."""
    from .. import telemetry as _telem
    _telem.inc("integrity.amp_skipped_steps")


def reset():
    """Drop the loss window and the stamped step."""
    with _LOCK:
        del _LOSS_WINDOW[:]
    _STATE.step = None
