"""Autograd mode state (the port of the part of `mxnet_tpu.autograd` that
inference reads): `is_training`, `is_recording`, and the `record`,
`pause`, `train_mode` and `predict_mode` scopes, per thread.

Gradients come with the Gluon training slice: until then `backward` and
`mark_variable` raise NotImplementedError.
"""
from __future__ import annotations

import threading

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "backward",
           "mark_variable"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Set the recording flag; returns the previous value."""
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train_mode_):
    """Set the training flag; returns the previous value."""
    st = _st()
    prev, st.training = st.training, bool(train_mode_)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, ptype, value, trace):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _not_yet(name):
    raise NotImplementedError(
        "autograd.%s: gradients come with the port's Gluon training slice"
        % name)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    _not_yet("backward")


def mark_variable(nd, grad_req="write"):
    _not_yet("mark_variable")
