"""`mx.attribute`: AttrScope for symbol attributes (the port of
`mxnet_tpu.attribute`).

A thread-local `with` scope whose attributes (e.g. ``__ctx_group__``,
``lr_mult``) are attached to every symbol created inside it.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_STATE = threading.local()


def _stack():
    if not hasattr(_STATE, "stack"):
        _STATE.stack = [{}]
    return _STATE.stack


class AttrScope:
    """reference: attribute.py (AttrScope)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings")
        self._attrs = kwargs

    def get(self, attrs=None):
        """The active scope merged with `attrs` (explicit attrs win)."""
        merged = dict(_stack()[-1])
        if attrs:
            merged.update(attrs)
        return merged

    def __enter__(self):
        merged = dict(_stack()[-1])
        merged.update(self._attrs)
        _stack().append(merged)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def current():
    """The active attribute dict."""
    return dict(_stack()[-1])
