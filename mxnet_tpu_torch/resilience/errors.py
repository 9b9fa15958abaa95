"""The part of the resilience error taxonomy that the port needs.

`mxnet_tpu.resilience.errors` classifies faults as retriable or fatal for
the recovery machinery. The port has no recovery path yet, so it keeps the
base class that the serving errors derive from and the fatal error that
checkpoint restore raises when no snapshot verifies.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ResilienceError", "FatalTrainingError", "CheckpointCorruptError"]


class ResilienceError(MXNetError):
    """Base class of every error raised by the resilience and serving
    planes."""


class FatalTrainingError(ResilienceError):
    """Deterministic failure: retrying replays the identical crash, so it
    is surfaced at once."""


class CheckpointCorruptError(FatalTrainingError):
    """Every candidate checkpoint step failed its sha256 verification or
    could not be loaded. A single corrupt step is recoverable (restore
    falls back to the next-oldest one and counts ``checkpoint.corrupt``),
    so this error means the whole retention window is bad."""

    def __init__(self, message, steps_tried=None):
        super().__init__(message)
        self.steps_tried = list(steps_tried or [])
