"""Resilience plane of the port (errors only, so far)."""
from .errors import CheckpointCorruptError, FatalTrainingError, ResilienceError

__all__ = ["CheckpointCorruptError", "FatalTrainingError", "ResilienceError"]
