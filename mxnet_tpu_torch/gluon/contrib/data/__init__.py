"""`gluon.contrib.data` of the port."""
from . import sampler
from .sampler import IntervalSampler

__all__ = ["sampler", "IntervalSampler"]
