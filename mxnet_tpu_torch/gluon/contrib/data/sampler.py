"""`IntervalSampler` (the port of `mxnet_tpu.gluon.contrib.data.sampler`)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Sample i, i+interval, i+2*interval, ... for each start i — the
    strided coverage pattern (reference: IntervalSampler)."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length, (
            "Interval {} must be smaller than or equal to length {}"
            .format(interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
