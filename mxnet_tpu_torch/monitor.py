"""`mx.monitor`: statistics of a module's arrays every few batches (the
port of `mxnet_tpu.monitor`).

`Monitor.install(exe)` registers an executor; between `tic` and `toc` (each
`interval` batches) `toc` applies `stat_func` to the executor's arguments,
gradients and outputs whose names match `pattern`. `Module.fit(monitor=)`
installs it on every executor and prints the statistics after each batch.
"""
from __future__ import annotations

import logging
import math
import re

from .ndarray.ndarray import NDArray, invoke

__all__ = ["Monitor"]


class Monitor:
    """reference: monitor.py (Monitor)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):  # |x|_1 / size, the reference's default
                return invoke("abs", x).mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_pattern = re.compile(pattern)
        self.sort = sort

    def install(self, exe):
        """Track an executor's arrays."""
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []

    def toc(self):
        """[(step, name, stat)] of the installed executors' arrays, on an
        active step; [] otherwise."""
        if not self.activated:
            return []
        for exe in self.exes:
            arrays = dict(exe.arg_dict)
            arrays.update(("%s_grad" % n, g)
                          for n, g in exe.grad_dict.items() if g is not None)
            arrays.update(("output%d" % i, o)
                          for i, o in enumerate(exe.outputs))
            for name, arr in arrays.items():
                if isinstance(arr, NDArray) and self.re_pattern.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(arr)))
        self.activated = False
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        res = []
        for step, name, stat in self.queue:
            val = float(stat.asnumpy().reshape(-1)[0]) \
                if isinstance(stat, NDArray) else float(stat)
            res.append((step, name, val))
        self.step += 1
        self.queue = []
        return res

    def toc_print(self):
        """`toc`, logged one line per statistic."""
        res = self.toc()
        for step, name, value in res:
            logging.info("Batch: %7d %30s %s", step, name,
                         "nan" if math.isnan(value) else "%.8g" % value)
        return res
