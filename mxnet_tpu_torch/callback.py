"""Training callbacks (the port of `mxnet_tpu.callback`): `Speedometer`,
`ProgressBar`, `log_train_metric`, `LogValidationMetricsCallback`, and the
epoch-end checkpoints `module_checkpoint` (through `Module.save_checkpoint`)
and `do_checkpoint` (through `model.save_checkpoint`)."""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """An epoch-end callback saving `mod` every `period` epochs.
    reference: callback.py (module_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """An epoch-end callback writing `prefix-symbol.json` and
    `prefix-%04d.params` every `period` epochs.
    reference: callback.py (do_checkpoint)."""
    from . import model
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """reference: callback.py (log_train_metric)."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer:
    """Log throughput every `frequent` batches.
    reference: callback.py (Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                try:
                    speed = self.frequent * self.batch_size / (
                        time.time() - self.tic)
                except ZeroDivisionError:
                    speed = float("inf")
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset_local()
                    msg = "Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count - self.frequent,
                                 count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """reference: callback.py (ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """reference: callback.py (LogValidationMetricsCallback)."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        name_value = param.eval_metric.get_name_value()
        for name, value in name_value:
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
