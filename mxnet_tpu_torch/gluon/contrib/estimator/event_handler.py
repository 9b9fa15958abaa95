"""Estimator event handlers (the port of
`mxnet_tpu.gluon.contrib.estimator.event_handler`): the fit loop emits
the train, epoch and batch begin and end events, and each handler mixes in
the hooks it needs: stopping, metrics, validation, logging, checkpoints
and early stopping.
"""
from __future__ import annotations

import logging
import os
import time

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch / max_batch (reference: StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False     # reusable across fit() calls

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Updates train metrics every batch; resets per epoch
    (reference: MetricHandler)."""

    def __init__(self, metrics):
        self.metrics = metrics or []

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for m in self.metrics:
            # loss metrics (e.g. "train_loss"/"val_loss") consume the loss
            # tensor; everything else scores predictions against labels
            if "loss" in getattr(m, "name", "") and loss is not None:
                m.update(0, loss)
            elif pred is not None and label is not None:
                m.update([label], [pred])


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Runs evaluation on a schedule (reference: ValidationHandler)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Logs metrics per epoch (and optionally per N batches)
    (reference: LoggingHandler)."""

    def __init__(self, log_interval="epoch", metrics=None, logger=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.logger = logger or logging.getLogger("Estimator")
        self.batch_index = 0
        self.current_epoch = 0
        self._train_start = None
        self._epoch_start = None

    def train_begin(self, estimator, *args, **kwargs):
        self._train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Training finished in %.1fs",
                         time.time() - self._train_start)

    def epoch_begin(self, estimator, *args, **kwargs):
        self._epoch_start = time.time()
        self.batch_index = 0

    def epoch_end(self, estimator, *args, **kwargs):
        msg = "Epoch %d  %.1fs  " % (self.current_epoch,
                                     time.time() - self._epoch_start)
        msg += "  ".join("%s: %.4f" % m.get() for m in self.metrics)
        self.logger.info(msg)
        self.current_epoch += 1

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            msg = "[Epoch %d][Batch %d] " % (self.current_epoch,
                                             self.batch_index)
            msg += "  ".join("%s: %.4f" % m.get() for m in self.metrics)
            self.logger.info(msg)


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Saves model parameters (and trainer states) on a schedule; can
    track a monitored metric and keep the best checkpoint
    (reference: CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", epoch_period=1, save_best=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.mode = mode
        self.epoch_period = epoch_period
        self.save_best = save_best
        self.current_epoch = 0
        self.best = None

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        self.current_epoch = 0
        self.best = None

    def _improved(self, value):
        if self.best is None:
            return True
        return value < self.best if self.mode == "min" else value > self.best

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            path = os.path.join(self.model_dir, "%s-epoch%d.params"
                                % (self.model_prefix, self.current_epoch))
            estimator.net.save_parameters(path)
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            if self._improved(value):
                self.best = value
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, "%s-best.params" % self.model_prefix))


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stops training when the monitored metric stops improving
    (reference: EarlyStoppingHandler)."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stop_training = False
        self.stopped_epoch = None
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.best = None
        self.wait = 0
        self.stop_training = False
        self.current_epoch = 0

    def _improved(self, value):
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, value = self.monitor.get()
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.stopped_epoch = self.current_epoch
