"""Estimator, the high-level Gluon fit loop (the port of
`mxnet_tpu.gluon.contrib.estimator.estimator`): net, loss, metrics and
trainer in `fit(train_data, val_data, epochs)`, with the lifecycle events
of `event_handler`. A step is record, forward, loss, backward and
`trainer.step`, as a hand-written loop does it.
"""
from __future__ import annotations

import logging

from .... import autograd, metric as metric_mod
from ...trainer import Trainer
from ...loss import Loss
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


class _LossMetric(metric_mod.EvalMetric):
    """Running mean of the loss (reference: metric.Loss)."""

    def __init__(self, name="loss"):
        super().__init__(name)

    def update(self, _labels, preds):
        arr = metric_mod._to_numpy(preds)
        self.sum_metric += float(arr.sum())
        self.num_inst += int(arr.size)


class Estimator:
    """reference: gluon.contrib.estimator.Estimator."""

    def __init__(self, net, loss, metrics=None, trainer=None, context=None,
                 logger=None):
        self.net = net
        if not isinstance(loss, Loss):
            raise ValueError("loss must be a gluon.loss.Loss, got %s"
                             % type(loss))
        self.loss = loss
        if metrics is None:
            metrics = []
        elif isinstance(metrics, metric_mod.EvalMetric):
            metrics = [metrics]
        self.train_metrics = list(metrics)
        self.train_loss_metric = _LossMetric("train_loss")
        self.val_metrics = [m.__class__() for m in self.train_metrics]
        self.val_loss_metric = _LossMetric("val_loss")
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.context = context
        self.logger = logger or logging.getLogger("Estimator")
        self.stop_training = False

    # ------------------------------------------------------------------
    def _place(self, x, y):
        if self.context is not None:
            x = x.as_in_context(self.context)
            y = y.as_in_context(self.context)
        return x, y

    def evaluate(self, val_data):
        """One pass over val_data updating the val metrics."""
        for m in self.val_metrics:
            m.reset()
        self.val_loss_metric.reset()
        for batch in val_data:
            x, y = self._place(batch[0], batch[1])
            pred = self.net(x)
            loss = self.loss(pred, y)
            for m in self.val_metrics:
                m.update([y], [pred])
            self.val_loss_metric.update(0, loss)
        return dict(m.get() for m in
                    self.val_metrics + [self.val_loss_metric])

    def _default_handlers(self, val_data, epochs):
        handlers = [StoppingHandler(max_epoch=epochs),
                    MetricHandler(self.train_metrics +
                                  [self.train_loss_metric])]
        if val_data is not None:
            handlers.append(ValidationHandler(val_data, self.evaluate))
        handlers.append(LoggingHandler(
            metrics=self.train_metrics + [self.train_loss_metric],
            logger=self.logger))
        return handlers

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batch_axis=0):
        """reference: Estimator.fit — the event-driven epoch/batch loop."""
        handlers = list(event_handlers) if event_handlers else []
        defaults_needed = not any(isinstance(h, StoppingHandler)
                                  for h in handlers)
        if defaults_needed:
            handlers = self._default_handlers(val_data, epochs) + handlers

        def emit(kind, **kwargs):
            base = {"TrainBegin": TrainBegin, "TrainEnd": TrainEnd,
                    "EpochBegin": EpochBegin, "EpochEnd": EpochEnd,
                    "BatchBegin": BatchBegin, "BatchEnd": BatchEnd}[kind]
            meth = {"TrainBegin": "train_begin", "TrainEnd": "train_end",
                    "EpochBegin": "epoch_begin", "EpochEnd": "epoch_end",
                    "BatchBegin": "batch_begin", "BatchEnd": "batch_end"}
            for h in handlers:
                if isinstance(h, base):
                    getattr(h, meth[kind])(self, **kwargs)
            self.stop_training = any(
                getattr(h, "stop_training", False) for h in handlers)

        emit("TrainBegin")
        while not self.stop_training:
            emit("EpochBegin")
            for batch in train_data:
                x, y = self._place(batch[0], batch[1])
                emit("BatchBegin")
                with autograd.record():
                    pred = self.net(x)
                    loss = self.loss(pred, y)
                loss.backward()
                self.trainer.step(x.shape[batch_axis])
                emit("BatchEnd", pred=pred, label=y, loss=loss)
                if self.stop_training:
                    break
            emit("EpochEnd")
        emit("TrainEnd")
        return self
