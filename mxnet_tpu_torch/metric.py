"""Evaluation metrics (the port of `mxnet_tpu.metric`).

The reference's registry (`create`, `register`, `alias`), its
update(labels, preds) protocol with local and global statistics, and its
metric classes. The arithmetic runs in numpy on the host after one copy of
each array, as in the reference: an update of arrays on the card is a
host sync, counted under ``metric.host_syncs`` in `telemetry` (one per
array copied).
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as _np

from . import ndarray as nd
from . import telemetry as _telem

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "check_label_shapes"]

_METRIC_REGISTRY = {}


def register(klass):
    name = klass.__name__.lower()
    _METRIC_REGISTRY[name] = klass
    return klass


def alias(*aliases):
    def deco(klass):
        for a in aliases:
            _METRIC_REGISTRY[a.lower()] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    """reference: metric.py (create)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        if metric.lower() not in _METRIC_REGISTRY:
            raise ValueError("Metric must be either callable or in registry; "
                             "got %s" % metric)
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise TypeError("metric should be either str, callable, EvalMetric or "
                    "list; got %s" % type(metric))


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """reference: metric.py (check_label_shapes)."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}".format(
                label_shape, pred_shape))
    if wrap:
        if isinstance(labels, nd.NDArray):
            labels = [labels]
        if isinstance(preds, nd.NDArray):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base metric. reference: metric.py (EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._has_global_stats = kwargs.pop("has_global_stats", False)
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        """Update from {name: array} dicts honoring output/label_names."""
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        """Returns (name, value)."""
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self._has_global_stats:
            if self.global_num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.global_sum_metric / self.global_num_inst)
        return self.get()

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_global_name_value(self):
        if self._has_global_stats:
            name, value = self.get_global()
            if not isinstance(name, list):
                name = [name]
            if not isinstance(value, list):
                value = [value]
            return list(zip(name, value))
        return self.get_name_value()


def _to_numpy(x):
    """A host copy of an array; an array on the card counts one host
    sync."""
    if isinstance(x, nd.NDArray):
        if x.context.device_type == "gpu":
            _telem.inc("metric.host_syncs")
        return x.asnumpy()
    return _np.asarray(x)


@register
class CompositeEvalMetric(EvalMetric):
    """reference: metric.py (CompositeEvalMetric)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}".format(
                index, len(self.metrics)))

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = OrderedDict([i for i in labels.items()
                                  if i[0] in self.label_names])
        if self.output_names is not None:
            preds = OrderedDict([i for i in preds.items()
                                 if i[0] in self.output_names])
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def reset_local(self):
        try:
            for metric in self.metrics:
                metric.reset_local()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, _np.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_global(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get_global()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, _np.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [i.get_config() for i in self.metrics]})
        return config


@register
@alias("acc")
class Accuracy(EvalMetric):
    """reference: metric.py (Accuracy)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_np = _to_numpy(pred_label)
            label_np = _to_numpy(label)
            if pred_np.ndim > label_np.ndim:
                pred_np = pred_np.argmax(axis=self.axis)
            pred_np = pred_np.astype("int32")
            label_np = label_np.astype("int32")
            labels_f, preds_f = check_label_shapes(label_np.reshape(-1),
                                                   pred_np.reshape(-1))
            num_correct = (preds_f == labels_f).sum()
            self.sum_metric += num_correct
            self.global_sum_metric += num_correct
            self.num_inst += len(preds_f)
            self.global_num_inst += len(preds_f)


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """reference: metric.py (TopKAccuracy)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) == 2, "Predictions should be 2 dims"
            pred_np = _np.argsort(_to_numpy(pred_label).astype("float32"),
                                  axis=1)
            label_np = _to_numpy(label).astype("int32")
            num_samples = pred_np.shape[0]
            num_dims = len(pred_np.shape)
            if num_dims == 1:
                num_correct = (pred_np.reshape(-1) == label_np.reshape(-1)).sum()
                self.sum_metric += num_correct
                self.global_sum_metric += num_correct
            elif num_dims == 2:
                num_classes = pred_np.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    num_correct = (pred_np[:, num_classes - 1 - j].reshape(-1)
                                   == label_np.reshape(-1)).sum()
                    self.sum_metric += num_correct
                    self.global_sum_metric += num_correct
            self.num_inst += num_samples
            self.global_num_inst += num_samples


class _BinaryClassificationMetrics:
    """Helper for F1/MCC. reference: metric.py (_BinaryClassificationMetrics)."""

    def __init__(self):
        self.true_positives = 0
        self.false_negatives = 0
        self.false_positives = 0
        self.true_negatives = 0

    def update_binary_stats(self, label, pred):
        pred_np = _to_numpy(pred)
        label_np = _to_numpy(label).astype("int32")
        pred_label = _np.argmax(pred_np, axis=1)
        check_label_shapes(label_np, pred_np)
        if len(_np.unique(label_np)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % self.__class__.__name__)
        pred_true = (pred_label == 1)
        pred_false = 1 - pred_true
        label_true = (label_np == 1)
        label_false = 1 - label_true
        self.true_positives += (pred_true * label_true).sum()
        self.false_positives += (pred_true * label_false).sum()
        self.false_negatives += (pred_false * label_true).sum()
        self.true_negatives += (pred_false * label_false).sum()

    @property
    def precision(self):
        if self.true_positives + self.false_positives > 0:
            return float(self.true_positives) / (
                self.true_positives + self.false_positives)
        return 0.0

    @property
    def recall(self):
        if self.true_positives + self.false_negatives > 0:
            return float(self.true_positives) / (
                self.true_positives + self.false_negatives)
        return 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (
                self.precision + self.recall)
        return 0.0

    @property
    def matthewscc(self):
        if not self.total_examples:
            return 0.0
        true_pos = float(self.true_positives)
        false_pos = float(self.false_positives)
        false_neg = float(self.false_negatives)
        true_neg = float(self.true_negatives)
        terms = [(true_pos + false_pos), (true_pos + false_neg),
                 (true_neg + false_pos), (true_neg + false_neg)]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((true_pos * true_neg) - (false_pos * false_neg)) / \
            math.sqrt(denom)

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives +
                self.true_negatives + self.true_positives)

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class F1(EvalMetric):
    """reference: metric.py (F1)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.global_sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.global_num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * \
                self.metrics.total_examples
            self.global_sum_metric = self.sum_metric
            self.num_inst = self.metrics.total_examples
            self.global_num_inst = self.num_inst

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient. reference: metric.py (MCC)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        if self._average == "macro":
            self.sum_metric += self._metrics.matthewscc
            self.global_sum_metric += self._metrics.matthewscc
            self.num_inst += 1
            self.global_num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = self._metrics.matthewscc * \
                self._metrics.total_examples
            self.global_sum_metric = self.sum_metric
            self.num_inst = self._metrics.total_examples
            self.global_num_inst = self.num_inst

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0
        self.global_sum_metric = 0.0
        self.global_num_inst = 0.0
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """reference: metric.py (Perplexity)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label).astype("int32").reshape(-1)
            pred_np = _to_numpy(pred)
            pred_np = pred_np.reshape(-1, pred_np.shape[-1])
            probs = pred_np[_np.arange(label_np.shape[0]), label_np]
            if self.ignore_label is not None:
                ignore = (label_np == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label_np.shape[0]
        self.sum_metric += loss
        self.global_sum_metric += loss
        self.num_inst += num
        self.global_num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.global_sum_metric /
                                    self.global_num_inst))


@register
class MAE(EvalMetric):
    """reference: metric.py (MAE)."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            mae = _np.abs(label_np - pred_np).mean()
            self.sum_metric += mae
            self.global_sum_metric += mae
            self.num_inst += 1
            self.global_num_inst += 1


@register
class MSE(EvalMetric):
    """reference: metric.py (MSE)."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            mse = ((label_np - pred_np) ** 2.0).mean()
            self.sum_metric += mse
            self.global_sum_metric += mse
            self.num_inst += 1
            self.global_num_inst += 1


@register
class RMSE(MSE):
    """reference: metric.py (RMSE)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names=output_names,
                            label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            rmse = _np.sqrt(((label_np - pred_np) ** 2.0).mean())
            self.sum_metric += rmse
            self.global_sum_metric += rmse
            self.num_inst += 1
            self.global_num_inst += 1


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    """reference: metric.py (CrossEntropy)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            label_np = label_np.ravel()
            assert label_np.shape[0] == pred_np.shape[0]
            prob = pred_np[_np.arange(label_np.shape[0]),
                           _np.int64(label_np)]
            cross_entropy = (-_np.log(prob + self.eps)).sum()
            self.sum_metric += cross_entropy
            self.global_sum_metric += cross_entropy
            self.num_inst += label_np.shape[0]
            self.global_num_inst += label_np.shape[0]


@register
@alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    """reference: metric.py (NegativeLogLikelihood)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            label_np = label_np.ravel()
            num_examples = pred_np.shape[0]
            assert label_np.shape[0] == num_examples, \
                (label_np.shape[0], num_examples)
            prob = pred_np[_np.arange(num_examples, dtype=_np.int64),
                           _np.int64(label_np)]
            nll = (-_np.log(prob + self.eps)).sum()
            self.sum_metric += nll
            self.global_sum_metric += nll
            self.num_inst += num_examples
            self.global_num_inst += num_examples


@register
@alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    """reference: metric.py (PearsonCorrelation)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            label_np = _to_numpy(label).ravel()
            pred_np = _to_numpy(pred).ravel()
            pearson_corr = _np.corrcoef(pred_np, label_np)[0, 1]
            self.sum_metric += pearson_corr
            self.global_sum_metric += pearson_corr
            self.num_inst += 1
            self.global_num_inst += 1


@register
class Loss(EvalMetric):
    """Average of the loss values. reference: metric.py (Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, _, preds):
        if isinstance(preds, nd.NDArray):
            preds = [preds]
        for pred in preds:
            loss = _to_numpy(pred).sum()
            self.sum_metric += loss
            self.global_sum_metric += loss
            n = 1
            for d in pred.shape:
                n *= d
            self.num_inst += n
            self.global_num_inst += n


@register
class Torch(Loss):
    """reference: metric.py (Torch) — kept for name compat."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """reference: metric.py (Caffe) — kept for name compat."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Wrap a feval function. reference: metric.py (CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            reval = self._feval(label_np, pred_np)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.global_sum_metric += sum_metric
                self.num_inst += num_inst
                self.global_num_inst += num_inst
            else:
                self.sum_metric += reval
                self.global_sum_metric += reval
                self.num_inst += 1
                self.global_num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create a CustomMetric from a numpy function.
    reference: metric.py (np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation (R_k / generalized MCC) over an
    incrementally-grown confusion matrix. reference: metric.py (PCC).
    Degenerates to MCC for binary problems."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        self.k = 2
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _grow(self, inc):
        self.lcm = _np.pad(self.lcm, ((0, inc), (0, inc)), "constant")
        self.gcm = _np.pad(self.gcm, ((0, inc), (0, inc)), "constant")
        self.k += inc

    @staticmethod
    def _calc_mcc(cmat):
        n = cmat.sum()
        x = cmat.sum(axis=1)   # true-class totals
        y = cmat.sum(axis=0)   # predicted-class totals
        cov_xx = _np.sum(x * (n - x))
        cov_yy = _np.sum(y * (n - y))
        if cov_xx == 0 or cov_yy == 0:
            return float("nan")
        i = cmat.diagonal()
        cov_xy = _np.sum(i * n - x * y)
        return cov_xy / (cov_xx * cov_yy) ** 0.5

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label).ravel().astype(_np.int64)
            pred_np = _to_numpy(pred)
            if pred_np.ndim > 1 and pred_np.shape != label_np.shape:
                pred_np = pred_np.argmax(axis=-1)
            pred_np = pred_np.ravel().astype(_np.int64)
            n = max(pred_np.max(), label_np.max()) + 1
            if n > self.k:
                self._grow(n - self.k)
            bcm = _np.zeros((self.k, self.k))
            for i, j in zip(pred_np, label_np):
                bcm[i, j] += 1
            self.lcm += bcm
            self.gcm += bcm
        self.num_inst += 1
        self.global_num_inst += 1

    @property
    def sum_metric(self):
        return self._calc_mcc(self.lcm) * self.num_inst

    @property
    def global_sum_metric(self):
        return self._calc_mcc(self.gcm) * self.global_num_inst

    @sum_metric.setter
    def sum_metric(self, _):
        pass

    @global_sum_metric.setter
    def global_sum_metric(self, _):
        pass

    def reset_local(self):
        self.num_inst = 0.0
        self.lcm = _np.zeros((self.k, self.k))

    def reset(self):
        self.num_inst = 0.0
        self.global_num_inst = 0.0
        self.gcm = _np.zeros((self.k, self.k))
        self.lcm = _np.zeros((self.k, self.k))
