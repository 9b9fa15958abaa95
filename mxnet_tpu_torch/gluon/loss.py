"""Loss blocks (the port of the part of `mxnet_tpu.gluon.loss` that the
training path and its tests use): `Loss`, `L2Loss`, `L1Loss` and
`SoftmaxCrossEntropyLoss`, with the reference's weighting
(`_apply_weighting`), batch-axis averaging (`_batch_mean`) and
`sample_weight` broadcast. Each returns one loss per sample; the other loss
blocks of the reference come with later slices.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        assert isinstance(weight, (float, int)), "weight must be a number"
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


def _batch_mean(F, loss, batch_axis):
    """The mean over every axis but the batch axis."""
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    return F.mean(loss, axis=axes) if axes else loss


class Loss(HybridBlock):
    """Base of the loss blocks."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        s = "{name}(batch_axis={_batch_axis}, w={_weight})"
        return s.format(name=self.__class__.__name__, **self.__dict__)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """0.5 * (pred - label)^2 per element, averaged per sample."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class L1Loss(Loss):
    """|pred - label| per element, averaged per sample."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] per sample (sparse labels), or
    -sum(log softmax(pred) * label) for dense ones."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
