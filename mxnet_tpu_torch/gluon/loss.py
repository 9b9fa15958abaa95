"""Loss blocks (the port of `mxnet_tpu.gluon.loss`): all fourteen of the
reference's, with its weighting (`_apply_weighting`), batch-axis averaging
(`_batch_mean`) and `sample_weight` broadcast. Each returns one loss per
sample (`PoissonNLLLoss` their mean, as in the reference).

`CTCLoss` runs ``torch.nn.functional.ctc_loss`` (the op ``ctc_loss``) with
the blank as the last class, where the reference calls ``optax.ctc_loss``
with ``blank_id = C - 1``.
"""
from __future__ import annotations

import numpy as _np

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


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


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of a logit (the stable form max(x, 0) - x z +
    log(1 + exp(-|x|))) or of a probability (`from_sigmoid`), with an
    optional `pos_weight` on the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(F.abs(pred) * -1, act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * (
                    F.Activation(F.abs(pred) * -1, act_type="softrelu") +
                    F.relu(pred * -1))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label +
                         F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight) +
                         F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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


class KLDivLoss(Loss):
    """label * (log(label) - pred), pred a log-probability (or logits,
    without `from_logits`)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification: the negative log-likelihood
    of each label sequence, the blank the last of the C classes. `pred`
    is NTC or TNC (logits), labels NT or TN, padded with -1 unless
    `label_lengths` is given; `pred_lengths` cuts each sequence's frames."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        assert layout in ["NTC", "TNC"], \
            "Only 'NTC' and 'TNC' layouts for pred are supported, " \
            "got: %s" % layout
        assert label_layout in ["NT", "TN"], \
            "Only 'NT' and 'TN' layouts for label are supported, " \
            "got: %s" % label_layout
        self._layout = layout
        self._label_layout = label_layout
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        loss = F.ctc_loss(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smooth L1: |d| - rho / 2 beyond rho, d^2 / (2 rho) within it."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class HingeLoss(Loss):
    """max(0, margin - pred * label), labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred * label)^2."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class LogisticLoss(Loss):
    """log(1 + exp(-pred * label)) for signed labels (or binary ones)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError(
                "label_format can only be signed or binary, recieved %s."
                % label_format)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(F.abs(pred) * -1, act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class TripletLoss(Loss):
    """max(0, |pos - pred|^2 - |neg - pred|^2 + margin) per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=tuple(i for i in range(pred.ndim)
                                if i != self._batch_axis))
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """exp(pred) - target * pred (of a log-rate; pred - target * log(pred)
    of a rate), with Stirling's term for `compute_full`; the mean over
    every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(F, target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling_factor = target * F.log(target + 1e-12) - target + \
                0.5 * F.log(2 * target * _np.pi + 1e-12)
            stirling_factor = stirling_factor * (target > 1).astype(
                pred.dtype)
            loss = loss + stirling_factor
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    """1 - cos(a, b) for label 1, max(0, cos(a, b) - margin) otherwise."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(F, input1, input2)
        cos_sim = self._cosine_similarity(F, input1, input2)
        label = label.reshape((-1, 1))
        loss = F.where(F.broadcast_equal(label, 1), 1 - cos_sim,
                       F.relu(cos_sim - self._margin))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)

    def _cosine_similarity(self, F, x, y, axis=-1):
        x_norm = F.norm(x, axis=axis).reshape((-1, 1))
        y_norm = F.norm(y, axis=axis).reshape((-1, 1))
        x_dot_y = F.sum(x * y, axis=axis).reshape((-1, 1))
        eps_arr = 1e-12
        return x_dot_y / F.broadcast_maximum(
            x_norm * y_norm, F.ones_like(x_norm) * eps_arr)


class SDMLLoss(Loss):
    """Smoothed deep metric learning over paired batches: row i of x1 and
    of x2 are a positive pair, every other row an in-batch negative; the
    cross-entropy of the softmax over negative squared distances against
    targets of 1 - eps on the pair and eps spread over the rest."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing_parameter = smoothing_parameter

    @staticmethod
    def _pairwise_dist(F, x1, x2):
        a2 = F.sum(x1 * x1, axis=1).reshape((-1, 1))
        b2 = F.sum(x2 * x2, axis=1).reshape((1, -1))
        ab = F.dot(x1, x2.T)
        return F.relu(a2 - 2 * ab + b2)

    def hybrid_forward(self, F, x1, x2, sample_weight=None):
        n = x1.shape[0]
        dist = self._pairwise_dist(F, x1, x2)
        logp = F.log_softmax(-dist, axis=1)
        eps = self._smoothing_parameter
        eye = F.one_hot(F.arange(0, n, ctx=x1.context), n)
        labels = eye * (1 - eps) + (1 - eye) * (eps / max(n - 1, 1))
        loss = -F.sum(labels * logp, axis=1)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)
